"""Count the global atomics of fused3b_bwd's design against a brick
accumulator's, at BASELINE config 5 on one CUDA card.

    PYTHONPATH=. python scripts/count_brick_flush.py [--device cuda]

fused3b_bwd adds each (real query, cell, in-bounds corner) contribution to
the volume with one vector atomic.  A kernel that first accumulated a
plan block's contributions in shared memory would flush one atomic per
distinct (cell, texel) the block touches; one that accumulated every block
of a z slab would flush one per distinct (cell, texel) of the slab.  This
script builds the plan of 1 000 000 points over 16 x 4 x 128^3 (the
trainer's points for seed 0), walks the corners exactly as the sampler
does (ops/coords.py source coordinates, the per-cell multicell shifts),
and prints the three counts.  Integer counts, no timing: the device only
makes it quick.
"""

from __future__ import annotations

import argparse

import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig
from cosinesampler_tpu_torch.ops.coords import (compute_source_coords,
                                                multicell_offsets)
from cosinesampler_tpu_torch.ops.cuda.fused3b import Q_BLOCK, make_plan
from cosinesampler_tpu_torch.ops.fused import trim_plan
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-cells", type=int, default=16)
    ap.add_argument("--cell-size", type=int, default=128)
    ap.add_argument("--points", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    cfg = SamplerConfig(dim=3)
    n, s, q = args.n_cells, args.cell_size, args.points
    with PointGenerator(q, 3, seed=0) as gen:
        pts = torch.from_numpy(gen.batch(0)).to(args.device)
    plan = trim_plan(make_plan(pts, (s, s, s), cfg))
    positions, pts_p = plan[0], plan[5]
    real = pts_p[positions]                      # queries in slot order
    block = positions // Q_BLOCK
    zslab = plan[2].to(torch.int64)[block]
    offsets = multicell_offsets(n, cfg.multicell, torch.float32, args.device)
    direct = per_block = per_slab = 0
    for ni in range(n):
        floors, oks = [], []
        for ax in range(3):
            x, _ = compute_source_coords(real[:, ax], s, cfg.padding_mode,
                                         cfg.align_corners, cfg.multicell,
                                         offsets[ni])
            floors.append(torch.floor(x).to(torch.int64))
        keys = []
        for k in range(8):
            c = [floors[ax] + ((k >> ax) & 1) for ax in range(3)]
            ok = torch.ones_like(c[0], dtype=torch.bool)
            for ax in range(3):
                ok &= (c[ax] >= 0) & (c[ax] < s)
            texel = (c[2] * s + c[1]) * s + c[0]
            keys.append(torch.where(ok, texel, -1))
            oks.append(ok)
        texels = torch.stack(keys)                # (8, Q)
        valid = torch.stack(oks)
        direct += int(valid.sum())
        span = s ** 3
        per_block += torch.unique((block[None] * span + texels)[valid]).numel()
        per_slab += torch.unique((zslab[None] * span + texels)[valid]).numel()
    print(f"config {n} x 4 x {s}^3, Q={q}, QP={plan[1].shape[0]}, "
          f"{int(plan[4].sum())} blocks with queries: per cell channel "
          f"group, direct atomics {direct}, a per-block shared-memory "
          f"accumulator's flush {per_block} ({per_block / direct:.1%}), a "
          f"per-z-slab accumulator's {per_slab} ({per_slab / direct:.1%}); "
          f"{direct / (n * span):.3f} contributions per (cell, texel)",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
