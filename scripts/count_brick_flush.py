"""Count the reductions of the 3D backward scatters at BASELINE config 5,
and the 32-byte L2 sectors and 128-byte lines they reach, for each
design of fused3b_bwd (and, with --fused3s, of fused3s_bwd).

    PYTHONPATH=. python scripts/count_brick_flush.py [--device cuda]
    PYTHONPATH=. python scripts/count_brick_flush.py --fused3s [--points Q]

fused3b_bwd adds each (real query, cell, in-bounds corner) contribution
to the (D, H, W, N, C) volume with one 16-byte vector reduction at C = 4.
A warp instruction's reductions reach L2 as the distinct sectors (and
lines) its lanes' 16-byte records fall in, so the designs differ in
which records share an instruction:

* a thread a slot over its cells (the design before lanes over cells):
  an instruction is 32 consecutive slots of a plan block, one cell, one
  corner;
* lanes over (query, cell) (csrc/texel_scatter.cuh): an instruction is
  32 // N queries (the block's real slots compacted, in order) times the
  N cells, one corner;
* a shared-memory accumulator of a plan block's window, flushed by the
  lines it touched: one flush of each distinct line (sector) a block
  touches;
* a per-z-slab accumulator: the distinct (cell, texel) records of each z
  slab (the count that dismissed the accumulator before).

This script builds the plan of the trainer's 1 000 000 points (seed 0)
over 16 x 4 x 128^3, walks the corners exactly as the sampler does
(ops/coords.py source coordinates, the per-cell multicell shifts) and
prints the counts.  With --fused3s it takes --points uniform points
(seed 0) in fused3s's z sort (ops/cuda/fused3s.py zsort) instead, and
counts a thread a query adding 4-byte scalars to the planar
(N, C, D, H, W) cotangent (the design before) against lanes over
(query, cell) adding 16-byte records to a texel-major scratch.  Integer
counts, no timing: the device only makes it quick.
"""

from __future__ import annotations

import argparse

import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig
from cosinesampler_tpu_torch.ops.coords import (compute_source_coords,
                                                multicell_offsets)
from cosinesampler_tpu_torch.ops.cuda import fused3s
from cosinesampler_tpu_torch.ops.cuda.fused3b import Q_BLOCK, make_plan
from cosinesampler_tpu_torch.ops.fused import trim_plan
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

SECTOR, LINE, RECORD = 32, 128, 16   # bytes; RECORD: a float4 reduction
CHANNELS = 4                         # config 5's C: one record a texel


def _corners(pts, n, s, cfg):
    """(texel (n, 8, Q) int64, in bounds (n, 8, Q) bool) of every corner
    of each query in each cell, -1 where out of bounds."""
    offsets = multicell_offsets(n, cfg.multicell, torch.float32, pts.device)
    texels, oks = [], []
    for ni in range(n):
        floors = []
        for ax in range(3):
            x, _ = compute_source_coords(pts[:, ax], s, cfg.padding_mode,
                                         cfg.align_corners, cfg.multicell,
                                         offsets[ni])
            floors.append(torch.floor(x).to(torch.int64))
        for k in range(8):
            c = [floors[ax] + ((k >> ax) & 1) for ax in range(3)]
            ok = torch.ones_like(c[0], dtype=torch.bool)
            for ax in range(3):
                ok &= (c[ax] >= 0) & (c[ax] < s)
            texels.append(torch.where(ok, (c[2] * s + c[1]) * s + c[0], -1))
            oks.append(ok)
    return (torch.stack(texels).reshape(n, 8, -1),
            torch.stack(oks).reshape(n, 8, -1))


def _distinct(instr, addr, valid):
    """Distinct (instruction, sector) and (instruction, line) pairs of the
    valid reductions at byte addresses ``addr``."""
    key = instr[valid]
    a = addr[valid]
    out = []
    for unit in (SECTOR, LINE):
        span = int(a.max()) // unit + 1 if a.numel() else 1
        out.append(torch.unique(key * span + a // unit).numel())
    return out


def _lanes_over_cells(tex, ok, block, rank, n):
    """(sectors, lines) of lanes over (query, cell) adding 16-byte records
    to the texel-major layout: the queries of one instruction are the
    32 // n (n <= 32) of a block with the same rank // (32 // n), each
    over its n cells, at one corner."""
    qpw = 32 // n
    group = block * Q_BLOCK + rank // qpw           # an instruction's queries
    instr = (group[None, None, :] * 8
             + torch.arange(8, device=tex.device)[None, :, None])
    cells = torch.arange(n, device=tex.device)[:, None, None]
    return _distinct(instr.expand_as(tex), (tex * n + cells) * RECORD, ok)


def count_fused3b(args, cfg, pts):
    n, s = args.n_cells, args.cell_size
    plan = trim_plan(make_plan(pts, (s, s, s), cfg))
    positions = plan[0]
    order = torch.argsort(positions)
    slots = positions[order]                        # real slots, in order
    real = plan[5][slots]
    block = slots // Q_BLOCK
    # rank of each real slot among its block's real slots (a prefix)
    rank = slots - block * Q_BLOCK
    zslab = plan[2].to(torch.int64)[block]
    totals = dict(red=0, a_sec=0, a_line=0, b_sec=0, b_line=0, c_sec=0,
                  c_line=0, slab=0)
    span = s ** 3
    # chunks of 8 whole z slabs (a slab's blocks are consecutive), so that
    # every count is exact within a chunk
    bounds = torch.nonzero(torch.diff(zslab, prepend=zslab[:1] - 1)).flatten()
    starts = bounds[::8].tolist() + [slots.numel()]
    for lo, hi in zip(starts[:-1], starts[1:]):
        tex, ok = _corners(real[lo:hi], n, s, cfg)
        b, r = block[lo:hi], rank[lo:hi]
        cells = torch.arange(n, device=tex.device)[:, None, None]
        rec = tex * n + cells                       # (texel * N + cell)
        addr = rec * RECORD
        # a thread a slot: warp = slot // 32, one cell, one corner
        warp = (b * Q_BLOCK + r) // 32
        instr = (warp[None, None, :] * n + cells) * 8 + torch.arange(
            8, device=tex.device)[None, :, None]
        totals["red"] += int(ok.sum())
        sec, line = _distinct(instr.expand_as(tex), addr, ok)
        totals["a_sec"] += sec
        totals["a_line"] += line
        sec, line = _lanes_over_cells(tex, ok, b, r, n)
        totals["b_sec"] += sec
        totals["b_line"] += line
        sec, line = _distinct(b[None, None, :].expand_as(tex), addr, ok)
        totals["c_sec"] += sec
        totals["c_line"] += line
        totals["slab"] += torch.unique(
            (zslab[lo:hi][None, None, :] * span * n + rec)[ok]).numel()
    red = totals["red"]
    print(f"fused3b_bwd, {n} x {CHANNELS} x {s}^3, Q={pts.shape[0]}, "
          f"QP={plan[1].shape[0]}, {int(plan[4].sum())} blocks with queries;"
          f" {red} 16-byte reductions:", flush=True)
    for name, sec, line in (
            ("a thread a slot over its cells", totals["a_sec"],
             totals["a_line"]),
            ("lanes over (query, cell)", totals["b_sec"], totals["b_line"]),
            ("a block-window accumulator's flush", totals["c_sec"],
             totals["c_line"])):
        print(f"  {name}: {sec} sectors ({sec / red:.3f} a reduction), "
              f"{line} lines", flush=True)
    print(f"  a per-z-slab accumulator's distinct (cell, texel) records: "
          f"{totals['slab']} ({totals['slab'] / red:.1%} of the reductions)",
          flush=True)


def count_fused3s(args, cfg, pts):
    n, s, c = args.n_cells, args.cell_size, CHANNELS
    perm, table = fused3s.zsort(pts, s, cfg)
    table = table.to(torch.int64)
    live = table[:, 2] > 0
    first, count = table[live, 1], table[live, 2]
    blocks = torch.arange(first.numel(), device=pts.device)
    block = torch.repeat_interleave(blocks, count)
    rank = torch.arange(perm.numel(), device=pts.device) - first[block]
    sorted_pts = pts[perm.long()]
    red = planar_sec = planar_line = tm_sec = tm_line = 0
    chunk = 512
    for b0 in range(0, first.numel(), chunk):
        sel = (block >= b0) & (block < b0 + chunk)
        tex, ok = _corners(sorted_pts[sel], n, s, cfg)
        b, r = block[sel], rank[sel]
        cells = torch.arange(n, device=tex.device)[:, None, None]
        # a thread a query: warp of 32 sorted queries of a block, one
        # cell, one corner, one channel; 4-byte planar scalars
        warp = b * Q_BLOCK + r // 32
        for ch in range(c):
            instr = ((warp[None, None, :] * n + cells) * 8
                     + torch.arange(8, device=tex.device)[None, :, None])
            addr = ((cells * c + ch) * s ** 3 + tex) * 4
            sec, line = _distinct(instr.expand_as(tex), addr, ok)
            planar_sec += sec
            planar_line += line
        red += int(ok.sum())
        sec, line = _lanes_over_cells(tex, ok, b, r, n)
        tm_sec += sec
        tm_line += line
    print(f"fused3s_bwd, {n} x {c} x {s}^3, Q={pts.shape[0]}: a thread a "
          f"query, planar: {red * c} 4-byte reductions in {planar_sec} "
          f"sectors ({planar_sec / (red * c):.3f} each), {planar_line} "
          f"lines; lanes over (query, cell), texel-major: {red} 16-byte "
          f"reductions in {tm_sec} sectors ({tm_sec / red:.3f} each), "
          f"{tm_line} lines", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-cells", type=int, default=16)
    ap.add_argument("--cell-size", type=int, default=128)
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--fused3s", action="store_true",
                    help="count fused3s_bwd's designs at --points uniform "
                         "points instead")
    args = ap.parse_args(argv)
    cfg = SamplerConfig(dim=3)
    if args.fused3s:
        gen = torch.Generator(device=args.device).manual_seed(0)
        pts = torch.rand((args.points, 3), generator=gen,
                         device=args.device) * 2 - 1
        count_fused3s(args, cfg, pts)
        return 0
    with PointGenerator(args.points, 3, seed=0) as gen:
        pts = torch.from_numpy(gen.batch(0)).to(args.device)
    count_fused3b(args, cfg, pts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
