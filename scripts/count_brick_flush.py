"""Count the reductions of the 3D backward scatters at BASELINE config 5,
and the 32-byte L2 sectors and 128-byte lines they reach, for each
design of fused3b_bwd (and, with --fused3s, of fused3s_bwd).

    PYTHONPATH=. python scripts/count_brick_flush.py [--device cuda]
    PYTHONPATH=. python scripts/count_brick_flush.py --fused3s [--points Q]
    PYTHONPATH=. python scripts/count_brick_flush.py --blend [--cell-dim 16]
    PYTHONPATH=. python scripts/count_brick_flush.py --blend --fused3s \
        [--points Q]

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
(query, cell) adding 16-byte records to a texel-major scratch.  With
--blend it counts the blend's loads instead (fused3b_blend, or
fused3s_blend with --fused3s): the sectors each candidate layout of
csrc/texel_gather.cuh reads (BLEND_LAYOUTS: a thread a query, 2 and 4
lanes a query, the channel splits at C = 16) and, for fused3s, the
planar reads of the design before and the stores of the rows in query
order.  Integer counts, no timing: the device only makes it quick.
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


# the blends' load layouts (csrc/texel_gather.cuh): name -> (width,
# groups, cell lanes, grid passes) at C = 4 and C = 16; the design before
# the shared gather body is "a thread a query" (fused3b's, over the
# texel-major volume; fused3s's read the planar cells, counted apart)
BLEND_LAYOUTS = {
    4: {"a thread a query": (4, 1, 1, 1),
        "2 lanes a query (cells 2j, 2j + 1)": (4, 1, 2, 1),
        "4 lanes a query (cells 4j .. 4j + 3)": (4, 1, 4, 1)},
    16: {"a thread a query, 8 channels a grid pass": (8, 1, 1, 2),
         "2 lanes a query, quads interleaved (8 channels a lane)":
             (8, 2, 1, 1),
         "4 lanes a query, a quad a lane": (4, 4, 1, 1),
         "2 cell lanes, 8 channels a grid pass": (8, 1, 2, 2)},
}


def _gather_sectors(tex, ok, qkey, n, c, layout):
    """(load instructions, sectors) of a float4 gather from the
    texel-major volume for one chunk of queries: ``qkey`` (Q,) numbers the
    groups of queries that share a warp instruction, ``layout`` is
    (width, groups, cell lanes, grid passes): lane (g, m) of a query reads
    quads g, g + groups, ... of the pass's channels of cells m, m + cell
    lanes, ... at each corner."""
    width, groups, cell_lanes, passes = layout
    loads = width // 4
    iters = -(-n // cell_lanes)
    dev = tex.device
    cells = torch.arange(n, device=dev)[:, None, None]
    corner = torch.arange(8, device=dev)[None, :, None]
    keys, instrs = [], 0
    for y in range(passes):
        for kk in range(loads):
            instr = ((((qkey[None, None, :] * passes + y) * iters
                       + cells // cell_lanes) * 8 + corner) * loads + kk)
            for g in range(groups):
                quad = y * groups * loads + g + kk * groups
                if 4 * quad >= c:
                    continue
                addr = ((tex * n + cells) * c + 4 * quad) * 4
                keys.append(torch.stack([instr.expand_as(tex)[ok],
                                         addr[ok] // SECTOR]))
            instrs += torch.unique(instr.expand_as(tex)[ok]).numel()
    both = torch.cat(keys, dim=1)
    span = int(both[1].max()) + 1
    return instrs, torch.unique(both[0] * span + both[1]).numel()


def count_blend_fused3b(args, cfg, pts):
    """fused3b_blend's loads at each of BLEND_LAYOUTS[C]: the queries of a
    warp instruction are 32 consecutive slots of a plan block (pad slots
    idle) for a thread a query, 32 // lanes compacted real slots
    otherwise."""
    n, s, c = args.n_cells, args.cell_size, args.cell_dim
    plan = trim_plan(make_plan(pts, (s, s, s), cfg))
    slots = plan[0][torch.argsort(plan[0])]
    real = plan[5][slots]
    block = slots // Q_BLOCK
    rank = slots - block * Q_BLOCK
    zslab = plan[2].to(torch.int64)[block]
    totals = {name: [0, 0] for name in BLEND_LAYOUTS[c]}
    bounds = torch.nonzero(torch.diff(zslab, prepend=zslab[:1] - 1)).flatten()
    starts = bounds[::8].tolist() + [slots.numel()]
    loads = 0
    for lo, hi in zip(starts[:-1], starts[1:]):
        tex, ok = _corners(real[lo:hi], n, s, cfg)
        loads += int(ok.sum())
        for name, lay in BLEND_LAYOUTS[c].items():
            lanes = lay[1] * lay[2]
            qkey = (slots[lo:hi] // 32 if name.startswith("a thread")
                    else block[lo:hi] * Q_BLOCK + rank[lo:hi] // (32 // lanes))
            ins, sec = _gather_sectors(tex, ok, qkey, n, c, lay)
            totals[name][0] += ins
            totals[name][1] += sec
    print(f"fused3b_blend, {n} x {c} x {s}^3, Q={pts.shape[0]}, "
          f"QP={plan[1].shape[0]}: {loads} (query, cell, in-bounds corner) "
          f"records of {4 * c} bytes:", flush=True)
    for name, (ins, sec) in totals.items():
        print(f"  {name}: {sec} sectors ({sec / loads:.3f} a record), "
              f"{ins} warp load instructions", flush=True)


def count_blend_fused3s(args, cfg, pts):
    """fused3s_blend's loads and stores at --points uniform points in its z
    sort: a thread a query reading the planar (N, C, D, H, W) cells (the
    design before), and each of BLEND_LAYOUTS[C] over the texel-major
    copy; the stores of a thread a query into (7, C, Q) in query order
    against a query's rows into (Q, 7, C)."""
    n, s, c = args.n_cells, args.cell_size, args.cell_dim
    perm, table = fused3s.zsort(pts, s, cfg)
    table = table.to(torch.int64)
    live = table[:, 2] > 0
    first, count = table[live, 1], table[live, 2]
    blocks = torch.arange(first.numel(), device=pts.device)
    block = torch.repeat_interleave(blocks, count)
    rank = torch.arange(perm.numel(), device=pts.device) - first[block]
    qi = perm.long()
    sorted_pts = pts[qi]
    totals = {name: [0, 0] for name in BLEND_LAYOUTS[c]}
    planar = loads = 0
    chunk = 512
    for b0 in range(0, first.numel(), chunk):
        sel = (block >= b0) & (block < b0 + chunk)
        tex, ok = _corners(sorted_pts[sel], n, s, cfg)
        b, r = block[sel], rank[sel]
        loads += int(ok.sum())
        cells = torch.arange(n, device=tex.device)[:, None, None]
        warp = b * Q_BLOCK + r // 32
        for ch in range(c):
            instr = ((warp[None, None, :] * n + cells) * 8
                     + torch.arange(8, device=tex.device)[None, :, None])
            addr = ((cells * c + ch) * s ** 3 + tex) * 4
            planar += _distinct(instr.expand_as(tex), addr, ok)[0]
        for name, lay in BLEND_LAYOUTS[c].items():
            lanes = lay[1] * lay[2]
            ins, sec = _gather_sectors(tex, ok, b * Q_BLOCK + r // (32 // lanes),
                                       n, c, lay)
            totals[name][0] += ins
            totals[name][1] += sec
    q = pts.shape[0]
    # stores: a warp of 32 sorted queries writes one (row, channel) of each
    # at its query's column (8 floats a sector, the rows taken as
    # aligned); a query's (Q, 7, C) rows are 7 C contiguous floats
    warp = block * Q_BLOCK + rank // 32
    key = warp * (q // 8 + 1) + qi // 8
    per_row = torch.unique(key).numel()
    print(f"fused3s_blend, {n} x {c} x {s}^3, Q={q}: {loads} (query, cell, "
          f"in-bounds corner) records; a thread a query, planar: "
          f"{planar} sectors for {loads * c} 4-byte loads "
          f"({planar / loads:.3f} a record)", flush=True)
    for name, (ins, sec) in totals.items():
        print(f"  texel-major, {name}: {sec} sectors ({sec / loads:.3f} a "
              f"record), {ins} warp load instructions", flush=True)
    start = qi * (7 * c * 4)
    rows = int(((start + 7 * c * 4 - 1) // SECTOR - start // SECTOR
                + 1).sum())
    print(f"  stores: (7, C, Q) in query order {7 * c * per_row} sectors "
          f"({7 * c * per_row / q:.1f} a query); (Q, 7, C) rows {rows} "
          f"sectors ({rows / q:.1f} a query), then a tiled transpose",
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
    ap.add_argument("--blend", action="store_true",
                    help="count the blend's loads (fused3b_blend, or "
                         "fused3s_blend with --fused3s) instead")
    ap.add_argument("--cell-dim", type=int, default=CHANNELS,
                    choices=sorted(BLEND_LAYOUTS),
                    help="channels of --blend")
    args = ap.parse_args(argv)
    cfg = SamplerConfig(dim=3)
    if args.fused3s:
        gen = torch.Generator(device=args.device).manual_seed(0)
        pts = torch.rand((args.points, 3), generator=gen,
                         device=args.device) * 2 - 1
        (count_blend_fused3s if args.blend else count_fused3s)(args, cfg,
                                                               pts)
        return 0
    with PointGenerator(args.points, 3, seed=0) as gen:
        pts = torch.from_numpy(gen.batch(0)).to(args.device)
    (count_blend_fused3b if args.blend else count_fused3b)(args, cfg, pts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
