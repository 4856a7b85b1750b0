"""PyTorch port, the host side of the shared 3D backward scatter
(csrc/texel_scatter.cuh) of fused3b_bwd and fused3s_bwd: the launch
layouts of ``ops/cuda/scatter.py`` at every shape chip_smoke.py runs, the
ctypes declarations of the two C entry points, and the scatter's lane
walk into the texel-major layout, mirrored here in f64, against the plain
versions.

The kernels themselves run on the card only (chip_smoke.py holds them to
their plain versions there).  ``_lane_units`` mirrors the kernel's index
math: the compaction of a block's valid slots, the warps' turns over the
queries, each lane's (cell, channel group) units.
"""

import ctypes
import itertools
import re
import types

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import multicell_offsets
from cosinesampler_tpu_torch.ops.cuda import build, fused3b, fused3s, scatter
from cosinesampler_tpu_torch.ops.cuda.fused2w import (all_orders,
                                                      plain_fused_bwd)
from cosinesampler_tpu_torch.ops.generic import (corner_index_weight,
                                                 per_axis_tables)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64

# (N, C) of chip_smoke.py's fused3b_bwd and fused3s_bwd calls: config 5
# and the scatter sweep's channel counts, the variants and channel
# counts, the wide volume and its variants, the 3D sweep's stacks, and
# the scatter cases (N in {1, 3, 6, 50} x C in {1, 3, 8, 16})
SHAPES = sorted({
    (16, 4), (16, 8), (16, 12), (16, 16), (6, 1), (6, 3), (6, 4), (6, 8),
    (6, 9), (6, 12), (6, 16), (2, 2), (5, 3), (50, 4), (8, 4), (16, 2),
    (16, 3), (4, 4), *itertools.product((1, 3, 6, 50), (1, 3, 8, 16))})


def _lane_units(geom, n, c, count, by):
    """(query, cell, group) of every unit the lanes of the blocks in grid
    row ``by`` take for ``count`` valid queries, as
    texel_scatter.cuh's scatter_block walks them."""
    qpw = 32 // geom.lanes
    nwarps = geom.threads // 32
    units = n * geom.lane_groups
    loops = geom.block_groups // geom.lane_groups
    groups = geom.groups(c)
    grp0 = by * geom.block_groups
    out = []
    for warp, lane in itertools.product(range(nwarps), range(32)):
        qo, u0 = divmod(lane, geom.lanes)
        if qo >= qpw:
            continue
        for j in range(warp * qpw + qo, count, nwarps * qpw):
            for u in range(u0, units, geom.lanes):
                ni, gs = divmod(u, geom.lane_groups)
                for k in range(loops):
                    grp = grp0 + gs + k * geom.lane_groups
                    if grp >= groups:
                        break
                    out.append((j, ni, grp))
    return out


def _check_layout(geom, n, c):
    assert 1 <= geom.width <= 8 and 1 <= geom.lanes <= 32
    assert geom.block_groups % geom.lane_groups == 0
    assert geom.threads % 32 == 0
    assert scatter.QUERIES <= geom.threads <= 256
    assert geom.smem_bytes(c) <= build.BLOCK_SMEM_BYTES
    groups = geom.groups(c)
    assert (groups - 1) * geom.width < c <= groups * geom.width
    for count in (scatter.QUERIES, 37, 1):
        hits = np.zeros((count, n, groups), dtype=np.int64)
        for by in range(geom.grid_y(c)):
            for j, ni, grp in _lane_units(geom, n, c, count, by):
                hits[j, ni, grp] += 1
        assert (hits == 1).all(), (geom, n, c, count)


def test_scatter_layouts_cover_every_pair_once():
    """scatter_geometry and every alternative the sweep times (for
    fused3b's blocks and fused3s's dense ones), at every (N, C)
    chip_smoke.py runs: each (query, cell, channel group) of a
    full, a ragged and a one-query block in exactly one lane, at most 32
    lanes a query, shared memory within a block's BLOCK_SMEM_BYTES."""
    for n, c in SHAPES:
        for dense in (False, True):
            for geom in scatter.scatter_alternatives(n, c, dense).values():
                _check_layout(geom, n, c)


def test_scatter_geometry_rule():
    """The rule: a warp's lanes over a query's cells (2 queries x 16 cells
    at config 5), 32 // N queries a warp below 32 cells and lanes looping
    over cells above; at C a multiple of 4 groups of 4 channels, all of a
    block's over a query's lanes (C = 16: 16 cells x 4 groups, two units
    a lane), half a warp a query where that idles fewer lanes (48 units);
    scalar channels in groups of at most 8; the channels beyond 16 a
    block on the grid; 256 threads a block where the blocks are dense
    (fused3s's) or shared memory leaves fewer than FULL_BLOCKS_PER_SM
    blocks an SM."""
    geom = scatter.ScatterGeometry
    assert scatter.scatter_geometry(16, 4) == geom(4, 1, 1, 16, 128)
    assert scatter.scatter_geometry(1, 4).lanes == 1
    assert scatter.scatter_geometry(3, 3) == geom(3, 1, 1, 3, 128)
    assert scatter.scatter_geometry(50, 4).lanes == 32
    assert scatter.scatter_geometry(6, 12) == geom(4, 3, 3, 18, 256)
    assert scatter.scatter_geometry(16, 12) == geom(4, 3, 3, 16, 256)
    wide = scatter.scatter_geometry(16, 16)
    assert wide == geom(4, 4, 4, 32, 256)
    assert wide.grid_y(16) == 1 and wide.smem_bytes(16) == 58_880
    assert scatter.scatter_geometry(16, 64).grid_y(64) == 4
    assert scatter.scatter_geometry(6, 9) == geom(5, 2, 2, 12, 256)
    assert scatter.scatter_geometry(6, 7) == geom(7, 1, 1, 6, 128)
    # C = 4: 16 KB a block, 13 an SM; C = 8: 30 KB, 7 an SM; fused3s's
    # dense blocks
    assert scatter.scatter_geometry(16, 8) == geom(4, 2, 2, 32, 256)
    assert scatter.scatter_geometry(16, 4, dense=True) == geom(
        4, 1, 1, 16, 256)


class _Lib:
    """Stands in for the loaded library: each entry point a namespace that
    build._declare sets argtypes on."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_ctypes_declarations_match_the_c_entry_points():
    """build._declare gives fused3b_bwd and fused3s_bwd (and their blends)
    the pointer, int and float arguments of their C signatures, in order:
    a miscount would pass garbage on the card, which no CPU run shows."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for src, entry in (("fused3b.cu", "fused3b_bwd"),
                       ("fused3b.cu", "fused3b_blend"),
                       ("fused3s.cu", "fused3s_bwd"),
                       ("fused3s.cu", "fused3s_blend")):
        text = (build.CSRC / src).read_text()
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry


def _scatter_f64(g, pts, spatial, cfg, n, geom, blocks):
    """The texel-major (D, H, W, N, C) cotangent the kernel adds for the
    query columns of each block in ``blocks`` (compacted, in order), in
    f64 through the plain corner tables, at the kernel's addresses
    ((texel * N + cell) * C + channel)."""
    c = g.shape[1]
    d, h, w = spatial
    qi, ni, grp = [], [], []
    for cols in blocks:
        for by in range(geom.grid_y(c)):
            for j, cell, gr in _lane_units(geom, n, c, len(cols), by):
                qi.append(cols[j])
                ni.append(cell)
                grp.append(gr)
    qi, ni, grp = (torch.tensor(v, dtype=torch.int64) for v in (qi, ni, grp))
    offs = multicell_offsets(n, cfg.multicell, F64, "cpu")[ni]
    texels = d * h * w
    acc = torch.zeros((texels * n * c,), dtype=F64)
    chans = torch.arange(geom.width)
    ch = grp[:, None] * geom.width + chans[None, :]
    live = ch < c
    for row, o in enumerate(all_orders(3)):
        tables = per_axis_tables(pts[qi], spatial, cfg, o, n, offset=offs)
        gq = g[row][ch.clamp(max=c - 1), qi[:, None]]
        for corner in itertools.product((0, 1), repeat=3):
            idx, wgt, ok = corner_index_weight(tables, corner, spatial, 3)
            keep = ok[:, None] & live
            texel = idx.clamp(0, texels - 1)[:, None]
            dst = (texel * n + ni[:, None]) * c + ch
            acc.index_add_(0, dst[keep], (wgt[:, None] * gq)[keep])
    return acc.reshape(d, h, w, n, c)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_fused3s_scratch_route_matches_plain_fused_bwd_f64(padding):
    """fused3s_bwd's scratch route: zsort's blocks, the lanes over (query,
    cell) adding into the texel-major scratch, fused3b.vol_to_cells back
    to (N, C, D, H, W), against plain_fused_bwd in f64, at N = 6 (not a
    divisor of 32) and C = 12 (three groups of 4 over the lanes) and 9
    (groups of 5 and 4), and at 5 x 3 x 6^3 also with a lane a query and
    with 128 threads (4 warps) a block."""
    cfg = TConfig(dim=3, padding_mode=padding)
    rng = np.random.RandomState(3)
    for n, c, spatial, q, names in (
            (6, 12, (5, 6, 7), 300, ("rule",)),
            (6, 9, (5, 6, 7), 150, ("rule",)),
            (5, 3, (6, 6, 6), 200, ("rule", "lanes over queries",
                                    "128 threads"))):
        pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, 3)))
        g = torch.from_numpy(rng.standard_normal((7, c, q)))
        perm, table = fused3s.zsort(pts, spatial[0], cfg, q_block=128)
        blocks = [perm[f:f + k].tolist() for _, f, k in table.tolist() if k]
        want = plain_fused_bwd(g, pts, spatial, cfg, n)
        alts = scatter.scatter_alternatives(n, c, dense=True)
        for name in names:
            got = fused3b.vol_to_cells(_scatter_f64(g, pts, spatial, cfg, n,
                                                    alts[name], blocks))
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_fused3b_scatter_compacts_real_slots_f64():
    """fused3b_bwd's blocks: each plan block's real slots (occ != 0)
    compacted in order, pad slots skipped, the lanes' texel-major adds in
    f64 against plain_fused3b_bwd_vol, at config 5's layout (N = 16,
    C = 4: 2 queries x 16 cells a warp) on 8^3 cells, reflection
    padding."""
    cfg = TConfig(dim=3, padding_mode="reflection")
    n, c, spatial, q = 16, 4, (8, 8, 8), 700
    rng = np.random.RandomState(5)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (q, 3)))
    plan = tfused.make_vol_plan(pts, (n, c, *spatial), cfg)
    occ = plan[1]
    g_p = torch.from_numpy(rng.standard_normal((7, c, occ.shape[0])))
    blocks = [[s for s in range(b, b + fused3b.Q_BLOCK) if occ[s] != 0]
              for b in range(0, occ.shape[0], fused3b.Q_BLOCK)]
    assert any(0 < len(b) < fused3b.Q_BLOCK for b in blocks)
    got = _scatter_f64(g_p, plan[5], spatial, cfg, n,
                       scatter.scatter_geometry(n, c), blocks)
    want = fused3b.plain_fused3b_bwd_vol(g_p, plan, spatial, cfg, n)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
