"""PyTorch port, the host side of the v1 fused pair (csrc/fused.cu): the
launch layouts of ``ops/cuda/v1.py`` at every shape chip_smoke.py runs the
pair, a Python mirror of the kernels' lane walks in f64 against the plain
versions, the 4-D layout move and the ctypes declarations.  No JAX: the
plain versions are held to the JAX package's interpret-mode kernels in
tests/test_torch_port_fused_v1.py.

The kernels run on the card only (chip_smoke.py holds them to their plain
versions there).  ``_lane_items`` mirrors their index math: the warps'
rounds over a block's queries, each lane's cells and channel units, the
warp shuffles that add a query's cell lanes into its first, and the
addresses each lane reads (the texel-major copy, or the planar cells);
``_scatter_units`` mirrors texel_scatter.cuh's lanes over (query, cell,
channel group).
"""

import ctypes
import itertools
import re
import types

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import multicell_offsets
from cosinesampler_tpu_torch.ops.cuda import (build, fused3b, gather, scatter,
                                              v1)
from cosinesampler_tpu_torch.ops.cuda.fused2w import (all_orders,
                                                      plain_fused_blend,
                                                      plain_fused_bwd)
from cosinesampler_tpu_torch.ops.generic import (corner_index_weight,
                                                 per_axis_tables)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64
QUERIES = 128   # queries of an unstaged gather or scatter block

# (dim, N, C, S, Q) of chip_smoke.py's v1 calls: path (a) and the wide
# trainers, the channel counts, the variants, the large cell, config 5 at
# C = 16, the wide route sweep's stacks and the v1 sweep's (its planar
# sweep's too)
SHAPES = sorted({
    (2, 96, 16, 16, 100_000), (3, 50, 16, 16, 100_000),
    *((2, 8, c, (12, 10), 4099) for c in (9, 12, 32, 64)),
    *((3, 6, c, (7, 8, 9), 4099) for c in (9, 32)),
    (2, 6, 12, (12, 10), 2053), (2, 6, 9, (12, 10), 2053),
    (3, 6, 12, (7, 8, 9), 2053), (3, 6, 9, (7, 8, 9), 2053),
    (3, 2, 16, 32, 4096), (3, 16, 16, 128, 1_000_000),
    (2, 8, 16, 16, 4096), (3, 8, 16, 16, 4096),
    *((2, 96, c, 16, q) for c in (12, 16) for q in (1024, 16384, 100_000)),
    *((3, 50, c, 16, q) for c in (12, 16)
      for q in (1024, 2048, 4096, 8192, 16384, 100_000)),
    *((3, 16, c, 128, q) for c in (12, 16)
      for q in (4096, 8192, 16384, 32768, 100_000)),
    (2, 96, 12, 16, 100_000), (2, 96, 32, 16, 100_000),
    *((3, 16, 16, 128, q) for q in (24576, 49152)),
    *((2, 16, 16, 1024, q) for q in (2048, 4096, 8192, 16384, 32768)),
    *((d, 2, 16, s, q) for d, s in ((3, 32), (2, 128))
      for q in (256, 1024, 4096, 16384, 65536)),
    *((3, 50, 16, 16, q) for q in (256, 1024, 4096, 16384)),
    *((2, 96, 16, 16, q) for q in (256, 1024, 4096, 16384, 65536)),
}, key=str)


def _spatial(dim, s):
    return tuple(s) if isinstance(s, tuple) else (s,) * dim


def _shuffled(items, lanes, groups):
    """Each lane's items after the shuffle tree: for off = lanes / 2 down
    to groups, lane l adds lane l + off's (__shfl_down_sync: a lane past
    31 reads its own value, which only idle lanes use)."""
    held = {lane: list(v) for lane, v in items.items()}
    off = lanes // 2
    while off >= groups:
        held = {lane: held[lane] + (held[lane + off] if lane + off < 32
                                    else held[lane])
                for lane in range(32)}
        off //= 2
    return held


def _lane_items(lay, c, count, cells, by):
    """(query, cell, channel, cell slot, channel slot) rows of every value
    the storing lanes (cell lane 0 of each query) carry after the
    shuffles, for ``count`` queries of one block in channel block ``by``,
    the lanes walking ``cells``: lane g + groups * m of a query takes the
    cells m, m + cell_lanes, ... and the channel units g, g + groups, ...
    (quads where the loads are float4), as texel_gather.cuh's
    gather_block walks them.  The slots are the cell's place in
    ``cells`` and the channel's in the block."""
    lanes = lay.lanes
    qpw = 32 // lanes
    nwarps = lay.threads // 32
    unit = 4 if lay.vec(c) else 1
    cblk = by * lay.groups * lay.width
    units = min(lay.groups * lay.width, c - cblk) // unit
    cells = np.asarray(cells)
    # per (cell lane m, channel lane g): its (cell slot, channel slot)s
    mine = {}
    for m, g in itertools.product(range(lay.cell_lanes), range(lay.groups)):
        slots = [(g + u * lay.groups) * unit + i
                 for u in range(lay.width // unit)
                 if g + u * lay.groups < units for i in range(unit)]
        k, ch = np.meshgrid(np.arange(m, len(cells), lay.cell_lanes),
                            np.array(slots, dtype=np.int64), indexing="ij")
        mine[m, g] = np.stack([cells[k.ravel()], cblk + ch.ravel(),
                               k.ravel(), ch.ravel()], axis=1)
    out = []
    for warp in range(nwarps):
        for j0 in range(warp * qpw, count, nwarps * qpw):
            items, stores = {}, []
            for lane in range(32):
                qo, sub = divmod(lane, lanes)
                j = j0 + qo
                if qo >= qpw or j >= count:
                    items[lane] = []
                    continue
                g, m = sub % lay.groups, sub // lay.groups
                rows = mine[m, g]
                items[lane] = [np.concatenate(
                    [np.full((len(rows), 1), j), rows], axis=1)]
                if m == 0:
                    stores.append(lane)
            held = _shuffled(items, lanes, lay.groups)
            for lane in stores:
                out += held[lane]
    return np.concatenate(out) if out else np.zeros((0, 5), np.int64)


def _blend_items(geom, n, c, count):
    """Per channel block: the items of _lane_items for ``count`` queries
    of one block over all N cells."""
    return [_lane_items(geom.lanes, c, count, list(range(n)), by)
            for by in range(geom.lanes.grid_y(c))]


def _check_blend_layout(geom, c, dim):
    lay = geom.lanes
    assert 1 <= lay.width <= 8 or (lay.width == 16 and dim == 2)
    assert lay.lanes <= 32 and lay.threads in (128, 256)
    assert lay.cell_lanes & (lay.cell_lanes - 1) == 0
    assert not lay.vec(c) or lay.width % 4 == 0


def _check_blend_cover(lanes, n, c):
    for count in (QUERIES, 37, 1):
        hits = np.zeros((count, n, c), dtype=np.int64)
        for items in _blend_items(v1.V1Blend(lanes), n, c, count):
            np.add.at(hits, (items[:, 0], items[:, 1], items[:, 2]), 1)
        assert (hits == 1).all(), (lanes, n, c, count)


def _scatter_units(geom, n, c, count, by):
    """(query, cell, group) of every unit the lanes of a block in grid row
    ``by`` take for ``count`` queries, as texel_scatter.cuh's
    scatter_block walks them."""
    qpw = 32 // geom.lanes
    units = n * geom.lane_groups
    loops = geom.block_groups // geom.lane_groups
    groups = geom.groups(c)
    out = []
    for warp, lane in itertools.product(range(geom.threads // 32),
                                        range(32)):
        qo, u0 = divmod(lane, geom.lanes)
        if qo >= qpw:
            continue
        for j in range(warp * qpw + qo, count, geom.threads // 32 * qpw):
            for u in range(u0, units, geom.lanes):
                ni, gs = divmod(u, geom.lane_groups)
                for k in range(loops):
                    grp = by * geom.block_groups + gs + k * geom.lane_groups
                    if grp >= groups:
                        break
                    out.append((j, ni, grp))
    return out


def _check_bwd_layout(dim, geom, c):
    assert 1 <= geom.width <= 8 and 1 <= geom.lanes <= 32
    assert geom.block_groups % geom.lane_groups == 0
    assert scatter.QUERIES <= geom.threads <= 256
    assert geom.smem_bytes(c, dim) <= build.BLOCK_SMEM_BYTES


def _check_bwd_cover(geom, n, c):
    groups = geom.groups(c)
    for count in (QUERIES, 37, 1):
        hits = np.zeros((count, n, groups), dtype=np.int64)
        for by in range(geom.grid_y(c)):
            for j, ni, grp in _scatter_units(geom, n, c, count, by):
                hits[j, ni, grp] += 1
        assert (hits == 1).all(), (geom, n, c, count)


def test_v1_layouts_cover_every_cell_and_channel_once():
    """blend_geometry, bwd_geometry and every alternative chip_smoke.py's
    v1 sweep times, at every shape chip_smoke.py runs the pair: after the
    shuffles the storing lanes of a full, a ragged and a one-query block
    carry each (query, cell, channel) exactly once over the channel
    blocks, a lane at most 8 channels (16 in 2D); the scatter's lanes
    take each (query, cell,
    channel group) once, its shared memory within a block's."""
    blends, bwds = set(), set()
    for dim, n, c, s, q in SHAPES:
        spatial = _spatial(dim, s)
        for geom in v1.blend_alternatives(dim, n, c, q, spatial).values():
            _check_blend_layout(geom, c, dim)
            # the items depend on the lanes alone
            blends.add((geom.lanes, n, c))
        for geom in v1.bwd_alternatives(dim, n, c).values():
            _check_bwd_layout(dim, geom, c)
            bwds.add((geom, n, c))
    for args in blends:
        _check_blend_cover(*args)
    for args in bwds:
        _check_bwd_cover(*args)


def test_v1_layout_rule():
    """The rule: at 2D path (a) (96 x 16 x 16^2) a lane holds all 16
    channels and four lanes split a query's cells (each (query, cell)
    walked once), 256 threads, through the texel-major copy; at C = 32
    two channel lanes of 16 and two cell lanes; 3D path (a) and config 5
    the table blocks' gather (two lanes of 8 interleaved channels);
    planar below v1.PLANAR_POINTS_PER_TEXEL points a texel, at the
    planar sweep's points on the two sides of each bound (in 3D up to
    24 576 points on 128^3 and not from 32 768, in 2D up to 16 384 on
    1024^2 and not from 32 768); the bwd the scatter's dense rule, with
    128 threads a block in 3D."""
    geom = gather.GatherGeometry
    assert v1.blend_geometry(2, 96, 16, 100_000, (16, 16)) == v1.V1Blend(
        geom(16, 1, 4, 256))
    assert v1.blend_geometry(2, 8, 32, 4099, (12, 10)).lanes == geom(
        16, 2, 2, 256)
    assert v1.blend_geometry(2, 8, 12, 4099, (12, 10)).lanes == geom(
        8, 2, 1, 256)
    three = v1.blend_geometry(3, 50, 16, 100_000, (16, 16, 16))
    assert three == v1.V1Blend(geom(8, 2, 1, 256))
    assert v1.blend_geometry(3, 16, 16, 1_000_000, (128,) * 3) == three
    for dim, s, wins, loses in ((3, 128, 24576, 32768),
                                (2, 1024, 16384, 32768)):
        spatial = (s,) * dim
        for q in (1, 4096, wins):
            assert v1.blend_geometry(dim, 16, 16, q, spatial).planar, q
        for q in (loses, 100_000, 1_000_000):
            assert not v1.blend_geometry(dim, 16, 16, q, spatial).planar, q
    assert v1.PLANAR_POINTS_PER_TEXEL == {2: 1 / 32, 3: 1 / 64}
    # path (a)'s stacks read the copy at every point count swept
    for q in (256, 100_000):
        assert not v1.blend_geometry(2, 96, 16, q, (16, 16)).planar
        assert not v1.blend_geometry(3, 50, 16, q, (16,) * 3).planar
    assert v1.blend_geometry(3, 2, 16, 4096, (32,) * 3) == three
    assert v1.bwd_geometry(2, 96, 16) == scatter.ScatterGeometry(
        4, 4, 4, 32, 256)
    assert v1.bwd_geometry(3, 50, 16) == scatter.ScatterGeometry(
        4, 4, 4, 16, 128)
    assert scatter.ScatterGeometry(4, 4, 4, 32).smem_bytes(16, 2) == 41_984


def _blend_f64(x, pts, spatial, cfg, geom, n, c):
    """The (1 + 2D, C, Q) rows the v1 blend stores for blocks of 128
    queries, in f64 through the plain corner tables, reading at the
    kernel's addresses: the texel-major copy ((texel * N + cell) * C +
    channel) or the planar cells ((cell * C + channel) * texels +
    texel)."""
    dim = len(spatial)
    texels = int(np.prod(spatial))
    q = pts.shape[0]
    qi, ni, chl = [], [], []
    for b0 in range(0, q, QUERIES):
        for items in _blend_items(geom, n, c, min(QUERIES, q - b0)):
            qi.append(b0 + items[:, 0])
            ni.append(items[:, 1])
            chl.append(items[:, 2])
    qi, ni, chl = (torch.from_numpy(np.concatenate(v))
                   for v in (qi, ni, chl))
    if geom.planar:
        flat, src0, step = x.reshape(-1), (ni * c + chl) * texels, 1
    else:
        flat, src0, step = (fused3b.cells_to_vol(x).reshape(-1),
                            ni * c + chl, n * c)
    offs = multicell_offsets(n, cfg.multicell, F64, "cpu")[ni]
    rows = torch.zeros((q, 1 + 2 * dim, c), dtype=F64)
    for row, o in enumerate(all_orders(dim)):
        tables = per_axis_tables(pts[qi], spatial, cfg, o, n, offset=offs)
        acc = torch.zeros(qi.shape, dtype=F64)
        for corner in itertools.product((0, 1), repeat=dim):
            idx, wgt, ok = corner_index_weight(tables, corner, spatial, dim)
            texel = idx.clamp(0, texels - 1)
            acc = acc + torch.where(ok, wgt * flat[src0 + texel * step], 0.0)
        rows.index_put_((qi, torch.full_like(qi, row), chl), acc,
                        accumulate=True)
    return rows.permute(1, 2, 0)


def _bwd_f64(g, pts, spatial, cfg, geom, n):
    """The texel-major (*S, N, C) cotangent the scatter adds for blocks of
    128 queries, in f64 at the kernel's addresses ((texel * N + cell) * C
    + channel)."""
    dim = len(spatial)
    c, q = g.shape[1:]
    texels = int(np.prod(spatial))
    qi, ni, grp = [], [], []
    for b0 in range(0, q, QUERIES):
        count = min(QUERIES, q - b0)
        for by in range(geom.grid_y(c)):
            for j, cell, gr in _scatter_units(geom, n, c, count, by):
                qi.append(b0 + j)
                ni.append(cell)
                grp.append(gr)
    qi, ni, grp = (torch.tensor(v, dtype=torch.int64) for v in (qi, ni, grp))
    offs = multicell_offsets(n, cfg.multicell, F64, "cpu")[ni]
    acc = torch.zeros((texels * n * c,), dtype=F64)
    ch = grp[:, None] * geom.width + torch.arange(geom.width)[None, :]
    live = ch < c
    for row, o in enumerate(all_orders(dim)):
        tables = per_axis_tables(pts[qi], spatial, cfg, o, n, offset=offs)
        gq = g[row][ch.clamp(max=c - 1), qi[:, None]]
        for corner in itertools.product((0, 1), repeat=dim):
            idx, wgt, ok = corner_index_weight(tables, corner, spatial, dim)
            keep = ok[:, None] & live
            texel = idx.clamp(0, texels - 1)[:, None]
            dst = (texel * n + ni[:, None]) * c + ch
            acc.index_add_(0, dst[keep], (wgt[:, None] * gq)[keep])
    return acc.reshape(*spatial, n, c)


@pytest.mark.parametrize("padding,multicell", [
    ("zeros", True), ("border", True), ("reflection", True),
    ("zeros", False), ("border", False), ("reflection", False)])
@pytest.mark.parametrize("dim", [2, 3])
def test_v1_lane_walks_match_the_plain_versions_f64(dim, padding,
                                                    multicell):
    """The blend's lane walks (the rule's: in 2D at C = 16 four cell lanes
    of 16 channels each; the table blocks' two lanes of 8 channels; the
    planar cells) and the bwd's scatter (the rule's layout; every swept
    layout in zeros padding with multicell) into the texel-major scratch
    moved back by vol_to_cells, in f64 against
    plain_fused_blend / plain_fused_bwd, at N = 6, C = 16 (float4 loads
    and reductions) and C = 9 (scalar channels), points to +-1.3, 150
    queries (two blocks)."""
    cfg = TConfig(dim=dim, padding_mode=padding, multicell=multicell)
    spatial = (5, 6) if dim == 2 else (4, 5, 6)
    rng = np.random.RandomState(dim)
    n, q = 6, 150
    for c in (16, 9):
        x = torch.from_numpy(rng.standard_normal((n, c, *spatial)))
        pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, dim)))
        g = torch.from_numpy(rng.standard_normal((1 + 2 * dim, c, q)))
        want = plain_fused_blend(x, pts, cfg)
        rule = v1.blend_geometry(dim, n, c, q, spatial)
        for geom in (rule, rule._replace(planar=True),
                     v1.V1Blend(gather.gather_geometry(n, c))):
            got = _blend_f64(x, pts, spatial, cfg, geom, n, c)
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
        dwant = plain_fused_bwd(g, pts, spatial, cfg, n)
        # every swept layout in one setting, the rule's in the others
        bwds = v1.bwd_alternatives(dim, n, c)
        if (padding, multicell) != ("zeros", True):
            bwds = {"rule": bwds["rule"]}
        for geom in bwds.values():
            got = fused3b.vol_to_cells(_bwd_f64(g, pts, spatial, cfg, geom,
                                                n))
            torch.testing.assert_close(got, dwant, rtol=1e-10, atol=1e-12)


def test_layout_move_takes_4d_stacks_and_its_backward_the_other_way():
    """cells_to_vol / vol_to_cells on a 4-D stack: (N, C, H, W) <-> (H, W,
    N, C), torch's permuted copy, a new tensor; gradcheck and
    gradgradcheck in f64 show the backward is the move the other way; the
    kernel's wrapper takes CUDA tensors only."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.standard_normal((3, 2, 5, 6)))
    assert torch.equal(fused3b.cells_to_vol(x), x.permute(2, 3, 0, 1))
    v = torch.from_numpy(rng.standard_normal((5, 6, 3, 2)))
    assert torch.equal(fused3b.vol_to_cells(v), v.permute(2, 3, 0, 1))
    assert torch.equal(fused3b.vol_to_cells(fused3b.cells_to_vol(x)), x)
    one = torch.zeros((1, 1, 2, 2))
    assert fused3b.cells_to_vol(one).data_ptr() != one.data_ptr()
    for fn, t in ((fused3b.cells_to_vol, x), (fused3b.vol_to_cells, v)):
        t = t.clone().requires_grad_(True)
        assert torch.autograd.gradcheck(fn, (t,))
        assert torch.autograd.gradgradcheck(fn, (t,))
    with pytest.raises(ValueError, match="CUDA device"):
        fused3b.transpose_layout(x.float(), True)


class _Lib:
    """Stands in for the loaded library: each entry point a namespace that
    build._declare sets argtypes on."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_ctypes_declarations_match_the_v1_entry_points():
    """build._declare gives fused_v1_blend2/3 and fused_v1_bwd2/3 the
    pointer, int and float arguments of their C signatures, in order: a
    miscount would pass garbage on the card, which no CPU run shows."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    text = (build.CSRC / "fused.cu").read_text()
    for entry in ("fused_v1_blend2", "fused_v1_blend3", "fused_v1_bwd2",
                  "fused_v1_bwd3"):
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
