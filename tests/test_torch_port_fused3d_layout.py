"""PyTorch port, the host side of the small-cloud 3D fused pair
(csrc/fused3d.cu): the launch layouts of ``ops/cuda/fused3d.py``
``geometry`` and of every alternative chip_smoke.py's
``fused3d_layout_sweep_phase`` times, at every shape chip_smoke.py runs
the pair, a mirror of the kernels' lane walks over blocks of a few
queries in f64 against the plain versions, the shared launchers' block
size for their other callers, and the ctypes declarations.  No JAX: the
plain versions are held to the JAX package's interpret-mode kernels in
tests/test_torch_port_fused3ds.py.

The kernels run on the card only (chip_smoke.py holds them to their plain
versions there).  The lane mirrors are tests/test_torch_port_fused_v1_layout.py's
(``_lane_items`` for csrc/texel_gather.cuh's gather, ``_scatter_units``
for csrc/texel_scatter.cuh's scatter), walked here over fused3d's blocks.
"""

import ctypes
import itertools
import math
import re

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import multicell_offsets
from cosinesampler_tpu_torch.ops.cuda import build, fused3d, gather, scatter, v1
from cosinesampler_tpu_torch.ops.cuda.fused2w import (all_orders,
                                                      bwd_geometry,
                                                      plain_fused_blend,
                                                      plain_fused_bwd)
from cosinesampler_tpu_torch.ops.generic import (corner_index_weight,
                                                 per_axis_tables)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused_v1_layout import (_Lib, _blend_items,
                                             _scatter_units)

F64 = torch.float64
S16 = (16, 16, 16)

# (N, C, spatial, Q) of chip_smoke.py's fused3d calls: path (c) and its
# clouds, the 8-cell stack, the opted-in 8-channel group, the variants and
# channel counts, the layout cases (N in {1, 3, 6, 50}), the large cells
# and the layout sweep
SHAPES = sorted({
    *((50, 4, S16, q) for q in (200, 1024, 2047, 4096)),
    (8, 4, S16, 512), (8, 8, S16, 1500), (50, 8, S16, 1024),
    (5, 3, (6, 6, 6), 1000),
    *((n, c, (7, 8, 9), 2053) for n in (1, 3, 6, 50)
      for c in (1, 3, 4, 8, 12)),
    (16, 4, (32,) * 3, 1024), (16, 4, (32,) * 3, 4096),
    (16, 4, (128,) * 3, 1536),
}, key=str)


def _layouts(n, c, q, spatial):
    return (list(fused3d.blend_alternatives(n, c, q, spatial).values()),
            list(fused3d.bwd_alternatives(n, c, q, spatial).values()))


def test_cell_lanes_are_a_power_of_two_up_to_a_warp():
    """Every blend layout (the rule's and each alternative) splits a
    query's cells over a power of 2 of lanes, at most 32 and at most N, a
    lane of at most 8 channels (fused_rows.cuh kMaxChannels), float4 loads
    only over whole quads."""
    for n, c, spatial, q in SHAPES:
        for lay in _layouts(n, c, q, spatial)[0]:
            cl = lay.lanes.cell_lanes
            assert cl & (cl - 1) == 0 and 1 <= cl <= 32, (n, c, lay)
            assert cl <= max(1, 1 << (n.bit_length() - 1)), (n, c, lay)
            assert 1 <= lay.lanes.width <= 8 and lay.lanes.groups == 1
            assert not lay.lanes.vec(c) or lay.lanes.width % 4 == 0


def test_a_query_takes_at_most_a_warp_and_a_block_its_queries():
    """Both launches: a query's lanes fit one warp; a block of 128 or 256
    threads serves 1 to 128 queries (the shared bodies' kGatherQueries /
    kScatterQueries); the rules take one round a warp (threads / 32 warps
    of 32 // lanes queries each) and 128 threads; the bwd's shared memory
    within a block's; the bwd's lanes those of fused3w_bwd."""
    for n, c, spatial, q in SHAPES:
        blends, bwds = _layouts(n, c, q, spatial)
        for lay in blends:
            assert lay.lanes.lanes <= 32 and lay.lanes.threads in (128, 256)
            assert 1 <= lay.queries <= gather.QUERIES
        for lay in bwds:
            assert 1 <= lay.lanes.lanes <= 32
            assert lay.lanes.threads in (128, 256)
            assert 1 <= lay.queries <= scatter.QUERIES
            assert lay.lanes.block_groups % lay.lanes.lane_groups == 0
            assert lay.lanes.smem_bytes(c) <= build.BLOCK_SMEM_BYTES
        rule = fused3d.geometry(n, c, q, spatial)
        for lay in rule:
            assert lay.lanes.threads == fused3d.THREADS == 128
            assert lay.queries == 4 * (32 // lay.lanes.lanes)
        # the bwd's lanes are fused3w_bwd's (the scatter's rule at 128
        # threads in 3D); only its blocks differ
        assert rule.bwd.lanes == bwd_geometry(3, n, c, q, spatial).lanes


def test_path_c_fills_the_card():
    """At path (c) (50 x 4 x 16^3, 1 024 points) each launch takes a warp
    a query (32 cell lanes; the bwd's 32 lanes over 50 (cell, group of 4)
    units), 4 queries a block, 256 blocks: at least one a streaming
    multiprocessor (132), where fused3w's blocks of 128 queries make 8."""
    rule = fused3d.geometry(50, 4, 1024, S16)
    assert rule.blend.lanes == gather.GatherGeometry(4, 1, 32, 128)
    assert rule.bwd.lanes == scatter.ScatterGeometry(4, 1, 1, 32, 128)
    for lay in rule:
        assert lay.queries == 4 and lay.blocks(1024) == 256 >= 128
    assert -(-1024 // gather.QUERIES) == 8


def test_layouts_cover_every_query_cell_and_channel_once():
    """Over fused3d's blocks of a few queries, after the shuffles the
    storing lanes of a full, a ragged and a one-query block carry each
    (query, cell, channel) exactly once over the channel blocks, and the
    scatter's lanes take each (query, cell, channel group) once, for every
    layout of every shape chip_smoke.py runs."""
    blends, bwds = set(), set()
    for n, c, spatial, q in SHAPES:
        for lay in _layouts(n, c, q, spatial)[0]:
            blends.add((lay.lanes, lay.queries, n, c))
        for lay in _layouts(n, c, q, spatial)[1]:
            bwds.add((lay.lanes, lay.queries, n, c))
    for lanes, queries, n, c in blends:
        for count in {queries, max(1, queries // 2 + 1), 1}:
            hits = np.zeros((count, n, c), dtype=np.int64)
            for items in _blend_items(v1.BlendGeometry(lanes), n, c, count):
                np.add.at(hits, (items[:, 0], items[:, 1], items[:, 2]), 1)
            assert (hits == 1).all(), (lanes, queries, n, c, count)
    for lanes, queries, n, c in bwds:
        groups = lanes.groups(c)
        for count in {queries, max(1, queries // 2 + 1), 1}:
            hits = np.zeros((count, n, groups), dtype=np.int64)
            for by in range(lanes.grid_y(c)):
                for j, ni, grp in _scatter_units(lanes, n, c, count, by):
                    hits[j, ni, grp] += 1
            assert (hits == 1).all(), (lanes, queries, n, c, count)


def _calls(text, name):
    """The argument lists of every call of ``name<...>(...)`` in ``text``,
    split at their top-level commas (outside parentheses and braces)."""
    out = []
    for m in re.finditer(rf"{name}<[^>]*>\(", text):
        depth, i, args, start = 1, m.end(), [], m.end()
        while depth:
            ch = text[i]
            depth += ch in "({"
            depth -= ch in ")}"
            if ch == "," and depth == 1:
                args.append(text[start:i].strip())
                start = i + 1
            i += 1
        args.append(text[start:i - 1].strip())
        out.append(args)
    return out


def test_other_callers_of_the_shared_launchers_keep_128_queries_a_block():
    """csrc/fused.cu's launchers take the queries a block as their last
    argument, by default the shared bodies' kGatherQueries /
    kScatterQueries (128); every caller but the small-cloud pairs
    (fused2d.cu, fused3d.cu) leaves it at that default (the v1, fused2w
    and fused3w blends and bwds), and their host layouts have no block
    size of their own; fused2d.cu and fused3d.cu pass their layout's."""
    csrc = build.CSRC
    gather_h = (csrc / "texel_gather.cuh").read_text()
    scatter_h = (csrc / "texel_scatter.cuh").read_text()
    assert "constexpr int kGatherQueries = 128;" in gather_h
    assert "constexpr int kScatterQueries = 128;" in scatter_h
    assert "int qblock = kGatherQueries);" in gather_h
    assert "int qblock = kScatterQueries);" in scatter_h
    seen = 0
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for name in ("fused_gather_blend", "fused_scatter_bwd"):
            for args in _calls(text, name):
                if args[0].startswith("const float*"):
                    continue        # an explicit instantiation
                seen += 1
                if path.name in ("fused2d.cu", "fused3d.cu"):
                    assert len(args) == 14 and args[-1] == "queries", args
                else:
                    assert len(args) == 13, (path.name, name, args)
    # the v1 blends and bwds in 2D and 3D, fused2w's, fused3w's, fused2d's,
    # fused3d's
    assert seen == 12
    assert gather.QUERIES == scatter.QUERIES == 128
    assert "queries" not in v1.BlendGeometry._fields
    assert "queries" not in scatter.ScatterGeometry._fields


def test_planar_choices_on_both_sides_of_their_bounds():
    """The blend reads the cells in place below PLANAR_POINTS_PER_TEXEL
    times the stack's values plus PLANAR_VALUES cell values read (N x Q x
    C), the copy from there; the bwd adds in place below
    BWD_PLANAR_POINTS_PER_TEXEL times the stack's values plus
    BWD_PLANAR_VALUES, through the scratch from there; both from shapes
    alone, each bound checked on its two sides; at path (c) the blend in
    place, the bwd through the scratch (the sweep's device ms)."""
    rule = fused3d.geometry(50, 4, 1024, S16)
    assert rule.blend.planar and not rule.bwd.planar
    for n, c, spatial in ((50, 4, S16), (16, 4, (128,) * 3),
                          (8, 3, (32,) * 3)):
        texels = math.prod(spatial)
        edge = (fused3d.PLANAR_POINTS_PER_TEXEL * texels
                + fused3d.PLANAR_VALUES / (n * c))
        below, above = math.ceil(edge) - 1, math.ceil(edge)
        assert fused3d.geometry(n, c, below, spatial).blend.planar
        assert not fused3d.geometry(n, c, above, spatial).blend.planar
        edge = (fused3d.BWD_PLANAR_POINTS_PER_TEXEL * texels
                + fused3d.BWD_PLANAR_VALUES / (n * c))
        below, above = math.ceil(edge) - 1, math.ceil(edge)
        assert fused3d.geometry(n, c, below, spatial).bwd.planar
        assert not fused3d.geometry(n, c, above, spatial).bwd.planar
        for part in ("blend", "bwd"):
            for q in (1, 1024, 100_000):
                lay = getattr(fused3d.geometry(n, c, q, spatial), part)
                alts = (fused3d.blend_alternatives if part == "blend" else
                        fused3d.bwd_alternatives)(n, c, q, spatial)
                assert lay._replace(planar=not lay.planar) in alts.values()


def _blocks(q, queries):
    for b0 in range(0, q, queries):
        yield b0, min(queries, q - b0)


def _blend_f64(x, pts, spatial, cfg, lay, n, c):
    """The (1 + 2D, C, Q) rows fused3d_blend (fused2d_blend in 2D) stores
    over blocks of ``lay.queries`` queries, in f64 through the plain
    corner tables at the kernel's addresses: the texel-major copy ((texel
    * N + cell) * C + channel) or the planar cells ((cell * C + channel) *
    texels + texel)."""
    dim = len(spatial)
    texels = math.prod(spatial)
    q = pts.shape[0]
    qi, ni, chl = [], [], []
    for b0, count in _blocks(q, lay.queries):
        for items in _blend_items(v1.BlendGeometry(lay.lanes), n, c, count):
            qi.append(b0 + items[:, 0])
            ni.append(items[:, 1])
            chl.append(items[:, 2])
    qi, ni, chl = (torch.from_numpy(np.concatenate(v))
                   for v in (qi, ni, chl))
    if lay.planar:
        flat, src0, step = x.reshape(-1), (ni * c + chl) * texels, 1
    else:
        flat, src0, step = (x.permute(*range(2, 2 + dim), 0, 1).reshape(-1),
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


def _bwd_f64(g, pts, spatial, cfg, lay, n):
    """The (N, C, *S) cotangent fused3d_bwd (fused2d_bwd in 2D) adds over
    blocks of ``lay.queries`` queries, in f64 at the kernel's addresses:
    in place ((cell * C + channel) * texels + texel) where planar, else
    into the texel-major scratch ((texel * N + cell) * C + channel) moved
    back."""
    dim = len(spatial)
    geom = lay.lanes
    c, q = g.shape[1:]
    texels = math.prod(spatial)
    qi, ni, grp = [], [], []
    for b0, count in _blocks(q, lay.queries):
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
            dst = ((ni[:, None] * c + ch) * texels + texel if lay.planar
                   else (texel * n + ni[:, None]) * c + ch)
            acc.index_add_(0, dst[keep], (wgt[:, None] * gq)[keep])
    if lay.planar:
        return acc.reshape(n, c, *spatial)
    return acc.reshape(*spatial, n, c).permute(dim, dim + 1,
                                               *range(dim))


@pytest.mark.parametrize("padding,multicell", [
    ("zeros", True), ("reflection", True), ("border", False)])
def test_lane_walks_over_small_blocks_match_the_plain_versions_f64(
        padding, multicell):
    """The blend's lanes and the bwd's over fused3d's blocks, in every
    layout chip_smoke.py sweeps (the cells or cotangent in place and the
    texel-major copy or scratch), in f64 against plain_fused_blend /
    plain_fused_bwd: N = 6, C = 4 (float4 loads and reductions) and C = 3
    (scalars), points to +-1.3, 37 queries (ragged blocks)."""
    cfg = TConfig(dim=3, padding_mode=padding, multicell=multicell)
    spatial = (4, 5, 6)
    rng = np.random.RandomState(7)
    n, q = 6, 37
    for c in (4, 3):
        x = torch.from_numpy(rng.standard_normal((n, c, *spatial)))
        pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, 3)))
        g = torch.from_numpy(rng.standard_normal((7, c, q)))
        want = plain_fused_blend(x, pts, cfg)
        dwant = plain_fused_bwd(g, pts, spatial, cfg, n)
        blends, bwds = _layouts(n, c, q, spatial)
        for lay in blends:
            torch.testing.assert_close(
                _blend_f64(x, pts, spatial, cfg, lay, n, c), want,
                rtol=1e-10, atol=1e-12)
        for lay in bwds:
            torch.testing.assert_close(
                _bwd_f64(g, pts, spatial, cfg, lay, n), dwant, rtol=1e-10,
                atol=1e-12)


def test_ctypes_declarations_match_the_fused3d_entry_points():
    """build._declare gives fused3d_blend and fused3d_bwd the pointer, int
    and float arguments of their C signatures, in order, and the layouts
    as many integers as the entry points take after Q."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    text = (build.CSRC / "fused3d.cu").read_text()
    rule = fused3d.geometry(50, 4, 1024, S16)
    for entry, lay in (("fused3d_blend", rule.blend),
                       ("fused3d_bwd", rule.bwd)):
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        args = [a.strip() for a in sig.split(",")]
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in args]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
        names = [a.split()[-1] for a in args]
        assert names[names.index("q") + 1:names.index("kernel")][-1] == \
            "planar"
        assert len(names[names.index("q") + 1:names.index("kernel")]) == \
            len(lay.args()), entry
