"""PyTorch port, the host side of the small-cloud 2D fused pair
(csrc/fused2d.cu): the launch layouts of ``ops/cuda/fused2d.py``
``geometry`` (ops/cuda/small_cloud.py's rule with fused2d's planar
bounds) and of every alternative chip_smoke.py's
``fused2d_layout_sweep_phase`` times, at every shape chip_smoke.py runs
the pair, a mirror of the kernels' lane walks over blocks of a few
queries in f64 against the plain versions, the shared launchers' block
size for their other callers, and the ctypes declarations.  No JAX: the
plain versions are held to the JAX package's interpret-mode kernels in
tests/test_torch_port_fused_v1.py.

The kernels run on the card only (chip_smoke.py holds them to their plain
versions there).  The lane mirrors are
tests/test_torch_port_fused_v1_layout.py's (``_blend_items`` for
csrc/texel_gather.cuh's gather, ``_scatter_units`` for
csrc/texel_scatter.cuh's scatter), walked over fused2d's blocks by
tests/test_torch_port_fused3d_layout.py's f64 mirrors of the kernels'
addresses (``_blend_f64``, ``_bwd_f64``).
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import (build, fused2d, fused2w,
                                              gather, scatter, v1)
from cosinesampler_tpu_torch.ops.cuda.fused2w import (plain_fused_blend,
                                                      plain_fused_bwd)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused3d_layout import _blend_f64, _bwd_f64, _calls
from test_torch_port_fused_v1_layout import (_Lib, _blend_items,
                                             _scatter_units)

S16 = (16, 16)

# (N, C, spatial, Q) of chip_smoke.py's fused2d calls: path (b)'s clouds
# and its trainer, the variants and channel counts, 100 000 points, the
# large cells, the layout cases (N in {1, 3, 6, 96}), the layout and
# planar sweeps and the route sweep's stacks
SHAPES = sorted({
    *((96, 4, S16, q) for q in (200, 1024, 2047, 4096, 100_000)),
    (8, 4, S16, 512), (32, 4, S16, 4096), (96, 8, S16, 1024),
    *((8, c, (12, 10), 1037) for c in (9, 12)),
    (3, 4, (64, 64), 1500), (2, 4, (256, 256), 4096),
    (16, 4, (64, 64), 4096), (16, 4, (1024, 1024), 65536),
    *((n, c, (12, 10), 2053) for n in (1, 3, 6, 96)
      for c in (1, 3, 4, 8, 12)),
    *((n, 4, S16, 2048) for n in (8, 16, 24, 32, 48, 64)),
}, key=str)


def _layouts(n, c, q, spatial):
    return (list(fused2d.blend_alternatives(n, c, q, spatial).values()),
            list(fused2d.bwd_alternatives(n, c, q, spatial).values()))


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
    kScatterQueries); the rules take 128 threads and one round a warp
    (threads / 32 warps of 32 // lanes queries each), the bwd two from
    BWD_ROUND_BLOCKS blocks of one; the bwd's shared memory within a
    block's; the bwd's lanes those of fused2w_bwd at 128 threads."""
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
            assert lay.lanes.smem_bytes(c, 2) <= build.BLOCK_SMEM_BYTES
        rule = fused2d.geometry(n, c, q, spatial)
        for lay in rule:
            assert lay.lanes.threads == fused2d.THREADS == 128
        one = 4 * (32 // rule.bwd.lanes.lanes)
        rounds = 2 if -(-q // one) >= fused2d.BWD_ROUND_BLOCKS else 1
        assert rule.blend.queries == 4 * (32 // rule.blend.lanes.lanes)
        assert rule.bwd.queries == min(128, rounds * one)
        # the bwd's lanes are fused2w_bwd's (the scatter's rule in 2D);
        # only its block size and its blocks differ
        want = fused2w.bwd_geometry(2, n, c, q, spatial).lanes
        assert rule.bwd.lanes == want._replace(threads=128)


def test_path_b_fills_the_card():
    """At path (b) (96 x 4 x 16^2, 1 024 points) each launch takes a warp
    a query (32 cell lanes, each walking 3 of the 96 cells; the bwd's 32
    lanes over 96 (cell, group of 4) units), 4 queries a block, 256
    blocks: at least one a streaming multiprocessor (132), where fused2w's
    blocks of 128 queries make 8; at 200 points 50 blocks.  The bwd's
    warps take two rounds from BWD_ROUND_BLOCKS (1 024) blocks of one: at
    4 093 points 512 blocks of 8 queries, at 4 092 1 023 of 4."""
    rule = fused2d.geometry(96, 4, 1024, S16)
    assert rule.blend.lanes == gather.GatherGeometry(4, 1, 32, 128)
    assert rule.bwd.lanes == scatter.ScatterGeometry(4, 1, 1, 32, 128)
    for lay in rule:
        assert lay.queries == 4 and lay.blocks(1024) == 256 >= 128
        assert lay.blocks(200) == 50
    assert -(-1024 // gather.QUERIES) == 8
    assert 96 // rule.blend.lanes.cell_lanes == 3
    assert fused2d.BWD_ROUND_BLOCKS == 1024
    for q, queries in ((4092, 4), (4093, 8), (16384, 8)):
        bwd = fused2d.geometry(96, 4, q, S16).bwd
        assert bwd.queries == queries, q
        assert bwd.blocks(q) == -(-q // queries)


def test_layouts_cover_every_query_cell_and_channel_once():
    """Over fused2d's blocks of a few queries, after the shuffles the
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


def test_fused2d_passes_its_block_and_the_2d_callers_keep_128_queries():
    """csrc/fused2d.cu calls csrc/fused.cu's launchers at D = 2 with its
    layout's queries a block last; the other 2D callers (fused2w.cu and
    the v1 pair in fused.cu) leave it at its default, kGatherQueries /
    kScatterQueries (128), and their host layouts have no block size of
    their own; fused2d's alternatives include those 128-query blocks."""
    csrc = build.CSRC
    for name in ("fused_gather_blend", "fused_scatter_bwd"):
        (args,) = _calls((csrc / "fused2d.cu").read_text(), name)
        assert args[6] == "geom2(h, w)" and args[-1] == "queries", args
        (args,) = _calls((csrc / "fused2w.cu").read_text(), name)
        assert args[6] == "geom2(h, w)" and len(args) == 13, args
        v1_calls = [args for args in _calls((csrc / "fused.cu").read_text(),
                                            name)
                    if not args[0].startswith("const float*")]
        assert v1_calls and all(len(args) == 13 for args in v1_calls)
    assert "queries" not in v1.BlendGeometry._fields
    assert "queries" not in fused2w.BwdGeometry._fields
    alts = fused2d.blend_alternatives(96, 4, 1024, S16)
    assert alts["128-query blocks"].queries == gather.QUERIES
    assert alts["128-query blocks"].lanes.cell_lanes == \
        v1.NARROW_CELL_LANES[2]
    alts = fused2d.bwd_alternatives(96, 4, 1024, S16)
    assert alts["128-query blocks"].queries == scatter.QUERIES


def test_planar_choices_on_both_sides_of_their_bounds():
    """The blend reads the cells in place below PLANAR_POINTS_PER_TEXEL
    times the stack's values plus PLANAR_VALUES cell values read (N x Q x
    C), the copy from there; the bwd adds in place below
    BWD_PLANAR_POINTS_PER_TEXEL times the stack's values plus
    BWD_PLANAR_VALUES, through the scratch from there; both from shapes
    alone, each bound checked on its two sides, and the other choice
    always among the alternatives."""
    for n, c, spatial in ((96, 4, S16), (16, 4, (1024, 1024)),
                          (8, 3, (64, 64))):
        texels = math.prod(spatial)
        edge = (fused2d.PLANAR_POINTS_PER_TEXEL * texels
                + fused2d.PLANAR_VALUES / (n * c))
        below, above = math.ceil(edge) - 1, math.ceil(edge)
        assert fused2d.geometry(n, c, below, spatial).blend.planar
        assert not fused2d.geometry(n, c, above, spatial).blend.planar
        edge = (fused2d.BWD_PLANAR_POINTS_PER_TEXEL * texels
                + fused2d.BWD_PLANAR_VALUES / (n * c))
        below, above = math.ceil(edge) - 1, math.ceil(edge)
        assert fused2d.geometry(n, c, below, spatial).bwd.planar
        assert not fused2d.geometry(n, c, above, spatial).bwd.planar
        for part in ("blend", "bwd"):
            for q in (1, 1024, 100_000):
                lay = getattr(fused2d.geometry(n, c, q, spatial), part)
                alts = (fused2d.blend_alternatives if part == "blend" else
                        fused2d.bwd_alternatives)(n, c, q, spatial)
                assert lay._replace(planar=not lay.planar) in alts.values()


@pytest.mark.parametrize("padding,multicell", [
    ("zeros", True), ("reflection", True), ("border", False)])
def test_lane_walks_over_small_blocks_match_the_plain_versions_f64(
        padding, multicell):
    """The blend's lanes and the bwd's over fused2d's blocks, in every
    layout chip_smoke.py sweeps (the cells or cotangent in place and the
    texel-major copy or scratch), in f64 against plain_fused_blend /
    plain_fused_bwd: N = 40 (cells past the warp's 32 lanes), C = 4
    (float4 loads and reductions) and C = 3 (scalars), points to +-1.3,
    37 queries (ragged blocks)."""
    cfg = TConfig(dim=2, padding_mode=padding, multicell=multicell)
    spatial = (5, 6)
    rng = np.random.RandomState(8)
    n, q = 40, 37
    for c in (4, 3):
        x = torch.from_numpy(rng.standard_normal((n, c, *spatial)))
        pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, 2)))
        g = torch.from_numpy(rng.standard_normal((5, c, q)))
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


def test_ctypes_declarations_match_the_fused2d_entry_points():
    """build._declare gives fused2d_blend and fused2d_bwd the pointer, int
    and float arguments of their C signatures, in order, and the layouts
    as many integers as the entry points take after Q."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    text = (build.CSRC / "fused2d.cu").read_text()
    rule = fused2d.geometry(96, 4, 1024, S16)
    for entry, lay in (("fused2d_blend", rule.blend),
                       ("fused2d_bwd", rule.bwd)):
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        args = [a.strip() for a in sig.split(",")]
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in args]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
        names = [a.split()[-1] for a in args]
        layout = names[names.index("q") + 1:names.index("kernel")]
        assert layout[-2:] == ["queries", "planar"], entry
        assert len(layout) == len(lay.args()), entry
