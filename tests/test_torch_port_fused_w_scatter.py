"""PyTorch port, the host side of fused2w_bwd and fused3w_bwd: the launch
layouts of ``ops/cuda/fused2w.py`` (``bwd_geometry`` and every
alternative of chip_smoke.py's ``w_bwd_layout_sweep_phase``) at every
shape chip_smoke.py runs the two kernels, the scatter's lane walk in f64
into the texel-major scratch moved back and into the planar cotangent
against ``plain_fused_bwd``, the planar bound's choice from shapes alone,
and the ctypes declarations of the two C entry points.

The kernels run on the card only (chip_smoke.py holds them to their
plain versions there).  The lane walk is csrc/texel_scatter.cuh's
scatter_block over blocks of 128 queries in order, mirrored by
``_lane_units`` of tests/test_torch_port_scatter.py.
"""

import ctypes
import itertools
import math
import re
import types

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import multicell_offsets
from cosinesampler_tpu_torch.ops.cuda import (build, fused2w, fused3b, scatter,
                                              v1)
from cosinesampler_tpu_torch.ops.cuda.fused2w import (all_orders,
                                                      plain_fused_bwd)
from cosinesampler_tpu_torch.ops.generic import (corner_index_weight,
                                                 per_axis_tables)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_scatter import _lane_units

F64 = torch.float64
QUERIES = 128   # queries of a scatter block in query order

# (dim, N, C) of chip_smoke.py's fused2w_bwd / fused3w_bwd calls: the
# main paths and their variants, the channel counts and partial blocks,
# the large cells and the planar bound's sides, the C > 8 groups, the
# layout and planar sweeps, the 2D small-cloud sweep and path (b), the
# 3D sweep, the wide route sweep, the trainers and the cotangent checks
SHAPES = sorted({
    (2, 96, 4), (3, 50, 4), (2, 8, 3), (3, 6, 3),
    *((d, 6, c) for d in (2, 3) for c in (1, 3, 5, 8, 9, 12, 32)),
    *((d, 2, c) for d in (2, 3) for c in (4, 16)),
    *((d, n, c) for d, n in ((2, 96), (3, 50)) for c in (4, 8, 12, 16)),
    (2, 16, 4), (3, 16, 4), (2, 32, 4), (2, 8, 4), (3, 8, 4), (3, 2, 2),
    (3, 16, 2), (3, 16, 3), (3, 4, 4), (3, 6, 4), (3, 12, 4), (3, 16, 12),
    (3, 16, 16),
})


def _check_layout(dim, lanes, n, c):
    """At most 32 lanes a query, shared memory within a block's limit,
    and each (query, cell, channel group) of a full, a ragged and a
    one-query block in exactly one lane."""
    assert 1 <= lanes.width <= 8 and 1 <= lanes.lanes <= 32
    assert lanes.block_groups % lanes.lane_groups == 0
    assert scatter.QUERIES <= lanes.threads <= 256
    assert lanes.threads % 32 == 0
    assert lanes.smem_bytes(c, dim) <= build.BLOCK_SMEM_BYTES
    groups = lanes.groups(c)
    assert (groups - 1) * lanes.width < c <= groups * lanes.width
    for count in (QUERIES, 37, 1):
        hits = np.zeros((count, n, groups), dtype=np.int64)
        for by in range(lanes.grid_y(c)):
            for j, ni, grp in _lane_units(lanes, n, c, count, by):
                hits[j, ni, grp] += 1
        assert (hits == 1).all(), (dim, lanes, n, c, count)


def test_bwd_layouts_cover_every_pair_once():
    """bwd_geometry and every alternative of the sweep, at every (dim, N,
    C) chip_smoke.py runs fused2w_bwd / fused3w_bwd, both destinations:
    each (query, cell, channel group) in exactly one lane."""
    for dim, n, c in SHAPES:
        spatial = (16,) * dim
        geoms = [*fused2w.bwd_alternatives(dim, n, c, 64, spatial).values(),
                 *fused2w.bwd_alternatives(dim, n, c, 100_000,
                                           spatial).values()]
        assert {g.planar for g in geoms} == {False, True}
        for lanes in {g.lanes for g in geoms}:
            _check_layout(dim, lanes, n, c)


def test_bwd_geometry_rule():
    """The rule: scatter.py's layout for dense blocks (a warp's 32 lanes
    over 32 of a query's cells at the main paths, groups of 4 channels
    over the lanes at C = 16, scalar groups at C = 3 and 9), 128 threads
    a block in 3D, the v1 bwd's layout at every shape; the scratch at the
    main paths, and the alternatives the sweep times."""
    lay = scatter.ScatterGeometry
    main2 = fused2w.bwd_geometry(2, 96, 4, 100_000, (16, 16))
    main3 = fused2w.bwd_geometry(3, 50, 4, 100_000, (16, 16, 16))
    assert main2 == fused2w.BwdGeometry(lay(4, 1, 1, 32, 256), False)
    assert main3 == fused2w.BwdGeometry(lay(4, 1, 1, 32, 128), False)
    for dim, n, c in SHAPES:
        assert fused2w.bwd_geometry(dim, n, c, 100_000, (16,) * dim).lanes \
            == v1.bwd_geometry(dim, n, c)
    assert main2.args() == (4, 1, 1, 32, 256, 0)
    wide = fused2w.bwd_geometry(2, 96, 16, 1024, (16, 16))
    assert wide.lanes[:4] == (4, 4, 4, 32)
    assert fused2w.bwd_geometry(3, 6, 3, 4096, (7,) * 3).lanes.width == 3
    assert fused2w.bwd_geometry(2, 6, 9, 4099, (12, 10)).lanes.width == 5
    alts = fused2w.bwd_alternatives(3, 50, 4, 100_000, (16, 16, 16))
    assert alts["rule"] == main3 and alts["planar"].planar
    assert all(not g.planar for k, g in alts.items() if k != "planar")
    assert len(set(alts.values())) == len(alts) >= 4


def test_planar_bound_from_shapes():
    """Planar exactly below PLANAR_POINTS_PER_TEXEL[dim] points a texel
    of a cell, whatever N and C: never at the main paths' 100 000 points,
    always for a few points on config 5's volume, and on each side of the
    bound where chip_smoke.py checks both."""
    for dim, spatial in ((2, (128, 128)), (3, (32, 32, 32)),
                         (2, (1024, 1024)), (3, (128, 128, 128))):
        bound = fused2w.PLANAR_POINTS_PER_TEXEL[dim] * math.prod(spatial)
        for n, c in ((2, 4), (16, 16)):
            below = math.ceil(bound) - 1
            assert fused2w.bwd_geometry(dim, n, c, below, spatial).planar
            assert not fused2w.bwd_geometry(dim, n, c, math.ceil(bound),
                                            spatial).planar
            assert fused2w.bwd_geometry(dim, n, c, int(bound / 2),
                                        spatial).planar
            assert not fused2w.bwd_geometry(dim, n, c, int(2 * bound) + 1,
                                            spatial).planar
    for dim, n, s in ((2, 96, 16), (3, 50, 16)):
        assert not fused2w.bwd_geometry(dim, n, 4, 100_000,
                                        (s,) * dim).planar
    assert fused2w.bwd_geometry(3, 16, 4, 64, (128,) * 3).planar


def _walk_f64(g, pts, spatial, cfg, geom, n):
    """The scatter's adds for blocks of 128 queries in order, in f64:
    into the texel-major (*S, N, C) scratch at the kernel's addresses
    ((texel * N + cell) * C + channel), or where geom.planar into the
    (N, C, *S) cotangent at ((cell * C + channel) * texels + texel)."""
    dim = len(spatial)
    c, q = g.shape[1:]
    lanes = geom.lanes
    texels = math.prod(spatial)
    qi, ni, grp = [], [], []
    for b0 in range(0, q, QUERIES):
        count = min(QUERIES, q - b0)
        for by in range(lanes.grid_y(c)):
            for j, cell, gr in _lane_units(lanes, n, c, count, by):
                qi.append(b0 + j)
                ni.append(cell)
                grp.append(gr)
    qi, ni, grp = (torch.tensor(v, dtype=torch.int64) for v in (qi, ni, grp))
    offs = multicell_offsets(n, cfg.multicell, F64, "cpu")[ni]
    acc = torch.zeros((texels * n * c,), dtype=F64)
    ch = grp[:, None] * lanes.width + torch.arange(lanes.width)[None, :]
    live = ch < c
    for row, o in enumerate(all_orders(dim)):
        tables = per_axis_tables(pts[qi], spatial, cfg, o, n, offset=offs)
        gq = g[row][ch.clamp(max=c - 1), qi[:, None]]
        for corner in itertools.product((0, 1), repeat=dim):
            idx, wgt, ok = corner_index_weight(tables, corner, spatial, dim)
            keep = ok[:, None] & live
            texel = idx.clamp(0, texels - 1)[:, None]
            if geom.planar:
                dst = (ni[:, None] * c + ch) * texels + texel
            else:
                dst = (texel * n + ni[:, None]) * c + ch
            acc.index_add_(0, dst[keep], (wgt[:, None] * gq)[keep])
    if geom.planar:
        return acc.reshape(n, c, *spatial)
    return fused3b.vol_to_cells(acc.reshape(*spatial, n, c))


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("dim", [2, 3])
def test_lane_walk_matches_plain_fused_bwd_f64(dim, padding):
    """The rule's lane walk into the texel-major scratch moved back by
    vol_to_cells, and into the cotangent in place (planar), in f64
    against plain_fused_bwd, multicell on and off, at N = 6 (not a
    divisor of 32) and C in {1, 3, 4, 8, 12, 16} (scalar groups of 1, 3;
    float4 groups of 4, two, three and four of them over the lanes),
    points to +-1.3, 150 queries (a full and a partial block)."""
    spatial = (5, 6) if dim == 2 else (4, 5, 6)
    rng = np.random.RandomState(10 + dim)
    n, q = 6, 150
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, dim)))
    for multicell in (True, False):
        cfg = TConfig(dim=dim, padding_mode=padding, multicell=multicell)
        for c in (1, 3, 4, 8, 12, 16):
            g = torch.from_numpy(rng.standard_normal((1 + 2 * dim, c, q)))
            want = plain_fused_bwd(g, pts, spatial, cfg, n)
            rule = fused2w.bwd_geometry(dim, n, c, q, spatial)
            for planar in (False, True):
                got = _walk_f64(g, pts, spatial, cfg,
                                rule._replace(planar=planar), n)
                torch.testing.assert_close(got, want, rtol=1e-10,
                                           atol=1e-12)


class _Lib:
    """Stands in for the loaded library: each entry point a namespace that
    build._declare sets argtypes on."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_ctypes_declarations_match_the_c_entry_points():
    """build._declare gives fused2w_bwd and fused3w_bwd (and their blends)
    the pointer, int and float arguments of their C signatures, in order,
    and the wrapper passes as many layout integers as the signature
    takes: a miscount would pass garbage on the card, which no CPU run
    shows."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for src, entry in (("fused2w.cu", "fused2w_bwd"),
                       ("fused2w.cu", "fused2w_blend"),
                       ("fused3w.cu", "fused3w_bwd"),
                       ("fused3w.cu", "fused3w_blend")):
        text = (build.CSRC / src).read_text()
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        args = [a.split()[-1].strip("*") for a in sig.split(",")]
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
        if entry.endswith("bwd"):
            layout = args[args.index("q") + 1:args.index("kernel")]
            assert layout == ["width", "block_groups", "lane_groups",
                              "lanes", "threads", "planar"]
            geom = fused2w.bwd_geometry(3, 50, 4, 100, (16,) * 3)
            assert len(geom.args()) == len(layout)
