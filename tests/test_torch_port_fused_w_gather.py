"""PyTorch port, the host side of fused2w_blend and fused3w_blend and the
plain route at precision "bf16" / "fast": the blends' launch layouts
(``ops/cuda/v1.py`` ``blend_geometry`` up to 8 channels and every
alternative of chip_smoke.py's ``w_blend_layout_sweep_phase``), the
gather's lane walk in f64 through the texel-major copy and the planar
cells against ``plain_fused_blend``, the planar bound from shapes alone,
the fused op's route bounds at their edges, the routes of a fused op
call, a planned and a vol-resident call at "bf16" and "fast" on the card
(the counted plain route), the plain blend at "bf16" against the JAX
package's ``xla_fused_blend``, and the blends' ctypes declarations.

The kernels run on the card only (chip_smoke.py holds them to their
plain versions there).  The lane walk is csrc/texel_gather.cuh's
gather_block over blocks of 128 queries in order, mirrored by
``_lane_items`` of tests/test_torch_port_fused_v1_layout.py.
"""

import ctypes
import itertools
import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import build, fused2w, fused3b, route, v1
from cosinesampler_tpu_torch.ops.cuda.fused2w import plain_fused_blend
from cosinesampler_tpu_torch.ops.cuda.gather import GatherGeometry
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused_v1_layout import (_blend_f64, _blend_items,
                                              _check_blend_layout)

F32 = torch.float32
QUERIES = 128   # queries of a gather block in query order
# (dim, N, S) of the main paths and of chip_smoke.py's w blend checks
MAIN = ((2, 96, (16, 16)), (3, 50, (16, 16, 16)))
SMALL = ((2, 6, (12, 10)), (3, 6, (7, 8, 9)))
CHANNELS = (1, 2, 3, 4, 5, 6, 7, 8, 12, 16)


def test_blend_layouts_cover_every_cell_and_channel_once():
    """blend_geometry and every alternative the w blend sweep times, at
    the main paths' and chip_smoke.py's small stacks, C = 1...8, 12, 16:
    at most 32 lanes a query, a lane at most 8 channels (16 in 2D),
    cell lanes a power of 2, 128 or 256 threads; after the shuffles the
    storing lanes of a full, a ragged and a one-query block carry each
    (query, cell, channel) exactly once."""
    seen = set()
    for dim, n, spatial in MAIN + SMALL:
        for c in CHANNELS:
            for q in (64, 100_000):
                for geom in v1.blend_alternatives(dim, n, c, q,
                                                  spatial).values():
                    _check_blend_layout(geom, c, dim)
                    seen.add((geom.lanes, n, c))
    for lanes, n, c in seen:
        for count in (QUERIES, 37, 1):
            hits = np.zeros((count, n, c), dtype=np.int64)
            for items in _blend_items(v1.BlendGeometry(lanes), n, c, count):
                np.add.at(hits, (items[:, 0], items[:, 1], items[:, 2]), 1)
            assert (hits == 1).all(), (lanes, n, c, count)


def test_narrow_blend_rule():
    """Up to 8 channels a lane holds all C channels (each (query, cell)
    walked once) and four (2D) or two (3D) lanes split a query's cells,
    256 threads a block, through the texel-major copy at the main paths;
    above 8 channels the v1 blend's rule; the alternatives the sweep
    times include every cell-lane count at both block sizes and the
    other read."""
    assert v1.NARROW_CELL_LANES == {2: 4, 3: 2}
    for dim, n, spatial in MAIN:
        for c in CHANNELS:
            geom = v1.blend_geometry(dim, n, c, 100_000, spatial)
            assert not geom.planar
            if c > 8:
                assert geom.lanes.width > 4 and geom.lanes.lanes <= 32
                continue
            cell_lanes = v1.NARROW_CELL_LANES[dim]
            assert geom.lanes == GatherGeometry(c, 1, cell_lanes, 256)
            assert geom.args() == (c, 1, cell_lanes, 256, 0)
            alts = v1.blend_alternatives(dim, n, c, 100_000, spatial)
            lanes = {(g.lanes.cell_lanes, g.lanes.threads)
                     for g in alts.values() if g.lanes.groups == 1
                     and g.lanes.width == c}
            assert lanes == {(k, t) for k in (1, 2, 4, 8) for t in (128, 256)}
            assert {g.planar for g in alts.values()} == {False, True}
    # few cells cap the cell lanes
    assert v1.blend_geometry(2, 1, 4, 100, (16, 16)).lanes.cell_lanes == 1


def test_narrow_planar_bound_from_shapes():
    """Up to 8 channels planar exactly where the cell values read (N x Q
    x C) fall below NARROW_PLANAR_POINTS_PER_TEXEL[dim] times the stack's
    plus NARROW_PLANAR_VALUES[dim]; above 8
    channels below PLANAR_POINTS_PER_TEXEL[dim] points a texel.  At the
    planar sweep's points: the main paths' stacks planar up to 4 096 (2D)
    and 16 384 points (3D) and not from 16 384 / 32 768; the stacks over
    the L2 planar at 32 768 (2D) and 65 536 points (3D), not at twice
    those; the two-cell large cells planar at every point count swept."""
    geom = v1.blend_geometry
    for dim, spatial in ((2, (128, 128)), (3, (32, 32, 32)),
                         (2, (1024, 1024)), (3, (128, 128, 128))):
        texels = math.prod(spatial)
        for n, c in ((2, 4), (16, 4), (16, 1), (16, 8), (96, 3)):
            bound = (v1.NARROW_PLANAR_POINTS_PER_TEXEL[dim] * texels
                     + v1.NARROW_PLANAR_VALUES[dim] / (n * c))
            assert geom(dim, n, c, math.ceil(bound) - 1, spatial).planar
            assert not geom(dim, n, c, math.ceil(bound), spatial).planar
        bound = v1.PLANAR_POINTS_PER_TEXEL[dim] * texels
        assert geom(dim, 16, 16, math.ceil(bound) - 1, spatial).planar
        assert not geom(dim, 16, 16, math.ceil(bound), spatial).planar
    for dim, n, s, planar, copy in ((2, 96, 16, 4096, 16384),
                                    (3, 50, 16, 16384, 32768),
                                    (2, 16, 1024, 32768, 65536),
                                    (3, 16, 128, 65536, 131072)):
        spatial = (s,) * dim
        assert geom(dim, n, 4, planar, spatial).planar, (dim, n, s)
        assert not geom(dim, n, 4, copy, spatial).planar, (dim, n, s)
        assert not geom(dim, n, 4, 100_000 + copy, spatial).planar
    for dim, s in ((2, 128), (3, 32)):
        assert geom(dim, 2, 4, 65536, (s,) * dim).planar


@pytest.mark.parametrize("dim", [2, 3])
def test_w_blend_lane_walk_matches_plain_fused_blend_f64(dim):
    """The rule's lane walk up to 8 channels and the other cell-lane
    counts, through the texel-major copy and the planar cells, in f64
    against plain_fused_blend: three paddings, multicell on and off, N = 6
    (not a power of 2), C in {1, 3, 4, 8} (scalar and float4 loads),
    points to +-1.3, 150 queries (a full and a partial block)."""
    spatial = (5, 6) if dim == 2 else (4, 5, 6)
    rng = np.random.RandomState(20 + dim)
    n, q = 6, 150
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, dim)))
    for padding in ("zeros", "border", "reflection"):
        for multicell in (True, False):
            cfg = TConfig(dim=dim, padding_mode=padding, multicell=multicell)
            for c in (1, 3, 4, 8):
                x = torch.from_numpy(rng.standard_normal((n, c, *spatial)))
                want = plain_fused_blend(x, pts, cfg)
                rule = v1.blend_geometry(dim, n, c, q, spatial)
                for geom in (rule, rule._replace(planar=not rule.planar),
                             rule._replace(lanes=rule.lanes._replace(
                                 cell_lanes=8 // rule.lanes.cell_lanes))):
                    got = _blend_f64(x, pts, spatial, cfg, geom, n, c)
                    torch.testing.assert_close(got, want, rtol=1e-10,
                                               atol=1e-12)


def test_fused_rule_bounds_at_their_edges():
    """route.fused_rule's measured bounds up to 8 channels on their two
    sides, shapes alone (chip_smoke.py small_cloud_sweep_phase,
    small_cloud_3d_sweep_phase; PERF.md section 4): fused2d up to
    FUSED2D_MAX_Q queries or FUSED2D_MAX_Q_PER_CELL queries a cell,
    whichever allows more, on any stack; fused3d up to
    FUSED3D_MAX_Q_PER_CELL queries
    a cell and FUSED3D_MAX_Q; fused3s from FUSED3S_MIN_Q; fused2w / fused3w
    otherwise."""
    rule = route.fused_rule
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    max_q, per_cell2 = route.FUSED2D_MAX_Q, route.FUSED2D_MAX_Q_PER_CELL
    for n in (1, 8, 32):
        assert n * per_cell2 <= max_q
        assert rule(cfg2, (n, 4, 16, 16), max_q) == "fused2d"
        assert rule(cfg2, (n, 4, 16, 16), max_q + 1) == "fused2w"
    assert rule(cfg2, (2, 4, 256, 256), max_q) == "fused2d"
    assert rule(cfg2, (16, 4, 1024, 1024), max_q + 1) == "fused2w"
    for n in (33, 48, 96):
        assert n * per_cell2 > max_q
        assert rule(cfg2, (n, 4, 16, 16), n * per_cell2) == "fused2d"
        assert rule(cfg2, (n, 4, 16, 16), n * per_cell2 + 1) == "fused2w"
    per_cell = route.FUSED3D_MAX_Q_PER_CELL
    for n in (2, 4, 8):
        assert rule(cfg3, (n, 4, 16, 16, 16), n * per_cell) == "fused3d"
        assert rule(cfg3, (n, 4, 16, 16, 16), n * per_cell + 1) == "fused3w"
    assert rule(cfg3, (50, 4, 16, 16, 16), route.FUSED3D_MAX_Q) == "fused3d"
    assert rule(cfg3, (50, 4, 16, 16, 16), route.FUSED3D_MAX_Q + 1) == \
        "fused3w"
    big = (16, 4, 128, 128, 128)
    assert rule(cfg3, big, route.FUSED3S_MIN_Q) == "fused3s"
    assert rule(cfg3, big, route.FUSED3S_MIN_Q - 1) == "fused3w"
    for dim, n, spatial in MAIN:
        assert rule(TConfig(dim=dim), (n, 4, *spatial), 100_000) == \
            f"fused{dim}w"


def test_fused_rule_takes_plain_at_bf16_and_fast():
    """A CUDA fused op call at precision "bf16" or "fast" takes the plain
    route in 2D and 3D, at every channel count and point count, as does
    the planned and vol-resident ops' route (route.vol_rule); at "exact"
    and "highest" the kernels; off the card the kernel routes, whose
    wrappers take the plain versions."""
    for dim, n, spatial in MAIN + SMALL:
        for c, q in ((4, 100_000), (4, 512), (16, 100_000)):
            shape = (n, c, *spatial)
            for precision in ("bf16", "fast"):
                cfg = TConfig(dim=dim, precision=precision)
                assert route.fused_rule(cfg, shape, q, "cuda") == "plain"
                assert route.fused_rule(cfg, shape, q, "cpu") == \
                    route.fused_rule(TConfig(dim=dim), shape, q, "cuda")
                assert route.vol_rule(cfg, "cuda") == "plain"
                assert route.vol_rule(cfg, "cpu") == "fused3b"
            for precision in ("exact", "highest"):
                cfg = TConfig(dim=dim, precision=precision)
                assert route.fused_rule(cfg, shape, q, "cuda") != "plain"
                assert route.vol_rule(cfg, "cuda") == "fused3b"
    # the kernels themselves still refuse what they do not compute
    with pytest.raises(NotImplementedError):
        fused2w.check_kernel_inputs(TConfig(dim=2, precision="bf16"))


def test_planned_and_vol_resident_ops_take_the_plain_route_at_bf16(
        monkeypatch):
    """The dispatch of a bf16 call as on the card (the rules given the
    device type "cuda", the tensors on the CPU): the fused op, the planned
    op (make_sample_plan's brick plan) and the vol-resident op each take
    the counted plain route for the blend and the bwd, keep their API
    (rows in the plan's slots, occ, positions; the volume cotangent in the
    kernel layout) and give the exact config's values."""
    vol_rule, fused_rule = route.vol_rule, route.fused_rule
    monkeypatch.setattr(route, "vol_rule",
                        lambda cfg, device_type: vol_rule(cfg, "cuda"))
    monkeypatch.setattr(route, "fused_rule",
                        lambda cfg, shape, q, device_type, dtype: fused_rule(
                            cfg, shape, q, "cuda", dtype))
    rng = np.random.RandomState(7)
    n, c, spatial, q = 3, 2, (6, 7, 8), 200
    cells = torch.from_numpy(rng.rand(n, c, *spatial).astype(np.float32))
    pts = torch.from_numpy(rng.uniform(-1.1, 1.1, (q, 3)).astype(np.float32))

    def run(precision, how):
        cfg = TConfig(dim=3, precision=precision)
        leaf = cells.clone().requires_grad_(True)
        before = route.run_plain.launches
        if how == "op":
            out = tfused.sample_features_with_derivs(leaf, pts, cfg)
            grad_of = leaf
        elif how == "planned":
            plan = tfused.make_sample_plan(pts, cells.shape, cfg)
            out, occ, positions = tfused.sample_features_padded(
                leaf, pts, cfg, plan)
            assert out.shape[-1] == occ.shape[0] > q
            assert positions.shape == (q,)
            grad_of = leaf
        else:
            fused_vol, to_vol, _ = tfused.make_fused_vol(cfg, n, c, spatial,
                                                         q)
            vol = to_vol(cells).requires_grad_(True)
            plan = tfused.make_vol_plan(pts, cells.shape, cfg)
            out, _, _ = fused_vol(vol, pts, plan)
            grad_of = vol
        g = np.random.RandomState(8).standard_normal(out.shape)
        (out * torch.from_numpy(g.astype(np.float32))).sum().backward()
        assert grad_of.grad.shape == grad_of.shape
        return (out.detach(), grad_of.grad,
                route.run_plain.launches - before)

    for how in ("op", "planned", "vol"):
        out16, grad16, plain16 = run("bf16", how)
        out32, grad32, plain32 = run("exact", how)
        assert (plain16, plain32) == (2, 0), how
        torch.testing.assert_close(out16, out32, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grad16, grad32, rtol=1e-6, atol=1e-6)
    assert fused3b.vol_layout(n, c, spatial) == (*spatial, n, c)


def _close(got, want, rtol):
    """rtol against each element, with an absolute floor of rtol times the
    largest magnitude (the fused op's JAX tests' tolerance)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def test_plain_bf16_blend_matches_jax_xla_fused_blend():
    """The port's plain blend at precision "bf16" (f32, unchanged) against
    the JAX package's xla_fused_blend at "bf16" on the same NumPy inputs,
    in 2D and 3D, at the fused op's JAX tolerance (rtol 1e-5,
    tests/test_torch_port_fused.py)."""
    for dim, kw in itertools.product(
            (2, 3), (dict(), dict(padding_mode="reflection",
                                  kernel="linear"))):
        rng = np.random.RandomState(30 + dim)
        spatial = (6, 7) if dim == 2 else (5, 6, 7)
        cells = rng.rand(4, 3, *spatial).astype(np.float32)
        pts = rng.uniform(-1.2, 1.2, (150, dim)).astype(np.float32)
        want = jfused.xla_fused_blend(
            jnp.asarray(cells), jnp.asarray(pts),
            JConfig(dim=dim, precision="bf16", **kw))
        got = plain_fused_blend(torch.from_numpy(cells),
                                torch.from_numpy(pts),
                                TConfig(dim=dim, precision="bf16", **kw))
        assert got.dtype == F32
        _close(got.numpy(), want, 1e-5)


class _Lib:
    """Stands in for the loaded library: each entry point a namespace that
    build._declare sets argtypes on."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_blend_entry_points_take_the_blend_layout():
    """The three blends' C entry points share fused_gather_blend's
    arguments: build._declare gives each the pointer, int and float
    arguments of its signature, in order, and the five layout integers
    (width, groups, cell lanes, threads, planar) are as many as
    BlendGeometry.args gives."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for src, entry in (("fused2w.cu", "fused2w_blend"),
                       ("fused3w.cu", "fused3w_blend"),
                       ("fused.cu", "fused_v1_blend2"),
                       ("fused.cu", "fused_v1_blend3")):
        sig = re.search(rf"\nint {entry}\(([^)]*)\)",
                        (build.CSRC / src).read_text()).group(1)
        args = [a.split()[-1].strip("*") for a in sig.split(",")]
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry
        layout = args[args.index("q") + 1:args.index("kernel")]
        assert layout == ["width", "groups", "cell_lanes", "threads",
                          "planar"], entry
        geom = v1.blend_geometry(3, 50, 4, 100, (16,) * 3)
        assert len(geom.args()) == len(layout)
