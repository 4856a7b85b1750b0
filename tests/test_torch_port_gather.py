"""PyTorch port, the host side of the shared 3D forward gather
(csrc/texel_gather.cuh) of fused3b_blend and fused3s_blend, and the layout
move between the cells and the texel-major volume: the launch layouts of
``ops/cuda/gather.py`` at every shape chip_smoke.py runs, a Python mirror
of the gather's lane walk and warp shuffles, that walk in f64 against the
plain versions, the layout move's autograd Function, the ctypes
declarations of the C entry points, and the planned op against the JAX
package.

The kernels themselves run on the card only (chip_smoke.py holds them to
their plain versions there).  ``_lane_items`` mirrors the kernel's index
math: the warps' rounds over the compacted queries, each lane's cells and
channel units, and the shuffles that add a query's cell lanes into its
first.
"""

import ctypes
import itertools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.coords import multicell_offsets
from cosinesampler_tpu_torch.ops.cuda import build, fused3b, fused3s, gather
from cosinesampler_tpu_torch.ops.cuda.fused2w import (all_orders,
                                                      plain_fused_blend)
from cosinesampler_tpu_torch.ops.generic import (corner_index_weight,
                                                 per_axis_tables)
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64

# (N, C) of chip_smoke.py's fused3b_blend and fused3s_blend calls: config
# 5 and the gather sweep's cells and channels, the variants, channel
# counts and wide volumes, the 3D sweep's stacks, and the lane cases (N
# in {1, 3, 6, 50} x C in {1, 3, 8, 16})
SHAPES = sorted({
    (16, 4), (6, 1), (6, 3), (6, 4), (6, 8), (6, 9), (6, 12), (6, 16),
    (5, 3), (2, 2), (8, 4), (16, 2), (16, 3), (4, 4), (50, 4), (16, 16),
    *itertools.product((1, 3, 16, 50), (4, 8, 12, 16)),
    *itertools.product((1, 3, 6, 50), (1, 3, 8, 16))})


def _lane_items(geom, n, c, count, by, planar=False):
    """Per warp round: {lane: [(query, cell, channel), ...]} of what each
    lane of the blocks in grid row ``by`` adds for ``count`` compacted
    queries, and the lanes that store (cell lane 0), as
    texel_gather.cuh's gather_block walks them (``planar``: the cells read
    in place, a channel a load)."""
    lanes = geom.lanes
    qpw = 32 // lanes
    nwarps = geom.threads // 32
    unit = 4 if geom.vec(c) and not planar else 1
    cblk = by * geom.groups * geom.width
    cb = min(geom.groups * geom.width, c - cblk) // unit
    rounds = []
    for warp in range(nwarps):
        for j0 in range(warp * qpw, count, nwarps * qpw):
            items, stores = {}, set()
            for lane in range(32):
                qo, sub = divmod(lane, lanes)
                j = j0 + qo
                if qo >= qpw or j >= count:
                    items[lane] = []
                    continue
                g, m = sub % geom.groups, sub // geom.groups
                items[lane] = [
                    (j, ni, cblk + u * unit + i)
                    for ni in range(m, n, geom.cell_lanes)
                    for u in range(g, cb, geom.groups)
                    if (u - g) // geom.groups < geom.width // unit
                    for i in range(unit)]
                if m == 0:
                    stores.add(lane)
            rounds.append((items, stores))
    return rounds


def _shuffled(items, geom):
    """Each lane's items after the shuffle tree: for off = lanes / 2 down
    to groups, lane l adds lane l + off's (__shfl_down_sync: a lane past
    31 reads its own value, which only idle lanes use)."""
    held = {lane: list(v) for lane, v in items.items()}
    off = geom.lanes // 2
    while off >= geom.groups:
        held = {lane: held[lane] + (held[lane + off] if lane + off < 32
                                    else held[lane])
                for lane in range(32)}
        off //= 2
    return held


def _stored(geom, n, c, count, planar=False):
    """(query, cell, channel) of every value the stores of all grid rows
    carry, after the shuffles."""
    out = []
    for by in range(geom.grid_y(c)):
        for items, stores in _lane_items(geom, n, c, count, by, planar):
            held = _shuffled(items, geom)
            for lane in stores:
                out += held[lane]
    return out


def _check_layout(geom, n, c, planar=False):
    assert 1 <= geom.width <= gather.MAX_WIDTH
    assert 1 <= geom.groups <= gather.MAX_GROUPS
    assert geom.cell_lanes & (geom.cell_lanes - 1) == 0
    assert geom.cell_lanes <= max(1, n) and geom.lanes <= 32
    assert geom.threads in (gather.QUERIES, gather.MAX_THREADS)
    assert not geom.vec(c) or geom.width % 4 == 0
    for count in (gather.QUERIES, 37, 1):
        hits = np.zeros((count, n, c), dtype=np.int64)
        for j, ni, ch in _stored(geom, n, c, count, planar):
            hits[j, ni, ch] += 1
        assert (hits == 1).all(), (geom, n, c, count)


def test_gather_layouts_store_every_cell_and_channel_once():
    """gather_geometry and every alternative the sweep times (for fused3s's
    table blocks and fused3b's plan blocks), at every (N, C) chip_smoke.py
    runs: after the shuffles, the storing lanes of a
    full, a ragged and a one-query block carry each (query, cell, channel)
    exactly once, at most 32 lanes a query, cell lanes a power of 2 and at
    most N, float4 loads only over whole quads, 128 or 256 threads (the
    kernels' two launch bounds); also the table blocks' rule reading the
    planar cells a channel a load."""
    for n, c in SHAPES:
        for bricked in (False, True):
            for geom in gather.gather_alternatives(n, c, bricked).values():
                _check_layout(geom, n, c)
        # fused3s's planar blend: the table blocks' rule, a channel a load
        _check_layout(gather.gather_geometry(n, c), n, c, planar=True)


def test_gather_geometry_rule():
    """fused3s's table blocks: at C = 4 two lanes a query over its cells
    2j and 2j + 1 (a sector of two 16-byte records); above 4 channels a
    multiple of 4, two lanes or more over a cell's quads, 8 channels a
    lane at most (C = 16: two lanes, 8 each, one pass over the volume),
    64 channels a block and the rest on the grid; scalar channels in
    groups of at most 8; lanes over cells until one lane set's channels
    of the cells fill a sector, at most N; 128 threads where a query
    takes one lane, 256 otherwise.  fused3b's plan blocks: a lane holds
    all of up to 8 channels (a thread a query at config 5), two lanes of
    8 interleaved channels at C = 16, two cell lanes from 32 (cell,
    channel lane) units a query, 128 threads up to two lanes a query.
    And where fused3s_blend reads the cells in place."""
    geom = gather.GatherGeometry
    assert gather.gather_geometry(16, 4) == geom(4, 1, 2, 256)
    assert gather.gather_geometry(1, 4) == geom(4, 1, 1, 128)
    assert gather.gather_geometry(16, 8) == geom(4, 2, 1, 256)
    assert gather.gather_geometry(16, 12) == geom(8, 2, 1, 256)
    wide = gather.gather_geometry(16, 16)
    assert wide == geom(8, 2, 1, 256) and wide.grid_y(16) == 1
    assert wide.vec(16)
    assert gather.gather_geometry(16, 64) == geom(8, 8, 1, 256)
    assert gather.gather_geometry(16, 124).grid_y(124) == 2
    assert gather.gather_geometry(16, 1) == geom(1, 1, 8, 256)
    assert gather.gather_geometry(3, 1) == geom(1, 1, 2, 256)
    assert gather.gather_geometry(16, 3) == geom(3, 1, 2, 256)
    assert gather.gather_geometry(6, 9) == geom(5, 2, 1, 256)
    assert not gather.gather_geometry(6, 9).vec(9)
    alts = gather.gather_alternatives(16, 16)
    assert alts["a thread a query"] == geom(8, 1, 1, 128)
    assert alts["a thread a query"].grid_y(16) == 2
    assert alts["a lane a quad"] == geom(4, 4, 1, 256)
    # plan blocks
    assert gather.gather_geometry(16, 4, bricked=True) == geom(4, 1, 1, 128)
    assert gather.gather_geometry(50, 4, bricked=True) == geom(4, 1, 2, 128)
    assert gather.gather_geometry(16, 8, bricked=True) == geom(8, 1, 1, 128)
    assert gather.gather_geometry(3, 16, bricked=True) == geom(8, 2, 1, 128)
    assert gather.gather_geometry(16, 16, bricked=True) == geom(8, 2, 2,
                                                                256)
    assert gather.gather_geometry(16, 12, bricked=True) == geom(8, 2, 2,
                                                                256)
    assert gather.gather_geometry(16, 9, bricked=True) == geom(5, 2, 2, 256)
    assert gather.gather_geometry(1, 124, bricked=True).grid_y(124) == 2
    # fused3s reads the cells in place below PLANAR_POINTS_PER_TEXEL
    # points a texel: at 100 000 points on 128^3, not at 200 000 nor on
    # the 64^3 stacks the route sends it
    assert fused3s.planar(100_000, (128, 128, 128))
    assert not fused3s.planar(200_000, (128, 128, 128))
    assert not fused3s.planar(49_152, (64, 64, 64))


def _gather_f64(vol, pts, cols_of_blocks, n, c, spatial, cfg, geom,
                qmajor, planar=False):
    """The rows the gather stores for the query columns of each block in
    ``cols_of_blocks`` (compacted, in order), in f64 through the plain
    corner tables, reading ``vol`` at the kernel's addresses: the
    texel-major (D, H, W, N, C) at (texel * N + cell) * C + channel, or
    where ``planar`` the cells (N, C, D, H, W) at (cell * C + channel) *
    texels + texel; (7, C, cols), or (cols, 7, C) transposed back where
    ``qmajor``."""
    qi, ni, ch = [], [], []
    for cols in cols_of_blocks:
        for j, cell, chan in _stored(geom, n, c, len(cols), planar):
            qi.append(cols[j])
            ni.append(cell)
            ch.append(chan)
    qi, ni, ch = (torch.tensor(v, dtype=torch.int64) for v in (qi, ni, ch))
    offs = multicell_offsets(n, cfg.multicell, F64, "cpu")[ni]
    flat = vol.reshape(-1)
    cols = pts.shape[0]
    out = torch.zeros((cols, 7, c) if qmajor else (7, c, cols), dtype=F64)
    texels = int(np.prod(spatial))
    for row, o in enumerate(all_orders(3)):
        tables = per_axis_tables(pts[qi], spatial, cfg, o, n, offset=offs)
        acc = torch.zeros(qi.shape, dtype=F64)
        for corner in itertools.product((0, 1), repeat=3):
            idx, wgt, ok = corner_index_weight(tables, corner, spatial, 3)
            texel = idx.clamp(0, texels - 1)
            src = ((ni * c + ch) * texels + texel if planar
                   else (texel * n + ni) * c + ch)
            acc = acc + torch.where(ok, wgt * flat[src], 0.0)
        if qmajor:
            out.index_put_((qi, torch.full_like(qi, row), ch), acc,
                           accumulate=True)
        else:
            out.index_put_((torch.full_like(qi, row), ch, qi), acc,
                           accumulate=True)
    return out.permute(1, 2, 0) if qmajor else out


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_fused3s_gather_matches_plain_fused_blend_f64(padding):
    """fused3s_blend's gather: zsort's blocks, the cells moved to the
    texel-major copy, the lanes' reads and shuffles into (Q, 7, C) rows
    transposed back, against plain_fused_blend in f64, at N = 6 and C =
    12 (8 channels a lane, interleaved quads), 9 (scalar, groups of 5 and
    4) and 4 (two cell lanes), and at 5 x 3 x 6^3 with a lane a query;
    and the planar blend (the cells read in place, a channel a load) with
    the rule's layout."""
    cfg = TConfig(dim=3, padding_mode=padding)
    rng = np.random.RandomState(3)
    thread = gather.GatherGeometry(3, 1, 1, 128)
    for n, c, spatial, q, extra in (
            (6, 12, (5, 6, 7), 300, gather.GatherGeometry(4, 3, 1, 256)),
            (6, 9, (5, 6, 7), 150, None),
            (6, 4, (5, 6, 7), 150, None),
            (5, 3, (6, 6, 6), 200, thread)):
        cells = torch.from_numpy(rng.standard_normal((n, c, *spatial)))
        pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (q, 3)))
        perm, table = fused3s.zsort(pts, spatial[0], cfg)
        blocks = [perm[f:f + k].tolist() for _, f, k in table.tolist() if k]
        want = plain_fused_blend(cells, pts, cfg)
        vol = fused3b.cells_to_vol(cells)
        for geom in (gather.gather_geometry(n, c), extra):
            if geom is None:
                continue
            got = _gather_f64(vol, pts, blocks, n, c, spatial, cfg, geom,
                              qmajor=True)
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
        got = _gather_f64(cells, pts, blocks, n, c, spatial, cfg,
                          gather.gather_geometry(n, c), qmajor=True,
                          planar=True)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_fused3b_gather_compacts_real_slots_f64():
    """fused3b_blend's blocks: each plan block's real slots (occ != 0)
    compacted in order, pad slots left to the kernel's zero fill, the
    lanes' reads into (7, C, QP) in f64 against plain_fused3b_blend_vol,
    at config 5's layout (N = 16, C = 4: a thread a query) and C = 16 (two
    lanes of 8 interleaved channels times two cell lanes) on 8^3 cells,
    reflection padding, and with the table blocks' layouts."""
    cfg = TConfig(dim=3, padding_mode="reflection")
    rng = np.random.RandomState(5)
    for n, c, spatial, q in ((16, 4, (8, 8, 8), 700), (16, 16, (8, 8, 8),
                                                       300)):
        pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (q, 3)))
        plan = tfused.make_vol_plan(pts, (n, c, *spatial), cfg)
        occ = plan[1]
        vol = torch.from_numpy(rng.standard_normal((*spatial, n, c)))
        blocks = [[s for s in range(b, b + fused3b.Q_BLOCK) if occ[s] != 0]
                  for b in range(0, occ.shape[0], fused3b.Q_BLOCK)]
        assert any(0 < len(b) < fused3b.Q_BLOCK for b in blocks)
        want = fused3b.plain_fused3b_blend_vol(vol, plan, cfg)
        for bricked in (True, False):
            got = _gather_f64(vol, plan[5], blocks, n, c, spatial, cfg,
                              gather.gather_geometry(n, c, bricked),
                              qmajor=False)
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_layout_move_is_the_permute_and_its_backward_the_other_way():
    """cells_to_vol / vol_to_cells on the CPU: the forward equals torch's
    permuted copy (a new tensor, also where the permute is already
    contiguous), gradcheck and gradgradcheck in f64 show the backward is
    the move the other way; the kernel's wrapper takes CUDA tensors
    only."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.standard_normal((3, 2, 4, 5, 6)))
    assert torch.equal(fused3b.cells_to_vol(x), x.permute(2, 3, 4, 0, 1))
    v = torch.from_numpy(rng.standard_normal((4, 5, 6, 3, 2)))
    assert torch.equal(fused3b.vol_to_cells(v), v.permute(3, 4, 0, 1, 2))
    one = torch.zeros((1, 1, 2, 2, 2))
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


def test_ctypes_declarations_match_the_gather_entry_points():
    """build._declare gives fused3b_blend, fused3s_blend and
    texel_transpose the pointer, int and float arguments of their C
    signatures, in order."""
    lib = _Lib()
    build._declare(lib)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for src, entry in (("fused3b.cu", "fused3b_blend"),
                       ("fused3s.cu", "fused3s_blend"),
                       ("fused3s.cu", "texel_transpose")):
        text = (build.CSRC / src).read_text()
        sig = re.search(rf"\nint {entry}\(([^)]*)\)", text).group(1)
        want = ["p" if "void*" in a else "f" if "float" in a else "i"
                for a in sig.split(",")]
        assert [kinds[t] for t in getattr(lib, entry).argtypes] == want, \
            entry


PKW = dict(dim=3, n_cells=5, cell_dim=3, cell_size=6, hidden=8,
           pde="helmholtz")
PQ = 120


def test_planned_op_loss_and_leaves_match_jax():
    """The planned op (loss_fused_slots with make_sample_plan's plan: the
    cells through cells_to_vol, fused3b, and the volume cotangent back
    through the layout move's backward) against the JAX package's
    loss_fused_slots on the same plan (its XLA route, the query rows
    placed in the plan's slots): loss at rtol 1e-5, every leaf at rtol
    1e-4 (f32)."""
    tcfg = tpinn.PINNConfig(**PKW)
    jcfg = jpinn.PINNConfig(backend="xla", **PKW)
    np_params = {k: v.detach().numpy() for k, v in tpinn.init_params(
        torch.Generator().manual_seed(11), tcfg, "cpu").items()}
    pts = np.random.RandomState(11).uniform(-0.3, 0.3, (PQ, 3)).astype(
        np.float32)
    tp = torch.from_numpy(pts)
    plan = tfused.make_sample_plan(tp, np_params["cells"].shape,
                                   tcfg.sampler)
    assert plan is not None
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused_slots),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg, tuple(jnp.asarray(a.numpy()) for a in plan))
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused_slots(params, tp, tcfg, plan)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(params[k].grad.numpy(), v, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(v).max()))
