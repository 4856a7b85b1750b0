"""PyTorch port, the binned per-cell route: part 3 of the tests of
tests/test_torch_port_percell.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import coords as jcoords
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import percell, route, slab
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_percell import C, F64, N_CELL, Q, SHAPE, _data


@pytest.mark.parametrize("kw", [
    dict(), dict(padding_mode="reflection"),
    dict(padding_mode="border", align_corners=False, multicell=False)])
@pytest.mark.parametrize("per_cell", [True, False], ids=["per-cell",
                                                         "shared"])
def test_plan_invariants_and_keys(kw, per_cell):
    """Every pair sits in exactly one slot, each cell's pairs in that
    cell's slots; the starts are monotone from 0 to N*Q and the slots run
    through the (cell, key) keys in order; the pairs of one key keep their
    query order (a stable sort); and each pair's key is (cell, z key, y
    key) of its floor corner on the JAX package's compute_source_coords
    with the cell's own shift, clamped to the cell's rows, for keys of 3 z
    rows by 5 y rows (the JAX route's (cell, z row) bins, cut into y
    bands) and by default a key a (z row, y row)."""
    cells, grid, _ = _data(3, per_cell, -1.7, 1.7)
    tcfg, jcfg = TConfig(dim=3, **kw), JConfig(dim=3, **kw)
    assert percell.key_grid(*SHAPE[:2]) == (1, 1)
    plan = percell.make_plan(torch.from_numpy(grid), cells.shape, tcfg,
                             keys=(3, 5))
    rows = percell.make_plan(torch.from_numpy(grid), cells.shape, tcfg)
    assert (rows.kz, rows.ky) == (1, 1)
    perm = plan.perm.numpy().astype(np.int64)
    starts = plan.starts.numpy().astype(np.int64)
    pairs = N_CELL * Q
    d, h = SHAPE[:2]
    tiles = -(-d // 3) * -(-h // 5)
    assert plan.perm.dtype == plan.starts.dtype == torch.int32
    assert perm.shape == (pairs,) and starts.shape == (N_CELL * tiles + 1,)
    assert rows.starts.shape == (N_CELL * d * h + 1,)
    assert (plan.n, plan.q, plan.kz, plan.ky) == (N_CELL, Q, 3, 5)
    np.testing.assert_array_equal(np.sort(perm), np.arange(pairs))
    np.testing.assert_array_equal(perm // Q, np.repeat(np.arange(N_CELL), Q))
    assert starts[0] == 0 and starts[-1] == pairs
    assert np.all(np.diff(starts) >= 0)

    offsets = jcoords.multicell_offsets(N_CELL, jcfg.multicell, jnp.float32)

    def floor(axis, size):
        base, _ = jcoords.compute_source_coords(
            jnp.asarray(grid[:, :, 0, axis]), size, jcfg.padding_mode,
            jcfg.align_corners, jcfg.multicell, offsets[:, None],
            strict=jcfg.strict_reference)
        fz = np.floor(np.asarray(base)).astype(np.int64)
        return np.clip(np.broadcast_to(fz, (N_CELL, Q)), 0, size - 1)

    tile = floor(2, d) // 3 * -(-h // 5) + floor(1, h) // 5
    key = (np.arange(N_CELL)[:, None] * tiles + tile).reshape(-1)
    slot_key = np.repeat(np.arange(N_CELL * tiles), np.diff(starts))
    np.testing.assert_array_equal(key[perm], slot_key)
    same_key = np.diff(slot_key) == 0
    assert np.all(np.diff(perm)[same_key] > 0)
    row = floor(2, d) * h + floor(1, h)
    key = (np.arange(N_CELL)[:, None] * d * h + row).reshape(-1)
    slot_key = np.repeat(np.arange(N_CELL * d * h),
                         np.diff(rows.starts.numpy().astype(np.int64)))
    rperm = rows.perm.numpy().astype(np.int64)
    np.testing.assert_array_equal(key[rperm], slot_key)
    assert np.all(np.diff(rperm)[np.diff(slot_key) == 0] > 0)


def test_grid_plans_never_serve_a_stale_plan():
    """GridPlans reuses its plan for the same grid only: another grid, the
    same grid changed in place and another cell shape or config each get
    a plan built anew, equal to make_plan's (a key a (z row, y row), so
    that a cell has many)."""
    assert percell.key_grid(*SHAPE[:2]) == (1, 1)
    cfg = TConfig(dim=3)
    _, a, _ = _data(4)
    _, b, _ = _data(5)
    ga, gb = torch.from_numpy(a), torch.from_numpy(b)
    shape = (N_CELL, C, *SHAPE)
    plans = route.GridPlans()
    first = plans.percell(ga, shape, cfg)
    assert plans.percell(ga, shape, cfg) is first and plans.builds == 1

    def fresh(grid, shp=shape, c=cfg):
        got = plans.percell(grid, shp, c)
        want = percell.make_plan(grid, shp, c)
        assert torch.equal(got.perm, want.perm)
        return got

    assert not torch.equal(fresh(gb).perm, first.perm)
    assert plans.builds == 2
    fresh(ga)
    ga[0, :5, 0, 2] = -ga[0, :5, 0, 2]       # in place: same storage
    fresh(ga)
    fresh(ga, shp=(N_CELL, C, 12, 16, 24))
    fresh(ga, c=TConfig(dim=3, padding_mode="reflection"))
    assert plans.builds == 6


def test_rule_routes_by_cell_stack_and_pairs():
    """The measured rule (PERF.md section 4): over a stack larger than L2,
    slab with 2^18 pairs or more wherever two rows of one channel fit a
    block's shared memory (the nested 128^3 trainer's 1.6 M pairs, 64 KB
    to 524 KB cells, the 2D volume), percell for 3D cells whose rows do
    not (256^2 and 192^2 planes) at a pair or more for every 128 texels;
    each bound pinned on both sides: 2^18 and 131 072 pairs, 131 072 and
    131 071 pairs on 8 x 4 x 32 x 256^2, 442 368 and 442 367 on 8 x 4 x
    192^3, a stack just over and just under L2; blend_o / splat_o
    elsewhere: the 16^3 main path's stack, the per-cell surface's 16 384
    pairs, more cells than slab takes, 2D rows too wide for slab, and a
    leading axis deeper than the bins' shared-memory histogram takes
    (pinned on both sides)."""
    cfg3, cfg2 = TConfig(dim=3), TConfig(dim=2)
    vol = (16, 4, 128, 128, 128)
    for pairs in (16 * 100_000, 1 << 20, 1 << 18):
        assert route.rule(cfg3, vol, pairs) == "slab"
    assert route.rule(cfg3, vol, 131_072) == "blend_o"
    for shape in ((1024, 4, 16, 16, 16), (512, 4, 24, 24, 24),
                  (128, 4, 32, 32, 32), (16, 4, 64, 64, 64)):
        assert route.rule(cfg3, shape, 1 << 18) == "slab"
        assert route.rule(cfg3, shape, (1 << 18) - 1) == "blend_o"
    wide = (8, 4, 32, 256, 256)
    assert route.rule(cfg3, wide, 1 << 20) == "percell"
    assert route.rule(cfg3, wide, 131_072) == "percell"
    assert route.rule(cfg3, wide, 131_071) == "blend_o"
    assert route.rule(cfg3, wide, 65_536) == "blend_o"
    cube = (8, 4, 192, 192, 192)
    assert route.rule(cfg3, cube, 8 * 100_000) == "percell"
    assert route.rule(cfg3, cube, 442_368) == "percell"
    assert route.rule(cfg3, cube, 442_367) == "blend_o"
    assert route.rule(cfg3, cube, 1 << 18) == "blend_o"
    # a stack of 50 MB stays in L2: blend_o; one just over it: slab
    assert route.rule(cfg3, (762, 4, 16, 16, 16), 1 << 20) == "blend_o"
    assert route.rule(cfg3, (763, 4, 16, 16, 16), 1 << 20) == "slab"
    for shape, pairs in (((50, 4, 16, 16, 16), 50 * 100_000),
                         ((16, 4, 32, 32, 32), 16 * 100_000),
                         ((4, 4, 128, 128, 128), 4 * 4096),
                         ((70_000, 4, 16, 16, 16), 70_000 * 16)):
        assert route.rule(cfg3, shape, pairs) == "blend_o"
    assert route.rule(cfg2, (4, 4, 1024, 1024), 1 << 18) == "slab"
    assert route.rule(cfg2, (4, 4, 1024, 1024), 65_536) == "blend_o"
    assert route.rule(cfg2, (16, 4, 2048, 2048), 1 << 24) == "slab"
    assert route.rule(cfg2, (16, 1, 64, 40_000), 1 << 20) == "blend_o"
    assert slab.BIN_MAX_DEPTH == 58_112
    assert route.rule(cfg2, (4, 1, 58_112, 64), 1 << 20) == "slab"
    assert route.rule(cfg2, (4, 1, 58_113, 64), 1 << 20) == "blend_o"


def test_pick_takes_blend_o_off_cuda_f32():
    """CPU tensors and non-f32 CUDA-bound calls take the blend_o wrapper,
    which computes the plain version on the CPU and raises otherwise."""
    cfg = TConfig(dim=3)
    shape = (16, 4, 128, 128, 128)
    for dtype in (torch.float32, F64):
        x = torch.zeros((1,), dtype=dtype)
        assert route.pick(cfg, shape, x, x) == "blend_o"
    meta = torch.empty((1, 5, 1, 3), device="meta")
    assert route.pick(cfg, shape, meta, meta) == "blend_o"
