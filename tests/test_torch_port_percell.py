"""PyTorch port, the binned per-cell route of the public sampler: the pair
plan, the plain percell blend/splat (the CPU side of the percell
wrappers), the router, and the nested 3D slice through it, held to the
JAX package on the same NumPy inputs.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.ops import coords as jcoords
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import percell as jpercell
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops import sampler as tsampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import (blend_splat, percell, route,
                                              slab)
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX package's percell test shapes (tests/test_percell.py)
N_CELL, C, Q = 3, 2, 700
SHAPE = (20, 16, 24)
F64 = torch.float64


def _data(seed, per_cell=True, lo=-1.2, hi=1.2, dtype=np.float32):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N_CELL, C, *SHAPE).astype(dtype)
    grid = rng.uniform(lo, hi, (N_CELL if per_cell else 1, Q, 1, 3)
                       ).astype(dtype)
    g = rng.randn(N_CELL, C, Q, 1).astype(dtype)
    return cells, grid, g


def _oracle_close(got, want):
    """The JAX package's percell tolerance (tests/test_percell.py): rtol
    3e-4 and an absolute floor of 1e-5 of the field's largest magnitude,
    since derivative fields sum mult^order corner terms that cancel."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=1e-5 * scale)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# --- plain percell vs the Pallas percell kernels, interpret mode, f32 -------

# each order, padding and grid kind at least once
INTERPRET_CASES = [
    ("zeros", (0, 0, 0), True),
    ("border", (2, 0, 0), False),
    ("reflection", (0, 1, 1), True),
    ("reflection", (1, 0, 2), False),
]


@pytest.mark.parametrize("padding,orders,per_cell", INTERPRET_CASES)
def test_plain_percell_matches_pallas_interpret(padding, orders, per_cell):
    """plain_blend_percell / plain_splat_percell against the JAX package's
    percell kernels (interpret mode) on the same f32 inputs, per-cell and
    shared grids, at the JAX package's own tolerance."""
    cells, grid, g = _data(1, per_cell)
    jcfg = JConfig(dim=3, padding_mode=padding, backend="pallas")
    tcfg = TConfig(dim=3, padding_mode=padding)
    tgrid = torch.from_numpy(grid)
    plan = percell.make_plan(tgrid, cells.shape, tcfg)
    want = jpercell.pallas_blend_percell(jnp.asarray(cells),
                                         jnp.asarray(grid), jcfg, orders,
                                         interpret=True)
    got = percell.plain_blend_percell(torch.from_numpy(cells), tgrid, tcfg,
                                      orders, plan)
    _oracle_close(got.numpy(), want)
    want_s = jpercell.pallas_splat_percell(jnp.asarray(g), jnp.asarray(grid),
                                           SHAPE, jcfg, orders,
                                           interpret=True)
    got_s = percell.plain_splat_percell(torch.from_numpy(g), tgrid, SHAPE,
                                        tcfg, orders, plan)
    _oracle_close(got_s.numpy(), want_s)


# --- plain percell vs the port's generic, f64 -------------------------------

@pytest.mark.parametrize("per_cell", [True, False], ids=["per-cell",
                                                         "shared"])
@pytest.mark.parametrize("kw,orders", [
    (dict(), (0, 0, 0)),
    (dict(padding_mode="reflection"), (3, 0, 0)),
    (dict(padding_mode="border", multicell=False), (1, 1, 1)),
    (dict(kernel="smoothstep", align_corners=False), (0, 2, 1)),
    (dict(padding_mode="reflection", strict_reference=True,
          multicell=False), (0, 0, 2)),
])
def test_plain_percell_matches_generic_f64(kw, orders, per_cell):
    """Both plain versions against generic.blend / generic.splat in f64 at
    rtol 1e-10, points to +-1.7 (far out-of-bounds queries included)."""
    cells, grid, g = (torch.from_numpy(a) for a in _data(
        2, per_cell, -1.7, 1.7, np.float64))
    cfg = TConfig(dim=3, **kw)
    plan = percell.make_plan(grid, cells.shape, cfg)
    _close(percell.plain_blend_percell(cells, grid, cfg, orders, plan),
           tgeneric.blend(cells, grid, cfg, orders), 1e-10)
    _close(percell.plain_splat_percell(g, grid, SHAPE, cfg, orders, plan),
           tgeneric.splat(g, grid, SHAPE, cfg, orders), 1e-10)


# --- the pair plan ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(padding_mode="reflection"),
    dict(padding_mode="border", align_corners=False, multicell=False)])
@pytest.mark.parametrize("per_cell", [True, False], ids=["per-cell",
                                                         "shared"])
def test_plan_invariants_and_keys(kw, per_cell):
    """Every pair sits in exactly one slot, each cell's pairs in that
    cell's slots; the starts are monotone from 0 to N*Q and the slots run
    through the (cell, tile) keys in order; the pairs of one key keep their
    query order (a stable sort); and each pair's key is (cell, z tile, y
    band) of its floor corner on the JAX package's compute_source_coords
    with the cell's own shift, clamped to the cell's rows (the JAX route's
    (cell, z row) bins, cut into y bands)."""
    cells, grid, _ = _data(3, per_cell, -1.7, 1.7)
    tcfg, jcfg = TConfig(dim=3, **kw), JConfig(dim=3, **kw)
    plan = percell.make_plan(torch.from_numpy(grid), cells.shape, tcfg,
                             tile=(3, 5))
    perm = plan.perm.numpy().astype(np.int64)
    starts = plan.starts.numpy().astype(np.int64)
    pairs = N_CELL * Q
    d, h = SHAPE[:2]
    tiles = -(-d // 3) * -(-h // 5)
    assert plan.perm.dtype == plan.starts.dtype == torch.int32
    assert perm.shape == (pairs,) and starts.shape == (N_CELL * tiles + 1,)
    assert (plan.n, plan.q, plan.dz, plan.ty) == (N_CELL, Q, 3, 5)
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


def test_grid_plans_never_serve_a_stale_plan(monkeypatch):
    """GridPlans reuses its plan for the same grid only: another grid, the
    same grid changed in place and another cell shape or config each get
    a plan built anew, equal to make_plan's (tiles of a small shared-memory
    budget, so that a cell has many)."""
    monkeypatch.setattr(percell, "TILE_BYTES", 2000)
    assert percell.geometry(C, SHAPE) == (2, 2)
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


# --- the router ---------------------------------------------------------------

def test_rule_routes_by_cell_stack_and_pairs():
    """The measured rule (PERF.md section 4): over a stack larger than L2
    with 2^18 pairs or more, slab wherever two rows of one channel fit a
    block's shared memory (the nested 128^3 trainer's 1.6 M pairs, 64 KB
    to 524 KB cells, the 2D volume), percell for 3D cells whose rows do
    not (256^2 planes); each bound pinned on both sides: 2^18 and 131 072
    pairs, a stack just over and just under L2; blend_o / splat_o
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
    assert route.rule(cfg3, wide, 65_536) == "blend_o"
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


@pytest.mark.parametrize("name", ["blend_o", "percell", "slab"])
def test_router_dispatches_to_the_picked_route(monkeypatch, name):
    """route.blend / route.splat call the wrapper of the route pick gives,
    with the chain's plan for percell."""
    calls = []

    def record(tag):
        return lambda *args, **kw: calls.append((tag, args, kw))

    monkeypatch.setattr(route, "pick", lambda *args: name)
    for mod, tag in ((blend_splat, "blend_o"), (percell, "percell"),
                     (slab, "slab")):
        monkeypatch.setattr(mod, "blend", record(tag))
        monkeypatch.setattr(mod, "splat", record(tag))
    cells, grid, g = (torch.from_numpy(a) for a in _data(6))
    cfg = TConfig(dim=3)
    plans = route.GridPlans()
    route.blend(cells, grid, cfg, (0, 0, 0), plans)
    route.splat(g, grid, SHAPE, cfg, (1, 0, 0), plans)
    assert [tag for tag, _, _ in calls] == [name, name]
    if name == "percell":
        assert plans.builds == 1
        assert calls[0][1][-1] is calls[1][1][-1]   # one plan for both


# --- the nested 3D slice through the forced routes ----------------------------

KW3 = dict(dim=3, n_cells=4, cell_size=6, hidden=8, pde="helmholtz")


@pytest.fixture(scope="module")
def nested_reference():
    """jax.value_and_grad of the JAX package's nested pinn.loss through its
    plain reference (backend="xla"), f32, on the weights and points the
    port gets too."""
    jcfg = jpinn.PINNConfig(**KW3, backend="xla")
    jparams = jpinn.init_params(jax.random.PRNGKey(11), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    pts = tpointgen.PointGenerator(256, 3, seed=11,
                                   force_numpy=True).batch(0)
    loss, grads = jax.value_and_grad(jpinn.loss)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    return np_params, pts, float(loss), {k: np.asarray(v)
                                         for k, v in grads.items()}


@pytest.mark.parametrize("name", ["percell", "slab"])
def test_nested_slice_through_forced_route_matches_jax(monkeypatch, name,
                                                       nested_reference):
    """The nested 3D Helmholtz loss (third-order dloss/dcells) with every
    sampler launch routed to ``name`` (the plain versions on the CPU; slab
    with a small shared-memory budget, so 6 slabs of 2 channels in the
    blend), against jax.value_and_grad: loss at rtol 1e-5, every gradient
    leaf at rtol 1e-4.  One nested step builds one percell plan or one
    set of slab bins."""
    np_params, pts, want_loss, want_grads = nested_reference
    monkeypatch.setattr(route, "pick", lambda *args: name)
    monkeypatch.setattr(slab, "SMEM_BYTES", 600)
    assert slab.geometry(4, (6, 6, 6), 1) == (1, 2)
    builds = {"percell": [], "slab": []}
    make_plan, make_bins = percell.make_plan, slab.make_bins
    monkeypatch.setattr(percell, "make_plan", lambda *a, **k: builds[
        "percell"].append(1) or make_plan(*a, **k))
    monkeypatch.setattr(slab, "make_bins", lambda *a, **k: builds[
        "slab"].append(1) or make_bins(*a, **k))
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss(params, torch.from_numpy(pts), tpinn.PINNConfig(**KW3))
    loss.backward()
    assert {k: len(v) for k, v in builds.items()} == {
        "percell": int(name == "percell"), "slab": int(name == "slab")}
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert set(params) == set(want_grads)
    for k, p in params.items():
        _close(p.grad.numpy(), want_grads[k], 1e-4)


def _u_jax(cells, grid, w, cfg):
    out = jgeneric.blend(cells, grid, cfg, (0, 0, 0))
    return jnp.einsum("ncq,c->nq", out.reshape(*out.shape[:2], -1), w)


@functools.partial(jax.jit, static_argnums=(3, 4))
def chain_jax(cells, grid, w, cfg, axis):
    """u_ax, u_axax (per pair) and u_axax_cell by nested jax.grad over a
    per-cell grid (N, Q, 1, 1, 3), jitted whole (3x faster than eager)."""
    def u_ax(c, g):
        return jax.grad(lambda gg: _u_jax(c, gg, w, cfg).sum())(g)[..., axis]

    def u_axax(c, g):
        return jax.grad(lambda gg: u_ax(c, gg).sum())(g)[..., axis]

    cell = jax.grad(lambda c: u_axax(c, grid).sum())(cells)
    return u_ax(cells, grid), u_axax(cells, grid), cell


def chain_torch(cells, grid, w, cfg, axis):
    tc = torch.tensor(cells, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    out = tsampler.sample(tc, tg, cfg)
    u = torch.einsum("ncq,c->nq", out.reshape(*out.shape[:2], -1),
                     torch.tensor(w))
    (g1,) = torch.autograd.grad(u.sum(), tg, create_graph=True)
    (g2,) = torch.autograd.grad(g1[..., axis].sum(), tg, create_graph=True)
    (g3,) = torch.autograd.grad(g2[..., axis].sum(), tc)
    return (g1[..., axis].detach().numpy(), g2[..., axis].detach().numpy(),
            g3.numpy())


@pytest.mark.parametrize("name", ["percell", "slab"])
def test_per_cell_chain_through_forced_route_matches_jax(monkeypatch, name):
    """The per-cell surface's u_z -> u_zz -> u_zz_cell chain (per-cell
    grids) with every launch routed to ``name`` (slab on 1-row slabs of
    one channel) against nested jax.grad of the JAX package's
    generic.blend, f64, at rtol 1e-9."""
    monkeypatch.setattr(route, "pick", lambda *args: name)
    monkeypatch.setattr(slab, "SMEM_BYTES", 4000)
    assert slab.geometry(C, SHAPE, 1) == (1, 1)
    cells, grid, _ = _data(7, True, -1.1, 1.1, np.float64)
    grid = grid[:, :96, :, None]                 # (N, 96, 1, 1, 3)
    w = np.random.RandomState(8).rand(C)
    kw = dict(padding_mode="reflection")
    want = chain_jax(jnp.asarray(cells), jnp.asarray(grid), jnp.asarray(w),
                     JConfig(dim=3, backend="xla", **kw), 2)
    got = chain_torch(cells, grid, w, TConfig(dim=3, **kw), 2)
    for a, b, what in zip(got, want, ("u_z", "u_zz", "u_zz_cell")):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10, err_msg=what)
