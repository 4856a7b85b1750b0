"""PyTorch port, the binned per-cell route of the public sampler: the pair
plan, the plain percell blend/splat (the CPU side of the percell
wrappers), the router, and the nested 3D slice through it, held to the
JAX package on the same NumPy inputs.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and
tests/test_torch_port_percell_2.py to _4.py (files of at most 10 tests,
which xdist's loadfile queue, ordered by test count, runs beside
tests/test_sharding.py rather than ahead of it); the helpers stay here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import percell as jpercell
from cosinesampler_tpu_torch.ops import sampler as tsampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import percell
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
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


# --- the pair plan ------------------------------------------------------------


# --- the router ---------------------------------------------------------------


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
