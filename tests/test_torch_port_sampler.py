"""PyTorch port, the public sampler: the plain blend/splat at every order,
the any-order autograd pair (BlendO / SplatO), the API and its validation,
held to the JAX package on the same NumPy inputs.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and
tests/test_torch_port_sampler_2.py to _7.py (files of at most 10 tests,
which xdist's loadfile queue, ordered by test count, runs beside
tests/test_sharding.py rather than ahead of it); the helpers stay here.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cosinesampler_tpu as cst
import cosinesampler_tpu_torch as tst
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_CELL, C = 3, 2
# explicit everywhere: tests/test_torch_parity.py sets an f64 default dtype
# in every process that collects it
F32, F64 = torch.float32, torch.float64


def _spatial(dim):
    return (8, 8) if dim == 2 else (6, 6, 6)


def _data(dim, seed, q=40, lo=-0.95, hi=0.95, grid_batch=1,
          dtype=np.float64):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N_CELL, C, *_spatial(dim)).astype(dtype)
    lead = (1,) * (dim - 1)
    grid = rng.uniform(lo, hi, (grid_batch, *lead, q, dim)).astype(dtype)
    gout = rng.standard_normal((N_CELL, C, *lead, q)).astype(dtype)
    return cells, grid, gout


def _close(got, want, rtol, atol_scale=None):
    """rtol per element with an absolute floor of ``atol_scale`` (default
    rtol) times the largest magnitude, for entries that cancel to ~0."""
    want = np.asarray(want)
    scale = rtol if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


# --- plain blend / splat vs JAX generic, orders through 3 and beyond -------

ORDER_CASES = [
    (2, "cosine", "zeros", True, (3, 0)),
    (2, "cosine", "zeros", True, (0, 3)),
    (2, "cosine", "border", True, (2, 1)),
    (2, "cosine", "reflection", False, (1, 2)),
    (2, "cosine", "zeros", True, (4, 1)),
    (2, "smoothstep", "zeros", True, (3, 0)),
    (2, "smoothstep", "border", False, (1, 2)),
    (2, "linear", "reflection", True, (1, 1)),
    (3, "cosine", "zeros", True, (1, 1, 1)),
    (3, "cosine", "reflection", True, (0, 0, 3)),
    (3, "cosine", "border", False, (2, 1, 0)),
    (3, "smoothstep", "zeros", True, (0, 3, 0)),
    (3, "linear", "border", True, (1, 0, 1)),
]


def _check_plain_blend_splat_f64(dim, kernel, padding, multicell, orders,
                                 grid_batch):
    """The plain blend and splat of ``orders`` against the JAX package's
    generic ones at rtol 1e-10."""
    gb = 1 if grid_batch == "shared" else N_CELL
    cells, grid, gout = _data(dim, 0, lo=-1.3, hi=1.3, grid_batch=gb)
    kw = dict(dim=dim, kernel=kernel, padding_mode=padding,
              multicell=multicell)
    jcfg, tcfg = JConfig(backend="xla", **kw), TConfig(**kw)
    want = jgeneric.blend(jnp.asarray(cells), jnp.asarray(grid), jcfg, orders)
    got = tgeneric.blend(torch.tensor(cells), torch.tensor(grid), tcfg, orders)
    _close(got.numpy(), want, 1e-10)
    spatial = _spatial(dim)
    want_s = jgeneric.splat(jnp.asarray(gout), jnp.asarray(grid), spatial,
                            jcfg, orders)
    got_s = tgeneric.splat(torch.tensor(gout), torch.tensor(grid), spatial,
                           tcfg, orders)
    _close(got_s.numpy(), want_s, 1e-10)


@pytest.mark.parametrize("grid_batch", ["shared", "per-cell"])
@pytest.mark.parametrize("dim,kernel,padding,multicell,orders",
                         ORDER_CASES[:5])
def test_plain_blend_splat_match_jax_f64(dim, kernel, padding, multicell,
                                         orders, grid_batch):
    """ORDER_CASES[:5]; tests/test_torch_port_sampler_2.py and _3.py hold
    the rest (files of at most 10 tests)."""
    _check_plain_blend_splat_f64(dim, kernel, padding, multicell, orders,
                                 grid_batch)


# --- the autograd pair ------------------------------------------------------


def _u_torch(cells, pts, w, cfg):
    dim = cfg.dim
    grid = pts.reshape((1,) * dim + tuple(pts.shape))
    out = tst.sample(cells, grid, cfg).reshape(N_CELL, C, pts.shape[0])
    return torch.einsum("ncq,c->q", out, w)


def _u_jax(cells, pts, w, cfg):
    dim = cfg.dim
    grid = pts.reshape((1,) * dim + pts.shape)
    out = cst.sample(cells, grid, cfg).reshape(N_CELL, C, pts.shape[0])
    return jnp.einsum("ncq,c->q", out, w)


def _chain_jax(cells, pts, w, cfg, axis):
    def u_ax(c, p):
        return jax.grad(lambda pp: _u_jax(c, pp, w, cfg).sum())(p)[:, axis]

    def u_axax(c, p):
        return jax.grad(lambda pp: u_ax(c, pp).sum())(p)[:, axis]

    uxx_cell = jax.grad(lambda c: u_axax(c, pts).sum())(cells)
    return u_ax(cells, pts), u_axax(cells, pts), uxx_cell


def _chain_torch(cells, pts, w, cfg, axis):
    tc = torch.tensor(cells, requires_grad=True)
    tp = torch.tensor(pts, requires_grad=True)
    u = _u_torch(tc, tp, torch.tensor(w), cfg)
    (g1,) = torch.autograd.grad(u.sum(), tp, create_graph=True)
    (g2,) = torch.autograd.grad(g1[:, axis].sum(), tp, create_graph=True)
    (g3,) = torch.autograd.grad(g2[:, axis].sum(), tc)
    return (g1[:, axis].detach().numpy(), g2[:, axis].detach().numpy(),
            g3.numpy())


# --- against the Pallas v1 kernels, interpret mode, f32 ---------------------


# --- API, exports, validation -----------------------------------------------


_BAD = [
    ((2, 1, 4, 4), (2, 4, 4, 3)),      # grid last dim
    ((2, 1, 4, 4), (3, 4, 4, 2)),      # batch mismatch
    ((2, 1, 4), (2, 4, 4, 2)),         # input rank
    ((2, 1, 4, 4), (2, 4, 2)),         # grid rank
]


LINEAR_CASES = list(itertools.product((2, 3), ("zeros", "border",
                                              "reflection"), (True, False)))


def _check_linear_matches_grid_sample(dim, padding_mode, align_corners):
    """The reference's claim (README.md:26-27): linear without multicell is
    grid_sample, out-of-bounds queries included."""
    rng = np.random.RandomState(8)
    spatial = (9, 7) if dim == 2 else (5, 6, 7)
    cells = rng.rand(2, 3, *spatial)
    grid = rng.uniform(-1.6, 1.6, (2, *(3,) * (dim - 1), 16, dim))
    want = F.grid_sample(torch.tensor(cells), torch.tensor(grid),
                         mode="bilinear", padding_mode=padding_mode,
                         align_corners=align_corners)
    fn = tst.cosine_sampler_2d if dim == 2 else tst.cosine_sampler_3d
    got = fn(torch.tensor(cells), torch.tensor(grid), padding_mode,
             align_corners, "linear", False)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# --- wrappers ---------------------------------------------------------------
