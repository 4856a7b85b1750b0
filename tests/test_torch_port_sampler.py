"""PyTorch port, the public sampler: the plain blend/splat at every order,
the any-order autograd pair (BlendO / SplatO), the API and its validation,
held to the JAX package on the same NumPy inputs.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cosinesampler_tpu as cst
import cosinesampler_tpu.ops.pallas as jpallas
import cosinesampler_tpu_torch as tst
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.kernels import pallas_blend, pallas_splat
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops import sampler as tsampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import blend_splat

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


@pytest.mark.parametrize("grid_batch", ["shared", "per-cell"])
@pytest.mark.parametrize("dim,kernel,padding,multicell,orders", ORDER_CASES)
def test_plain_blend_splat_match_jax_f64(dim, kernel, padding, multicell,
                                         orders, grid_batch):
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


# --- the autograd pair ------------------------------------------------------

@pytest.mark.parametrize("dim,orders,grid_batch", [
    (2, (0, 0), 1), (2, (1, 0), 2), (3, (0, 1, 0), 1)])
def test_blend_splat_gradcheck_and_gradgradcheck(dim, orders, grid_batch):
    """Finite differences against BlendO / SplatO in f64, first and second
    order, on inputs and grid (queries away from the texel ticks)."""
    rng = np.random.RandomState(1)
    spatial = (4, 5) if dim == 2 else (3, 4, 3)
    lead = (1,) * (dim - 1)
    q = 3 if dim == 2 else 2
    cells = torch.tensor(rng.rand(2, 1, *spatial), requires_grad=True)
    grid = torch.tensor(rng.uniform(-0.8, 0.8, (grid_batch, *lead, q, dim)),
                        requires_grad=True)
    gout = torch.tensor(rng.rand(2, 1, *lead, q), requires_grad=True)
    cfg = TConfig(dim=dim)

    def blend(c, g):
        return tsampler.BlendO.apply(c, g, cfg, orders)

    def splat(o, g):
        return tsampler.SplatO.apply(o, g, spatial, cfg, orders)

    assert torch.autograd.gradcheck(blend, (cells, grid))
    assert torch.autograd.gradgradcheck(blend, (cells, grid))
    assert torch.autograd.gradcheck(splat, (gout, grid))
    assert torch.autograd.gradgradcheck(splat, (gout, grid))


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


@pytest.mark.parametrize("dim,axis,kw", [
    (2, 0, dict()), (2, 1, dict(padding_mode="reflection")),
    (3, 0, dict()), (3, 2, dict(kernel="smoothstep", padding_mode="border",
                                multicell=False))])
def test_nested_chain_matches_jax_f64(dim, axis, kw):
    """u_ax, u_axax and u_axax_cell (third order) against the JAX package's
    nested jax.grad, at the JAX package's own chain tolerance."""
    cells, grid, _ = _data(dim, 2)
    pts = grid.reshape(-1, dim)
    w = np.random.RandomState(3).rand(C)
    want = _chain_jax(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(w),
                      JConfig(dim=dim, backend="xla", **kw), axis)
    got = _chain_torch(cells, pts, w, TConfig(dim=dim, **kw), axis)
    for a, b, name in zip(got, want, ("u_x", "u_xx", "u_xx_cell")):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10, err_msg=name)


# --- against the Pallas v1 kernels, interpret mode, f32 ---------------------

@pytest.mark.parametrize("dim,orders", [(2, (0, 0)), (2, (2, 1)),
                                        (3, (0, 0, 0)), (3, (1, 0, 2))])
def test_plain_blend_splat_match_pallas_interpret(dim, orders):
    cells, grid, gout = _data(dim, 4, q=64, lo=-1.3, hi=1.3,
                              grid_batch=N_CELL, dtype=np.float32)
    jcfg = JConfig(dim=dim, backend="pallas")
    tcfg = TConfig(dim=dim)
    want = pallas_blend(jnp.asarray(cells), jnp.asarray(grid), jcfg, orders,
                        q_block=64, interpret=True)
    got = blend_splat.blend(torch.tensor(cells), torch.tensor(grid), tcfg,
                            orders)
    _close(got.numpy(), want, 3e-4, 5e-5)
    spatial = _spatial(dim)
    want_s = pallas_splat(jnp.asarray(gout), jnp.asarray(grid), spatial, jcfg,
                          orders, q_block=64, interpret=True)
    got_s = blend_splat.splat(torch.tensor(gout), torch.tensor(grid), spatial,
                              tcfg, orders)
    _close(got_s.numpy(), want_s, 3e-4, 5e-5)


def test_nested_chain_matches_pallas_interpret(monkeypatch):
    """The third-order chain through the TPU kernels themselves (interpret
    mode) against the port's chain, both f32: u_x at the blend/splat
    tolerance, u_xx and u_xx_cell at the JAX package's third-order one."""
    monkeypatch.setattr(jpallas, "INTERPRET", True)
    cells, grid, _ = _data(2, 5, q=16, dtype=np.float32)
    pts = grid.reshape(-1, 2)
    w = np.random.RandomState(6).rand(C).astype(np.float32)
    want = _chain_jax(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(w),
                      JConfig(dim=2, backend="pallas"), 0)
    got = _chain_torch(cells, pts, w, TConfig(dim=2), 0)
    _close(got[0], want[0], 3e-4, 5e-5)
    _close(got[1], want[1], 5e-4)
    _close(got[2], want[2], 5e-4)


# --- API, exports, validation -----------------------------------------------

def test_exports_cover_the_jax_api():
    assert set(cst.__all__) <= set(tst.__all__)
    from cosinesampler_tpu import ops as jops
    from cosinesampler_tpu_torch import ops as tops
    assert set(jops.__all__) <= set(tops.__all__)


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_shims_match_jax(dim):
    cells, grid, _ = _data(dim, 7, grid_batch=N_CELL)
    args = ("border", False, "smooth-step", True)
    shim_j = cst.CosineSampler2d if dim == 2 else cst.CosineSampler3d
    shim_t = tst.CosineSampler2d if dim == 2 else tst.CosineSampler3d
    want = shim_j.apply(jnp.asarray(cells), jnp.asarray(grid), *args)
    got = shim_t.apply(torch.tensor(cells), torch.tensor(grid), *args)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want, 1e-10)
    fn = tst.cosine_sampler_2d if dim == 2 else tst.cosine_sampler_3d
    xla = fn(torch.tensor(cells), torch.tensor(grid), *args, backend="xla",
             precision="highest")
    torch.testing.assert_close(xla, got, rtol=0, atol=0)


_BAD = [
    ((2, 1, 4, 4), (2, 4, 4, 3)),      # grid last dim
    ((2, 1, 4, 4), (3, 4, 4, 2)),      # batch mismatch
    ((2, 1, 4), (2, 4, 4, 2)),         # input rank
    ((2, 1, 4, 4), (2, 4, 2)),         # grid rank
]


@pytest.mark.parametrize("in_shape,grid_shape", _BAD)
def test_validate_messages_equal_jax(in_shape, grid_shape):
    with pytest.raises(ValueError) as want:
        cst.sample(jnp.zeros(in_shape), jnp.zeros(grid_shape),
                   JConfig(dim=2, backend="xla"))
    with pytest.raises(ValueError) as got:
        tst.sample(torch.zeros(in_shape, dtype=F64),
                   torch.zeros(grid_shape, dtype=F64), TConfig(dim=2))
    assert str(got.value) == str(want.value)


def test_validate_message_3d_equal_jax():
    with pytest.raises(ValueError) as want:
        cst.cosine_sampler_3d(jnp.zeros((2, 1, 4, 4)),
                              jnp.zeros((2, 1, 4, 4, 3)))
    with pytest.raises(ValueError) as got:
        tst.cosine_sampler_3d(torch.zeros((2, 1, 4, 4), dtype=F64),
                              torch.zeros((2, 1, 4, 4, 3), dtype=F64))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dim,padding_mode,align_corners", list(
    itertools.product((2, 3), ("zeros", "border", "reflection"),
                      (True, False))))
def test_linear_no_multicell_matches_torch_grid_sample(dim, padding_mode,
                                                       align_corners):
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

def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    cells, grid, gout = _data(2, 9, dtype=np.float32)
    cfg = TConfig(dim=2, padding_mode="reflection")
    tc, tg, to = (torch.tensor(a) for a in (cells, grid, gout))
    before = (blend_splat.blend.launches, blend_splat.splat.launches)
    torch.testing.assert_close(blend_splat.blend(tc, tg, cfg, (1, 2)),
                               tgeneric.blend(tc, tg, cfg, (1, 2)),
                               rtol=0, atol=0)
    torch.testing.assert_close(blend_splat.splat(to, tg, (8, 8), cfg, (1, 2)),
                               tgeneric.splat(to, tg, (8, 8), cfg, (1, 2)),
                               rtol=0, atol=0)
    u = tst.sample(tc, tg, cfg)
    assert u.dtype == F32
    assert (blend_splat.blend.launches, blend_splat.splat.launches) == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) meta tensors must raise, not take the plain version."""
    cfg = TConfig(dim=2)
    cells = torch.empty((N_CELL, C, 8, 8), dtype=F32, device="meta")
    grid = torch.empty((1, 1, 16, 2), dtype=F32, device="meta")
    gout = torch.empty((N_CELL, C, 1, 16), dtype=F32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.blend(cells, grid, cfg, (0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.splat(gout, grid, (8, 8), cfg, (0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.blend(cells, torch.zeros((1, 1, 16, 2), dtype=F32), cfg,
                          (0, 0))


@pytest.mark.parametrize("tensor,exc,match", [
    (torch.zeros((2, 2), dtype=F64), TypeError, "backend='xla'"),
    (torch.zeros((2, 4), dtype=F32)[:, ::2], ValueError, "contiguous"),
])
def test_kernel_input_checks_reject(tensor, exc, match):
    with pytest.raises(exc, match=match):
        blend_splat._check_tensors(tensor)
