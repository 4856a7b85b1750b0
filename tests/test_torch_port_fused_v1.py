"""PyTorch port, the channel-looped v1 fused kernels (C > 8, 2D and 3D),
the small-cloud fused2d kernels, the routes of the calls no kernel takes,
and exact mode under any global matmul precision.

The plain versions of both kernel pairs are held to the JAX package's
Pallas kernels in interpret mode; the slice at C = 12 to
``jax.value_and_grad(pinn.loss_fused)``; the routes are pure functions of
shapes, dtypes and device type, tested here with shapes alone.  On the
CPU the kernel wrappers take their plain versions; chip_smoke.py holds the
CUDA kernels to those on the card.

The tests are split over this file and
tests/test_torch_port_fused_v1_2.py to _3.py (files of at most 10 tests,
which xdist's loadfile queue, ordered by test count, runs beside
tests/test_sharding.py rather than ahead of it); the helpers stay here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.fused import (pallas_fused_blend,
                                                pallas_fused_bwd)
from cosinesampler_tpu.ops.pallas.fused2d import (pallas_fused2_blend,
                                                  pallas_fused2_bwd)
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused as fused_v1
from cosinesampler_tpu_torch.ops.cuda import fused2d
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32, F64 = torch.float32, torch.float64
# Q off every block size: JAX's 2048 (2D) and 256 (3D) fused blocks, the
# fused2d kernel's 256
Q = 300


def _data(dim, n, c, spatial, seed, lo=-1.4, hi=1.4, q=Q):
    rng = np.random.RandomState(seed)
    cells = rng.rand(n, c, *spatial).astype(np.float32)
    pts = rng.uniform(lo, hi, (q, dim)).astype(np.float32)
    g = rng.standard_normal((1 + 2 * dim, c, q)).astype(np.float32)
    return cells, pts, g


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0 in f32."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _jax_pair(blend, bwd, cells, pts, g, cfg, n):
    """The JAX blend and bwd, jitted whole: one interpret-mode program."""
    spatial = tuple(cells.shape[2:])

    @jax.jit
    def run(c, p, gv):
        return blend(c, p, cfg, interpret=True), bwd(
            gv, p, spatial, cfg, n, interpret=True)

    return run(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(g))


# (dim, channels, padding mode): C off the 8-channel group width, every
# padding in 2D and 3D
V1_CASES = [(2, 9, "zeros"), (2, 12, "border"), (2, 9, "reflection"),
            (3, 12, "zeros"), (3, 9, "border"), (3, 12, "reflection")]


@pytest.mark.parametrize("dim,c,padding", V1_CASES,
                         ids=[f"{d}d-c{c}-{p}" for d, c, p in V1_CASES])
def test_plain_v1_pair_matches_pallas_fused_interpret(dim, c, padding):
    """The v1 plain pair against pallas_fused_blend / pallas_fused_bwd in
    interpret mode, points to +-1.4 (out-of-range corners), Q = 300: at the
    JAX package's own tolerance for them (tests/test_fused.py: rtol 3e-4,
    atol 1e-4; the TPU kernels use polynomial trig and split-bf16 MXU
    sums), the bwd's atol scaled by its largest magnitude."""
    spatial = (6, 7) if dim == 2 else (4, 5, 6)
    n = 3
    cells, pts, g = _data(dim, n, c, spatial, seed=c + dim)
    jcfg = JConfig(dim=dim, padding_mode=padding, backend="pallas")
    tcfg = TConfig(dim=dim, padding_mode=padding)
    want, want_b = _jax_pair(pallas_fused_blend, pallas_fused_bwd, cells, pts,
                             g, jcfg, n)
    tc, tp, tg = (torch.from_numpy(a) for a in (cells, pts, g))
    got = fused_v1.fused_blend(tc, tp, tcfg)
    got_b = fused_v1.fused_bwd(tg, tp, spatial, tcfg, n)
    assert got.shape == (1 + 2 * dim, c, Q) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


@pytest.mark.parametrize("padding,kernel,multicell", [
    ("zeros", "cosine", True), ("border", "smoothstep", False),
    ("reflection", "linear", True)])
def test_plain_fused2d_pair_matches_pallas_fused2_interpret(padding, kernel,
                                                            multicell):
    """The fused2d plain pair against pallas_fused2_blend /
    pallas_fused2_bwd in interpret mode on each padding mode of the JAX
    kernels (zeros, border, reflection), points to +-1.4, Q = 300 (two of
    the JAX kernel's 256-query blocks): rtol 3e-4, atol 1e-4 as the JAX
    package's tests/test_fused2d.py holds them."""
    n, c = 6, 4
    cells, pts, g = _data(2, n, c, (8, 8), seed=7)
    kw = dict(dim=2, padding_mode=padding, kernel=kernel, multicell=multicell)
    want, want_b = _jax_pair(pallas_fused2_blend, pallas_fused2_bwd, cells,
                             pts, g, JConfig(backend="pallas", **kw), n)
    tc, tp, tg = (torch.from_numpy(a) for a in (cells, pts, g))
    got = fused2d.fused_blend(tc, tp, TConfig(**kw))
    got_b = fused2d.fused_bwd(tg, tp, (8, 8), TConfig(**kw), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


# --- the slice at C = 12 -------------------------------------------------------

SLICE = {2: dict(n_cells=6, cell_dim=12, cell_size=8, hidden=16),
         3: dict(dim=3, n_cells=3, cell_dim=12, cell_size=6, hidden=8,
                 pde="helmholtz")}


# --- the routes -----------------------------------------------------------------


# --- exact mode -----------------------------------------------------------------

_MATMULS = {"mm", "bmm", "addmm", "addbmm", "baddbmm", "matmul", "mv",
            "addmv", "dot", "vdot", "linear"}


class _RecordMatmuls(TorchDispatchMode):
    """The dtypes of the tensors each matmul-family aten op gets, forward
    and backward."""

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in _MATMULS:
            self.dtypes.update(a.dtype for a in args
                               if isinstance(a, torch.Tensor))
        return func(*args, **(kwargs or {}))


def _loss_and_grads(loss, cfg, params, pts):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with _RecordMatmuls() as rec:
        lval = getattr(tpinn, loss)(leaves, pts, cfg)
        lval.backward()
    return (float(lval.detach()), {k: v.grad for k, v in leaves.items()},
            rec.dtypes)
