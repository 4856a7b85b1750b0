"""PyTorch port, fused op: the fused blend/bwd and its autograd Function,
held to the JAX package's fused op on the same NumPy inputs (f32).

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and tests/test_torch_port_fused_2.py
to _3.py (files of at most 10 tests, which xdist's loadfile queue,
ordered by test count, runs beside tests/test_sharding.py rather than
ahead of it); the helpers stay here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.fused2w import (pallas_fused2w_blend,
                                                  pallas_fused2w_bwd)
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C, H, W, Q = 5, 3, 6, 7, 150
# explicit everywhere: tests/test_torch_parity.py sets an f64 default dtype
# in every process that collects it
F32 = torch.float32

CONFIGS = [
    dict(kernel="cosine", padding_mode="zeros"),
    dict(kernel="cosine", padding_mode="border", align_corners=False),
    dict(kernel="cosine", padding_mode="reflection"),
    dict(kernel="linear", padding_mode="zeros", multicell=False),
    dict(kernel="smoothstep", padding_mode="reflection", multicell=False,
         align_corners=False),
    dict(kernel="smoothstep", padding_mode="border"),
]


def _data(seed, lo=-1.2, hi=1.2, spatial=(H, W)):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N, C, *spatial).astype(np.float32)
    pts = rng.uniform(lo, hi, (Q, 2)).astype(np.float32)
    g = rng.standard_normal((5, C, Q)).astype(np.float32)
    return cells, pts, g


def _close(got, want, rtol):
    """rtol against each element, with an absolute floor of rtol times the
    largest magnitude (elements that cancel to ~0 carry f32 noise)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_fused_op_and_cells_grad_match_jax(kw):
    """Features at rtol 1e-5 and the cells gradient at rtol 1e-4 (f32,
    different summation order), out-of-bounds queries included."""
    cells, pts, g = _data(0)
    jcfg, tcfg = JConfig(dim=2, **kw), TConfig(dim=2, **kw)
    want, vjp = jax.vjp(
        lambda c: jfused.sample_features_with_derivs(c, jnp.asarray(pts), jcfg),
        jnp.asarray(cells))
    (want_dc,) = vjp(jnp.asarray(g))

    tc = torch.tensor(cells, requires_grad=True)
    got = tfused.sample_features_with_derivs(tc, torch.tensor(pts), tcfg)
    (got * torch.tensor(g)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (5, C, Q)
    _close(got.detach().numpy(), want, 1e-5)
    _close(tc.grad.numpy(), want_dc, 1e-4)


@pytest.mark.parametrize("padding", ("zeros", "border", "reflection"))
def test_plain_fused_matches_pallas_fused2w_interpret(padding):
    """The plain versions against the TPU kernels themselves, run in
    interpret mode, at the tolerance of the JAX package's own fused2w
    tests (the TPU kernels use polynomial trig and split-bf16 MXU sums)."""
    cells, pts, g = _data(1, lo=-1.3, hi=1.3)
    pts, g = pts[:64], np.ascontiguousarray(g[..., :64])   # one query block
    jcfg = JConfig(dim=2, padding_mode=padding, backend="pallas")
    tcfg = TConfig(dim=2, padding_mode=padding)
    want = pallas_fused2w_blend(jnp.asarray(cells), jnp.asarray(pts), jcfg,
                                q_block=64, interpret=True)
    got = fused2w.plain_fused_blend(torch.tensor(cells), torch.tensor(pts),
                                    tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    want_b = pallas_fused2w_bwd(jnp.asarray(g), jnp.asarray(pts), (H, W), jcfg,
                                N, q_block=64, interpret=True)
    got_b = fused2w.plain_fused_bwd(torch.tensor(g), torch.tensor(pts), (H, W),
                                    tcfg, N)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


def test_plain_bwd_is_transpose_of_blend():
    """<blend(cells), g> == <cells, bwd(g)> in f64."""
    cells, pts, g = _data(2)
    cfg = TConfig(dim=2, padding_mode="reflection")
    c64, p64, g64 = (torch.tensor(a, dtype=torch.float64)
                     for a in (cells, pts, g))
    lhs = (fused2w.plain_fused_blend(c64, p64, cfg) * g64).sum()
    rhs = (c64 * fused2w.plain_fused_bwd(g64, p64, (H, W), cfg, N)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def _z(*shape, dtype=F32):
    return torch.zeros(shape, dtype=dtype)
