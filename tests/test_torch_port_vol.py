"""PyTorch port, the vol-resident 3D slice: the brick plan, trim_plan, the
kernel-layout volume, the plain fused3b ops (the CPU side of the fused3b
wrappers), the planned and vol-resident fused ops, and the vol-resident
trainer, held to the JAX package.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and tests/test_torch_port_vol_2.py to
_3.py (files of at most 10 tests, which xdist's loadfile queue, ordered
by test count, runs beside tests/test_sharding.py rather than ahead of
it); the helpers stay here.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import fused3b as jfused3b
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3b
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C, S, Q = 3, 2, (5, 7, 9), 200   # (D, H, W) = S


def _points(seed, q=Q, lo=-1.4, hi=1.4):
    return np.random.RandomState(seed).uniform(lo, hi, (q, 3))


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


PLAN_CASES = [
    (dict(padding_mode="zeros"), S, Q),
    (dict(padding_mode="border", align_corners=False), S, Q),
    (dict(padding_mode="reflection", multicell=False), S, Q),
    # Q * nbins * 4 > 64 MiB: the JAX package's comparison-sort branch
    (dict(padding_mode="zeros"), (64, 64, 64), 8192),
]


@pytest.mark.parametrize("kw,spatial,q", PLAN_CASES,
                         ids=["zeros", "border-align-false",
                              "reflection-no-multicell", "sort-branch-64^3"])
def test_make_plan_bit_equal_to_jax(kw, spatial, q):
    """All six arrays of the brick plan equal the JAX package's, points in
    [-1.7, 1.7] (far out-of-bounds queries are clipped into edge bins)."""
    pts = _points(1, q, -1.7, 1.7).astype(np.float32)
    want = jfused3b.make_plan(jnp.asarray(pts), spatial, JConfig(dim=3, **kw))
    got = fused3b.make_plan(torch.from_numpy(pts), spatial,
                            TConfig(dim=3, **kw))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("bucket", [None, 1])
def test_trim_plan_equal_to_jax(bucket):
    pts = _points(2).astype(np.float32)
    plan = fused3b.make_plan(torch.from_numpy(pts), S, TConfig(dim=3))
    got = tfused.trim_plan(plan, bucket)
    want = jfused.trim_plan(tuple(jnp.asarray(a.numpy()) for a in plan),
                            bucket)
    assert got[1].shape[0] < plan[1].shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tfused.trim_plan(None) is None


VKW = dict(dim=3, n_cells=5, cell_dim=3, cell_size=6, hidden=8,
           pde="helmholtz")
VQ = 120


def _vol_setup(seed):
    """JAX config, numpy params of the port's init_params (the JAX one
    compiles for seconds) and points."""
    jcfg = jpinn.PINNConfig(backend="pallas", **VKW)
    np_params = {k: v.detach().numpy() for k, v in tpinn.init_params(
        torch.Generator().manual_seed(seed), tpinn.PINNConfig(**VKW),
        "cpu").items()}
    pts = _points(seed, VQ, -0.3, 0.3).astype(np.float32)
    return jcfg, np_params, pts
