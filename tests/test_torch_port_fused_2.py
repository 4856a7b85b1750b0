"""PyTorch port, the fused op: part 2 of the tests of
tests/test_torch_port_fused.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused import C, F32, H, N, Q, W, _data


def test_padded_identity_plan_matches_query_order():
    cells, pts, _ = _data(3)
    cfg = TConfig(dim=2)
    tc, tp = torch.tensor(cells), torch.tensor(pts)
    assert tfused.make_sample_plan(tp, tc.shape, cfg) is None
    out, occ, positions = tfused.sample_features_padded(tc, tp, cfg)
    ref = tfused.sample_features_with_derivs(tc, tp, cfg)
    torch.testing.assert_close(out[:, :, positions], ref, rtol=0, atol=0)
    assert occ.shape == (Q,) and bool((occ == 1).all())
    torch.testing.assert_close(positions, torch.arange(Q))
    with pytest.raises(ValueError):
        tfused.sample_features_padded(tc, tp, cfg, plan=(positions, occ))
    with pytest.raises(ValueError):
        tfused.make_sample_plan(tp[:, :1], tc.shape, cfg)


@pytest.mark.parametrize("kw", [dict(), dict(padding_mode="reflection",
                                             kernel="smoothstep")],
                         ids=["main-path", "reflection-smoothstep"])
def test_points_cotangent_matches_jax(kw):
    """The fused op's points cotangent (order-bumped blends) against
    jax.grad of the JAX fused op with respect to the points, f64, plain
    path on both sides."""
    cells, pts, g = (a.astype(np.float64) for a in _data(4, lo=-0.95,
                                                           hi=0.95))
    jcfg = JConfig(dim=2, backend="xla", **kw)
    want_dc, want_dp = jax.grad(
        lambda c, p: (jfused.sample_features_with_derivs(c, p, jcfg)
                      * jnp.asarray(g)).sum(), argnums=(0, 1))(
        jnp.asarray(cells), jnp.asarray(pts))
    tc = torch.tensor(cells, requires_grad=True)
    tp = torch.tensor(pts, requires_grad=True)
    out = tfused.sample_features_with_derivs(tc, tp, TConfig(dim=2, **kw))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), want_dp, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dp).max()))
    np.testing.assert_allclose(tc.grad.numpy(), want_dc, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dc).max()))
    # only the points: no cells cotangent is formed
    tp.grad = None
    out = tfused.sample_features_with_derivs(torch.tensor(cells), tp,
                                             TConfig(dim=2, **kw))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), want_dp, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dp).max()))


def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    cells, pts, g = _data(5)
    cfg = TConfig(dim=2, padding_mode="border")
    before = (fused2w.fused_blend.launches, fused2w.fused_bwd.launches)
    tc, tp, tg = torch.tensor(cells), torch.tensor(pts), torch.tensor(g)
    torch.testing.assert_close(fused2w.fused_blend(tc, tp, cfg),
                               fused2w.plain_fused_blend(tc, tp, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused2w.fused_bwd(tg, tp, (H, W), cfg, N),
                               fused2w.plain_fused_bwd(tg, tp, (H, W), cfg, N),
                               rtol=0, atol=0)
    assert (fused2w.fused_blend.launches, fused2w.fused_bwd.launches) == before


def test_backend_xla_takes_plain_path():
    cells, pts, _ = _data(6)
    tc, tp = torch.tensor(cells), torch.tensor(pts)
    got = tfused.sample_features_with_derivs(tc, tp, TConfig(dim=2,
                                                             backend="xla"))
    torch.testing.assert_close(got, fused2w.plain_fused_blend(
        tc, tp, TConfig(dim=2)), rtol=0, atol=0)


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) a meta tensor must raise, not take the plain version."""
    cells = torch.empty((N, C, H, W), dtype=F32, device="meta")
    pts = torch.empty((Q, 2), dtype=F32, device="meta")
    g = torch.empty((5, C, Q), dtype=F32, device="meta")
    cfg = TConfig(dim=2)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_blend(cells, pts, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_bwd(g, pts, (H, W), cfg, N)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_blend(cells, torch.zeros((Q, 2), dtype=F32), cfg)
