"""PyTorch port, the fused kernels above 8 channels: fused2w's and
fused3w's channel groups and the wide megakernel (mega2w at C > 8), whose
plain versions (the CPU side of their wrappers) are held to the JAX
package at 12 and 16 channels, and route.fused_rule's bounds between
their groups and the v1 kernels.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and tests/test_torch_port_wide_2.py
(files of at most 10 tests, which xdist's loadfile queue, ordered by
test count, runs beside tests/test_sharding.py rather than ahead of it);
the helpers stay here.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w, fused3w, mega2w
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = torch.float32


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0 in f32."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("c", [12, 16])
@pytest.mark.parametrize("dim,kw", [
    (2, dict(padding_mode="zeros")),
    (2, dict(padding_mode="reflection", align_corners=False)),
    (3, dict(padding_mode="border")),
    (3, dict(kernel="smoothstep", multicell=False))],
    ids=["2d-zeros", "2d-reflection-align-false", "3d-border",
         "3d-smoothstep-no-multicell"])
def test_wide_fused_rows_match_jax(dim, kw, c):
    """fused2w's / fused3w's wrappers at C = 12 and 16 (the plain rows the
    channel-group kernels are held to) against the JAX fused op and its
    cells cotangent: rows at rtol 1e-5, the cotangent at rtol 1e-4, as
    tests/test_torch_port_fused.py holds fused2w at C = 3."""
    rng = np.random.RandomState(c + dim)
    n, spatial, q = 4, (6, 7) if dim == 2 else (5, 6, 4), 150
    cells = rng.rand(n, c, *spatial).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (q, dim)).astype(np.float32)
    g = rng.standard_normal((1 + 2 * dim, c, q)).astype(np.float32)
    jcfg, tcfg = JConfig(dim=dim, **kw), TConfig(dim=dim, **kw)
    want, vjp = jax.vjp(
        lambda x: jfused.sample_features_with_derivs(x, jnp.asarray(pts),
                                                     jcfg),
        jnp.asarray(cells))
    (want_dc,) = vjp(jnp.asarray(g))
    mod = fused2w if dim == 2 else fused3w
    got = mod.fused_blend(torch.from_numpy(cells), torch.from_numpy(pts),
                          tcfg)
    got_dc = mod.fused_bwd(torch.from_numpy(g), torch.from_numpy(pts),
                           spatial, tcfg, n)
    assert got.shape == (1 + 2 * dim, c, q) and got.dtype == F32
    _close(got.numpy(), want, 1e-5)
    _close(got_dc.numpy(), want_dc, 1e-4)


@pytest.mark.parametrize("c", [12, 16])
def test_value_and_grad_mega_at_wide_channels_takes_the_kernel(c,
                                                               monkeypatch):
    """value_and_grad_mega at C = 12 and 16 takes mega2w's route (on the
    CPU its plain version, plain_mega2w_step), not the autograd fallback,
    and matches jax.value_and_grad(loss_fused_slots): loss at rtol 1e-5,
    every leaf at rtol 1e-4."""
    kw = dict(n_cells=4, cell_dim=c, cell_size=8, hidden=8)
    cfg = tpinn.PINNConfig(**kw)
    assert tpinn.mega_available(cfg, 512)
    np_params = {k: np.asarray(v) for k, v in jpinn.init_params(
        jax.random.PRNGKey(c), jpinn.PINNConfig(**kw)).items()}
    pts = np.random.RandomState(c).uniform(-1.1, 1.1, (512, 2)).astype(
        np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused_slots),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jpinn.PINNConfig(backend="xla", **kw))
    calls = []
    plain = mega2w.plain_mega2w_step
    monkeypatch.setattr(mega2w, "plain_mega2w_step",
                        lambda *a: calls.append(1) or plain(*a))

    def no_fallback(*args):
        raise AssertionError("value_and_grad_mega fell back to autograd")
    monkeypatch.setattr(tpinn, "loss_fused_slots", no_fallback)
    loss, grads = tpinn.value_and_grad_mega(
        params_from_numpy(np_params, "cpu"), torch.from_numpy(pts), cfg)
    assert calls == [1]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(want)
    for k in want:
        _close(grads[k].numpy(), want[k], 1e-4)
