"""PyTorch port, the 3D fused op (fused3w): part 2 of the tests of
tests/test_torch_port_fused3d.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused3d import KW3, _close


@pytest.mark.parametrize("kw", [
    dict(dim=3),
    dict(dim=3, strict_reference=True, align_corners=False),
    dict(dim=3, precision="highest"),
])
def test_kernel_input_checks_accept_3d(kw):
    """The 3D kernels take every 3D config in f32; the strict-reference
    mixed alignment is a 2D quirk only."""
    fused2w.check_kernel_inputs(TConfig(**kw),
                                torch.zeros((2, 3), dtype=torch.float32))


def test_loss_fused_3d_and_grads_match_jax():
    """pinn.loss_fused in 3D (Helmholtz, the main path's settings) against
    jax.value_and_grad(pinn.loss_fused) in f32: loss at rtol 1e-5, every
    gradient leaf at rtol 1e-4."""
    jcfg = jpinn.PINNConfig(**KW3)
    jparams = jpinn.init_params(jax.random.PRNGKey(3), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    pts = np.random.RandomState(4).uniform(-1, 1, (256, 3)).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused),
                              static_argnums=2)(
        jparams, jnp.asarray(pts), jcfg)
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused(params, torch.from_numpy(pts),
                            tpinn.PINNConfig(**KW3))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k], 1e-4)


def test_train_fused_3d_on_cpu():
    """The default (fused) trainer in 3D: finite losses that fall, and its
    first loss is the nested trainer's."""
    losses = {}
    for fused in (True, False):
        cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW3), device="cpu",
                                 steps=3, batch_points=256, log_every=1,
                                 fused=fused)
        params, metrics = ttrain.train(cfg)
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        losses[fused] = [m["loss"] for m in metrics]
    assert losses[True][-1] < losses[True][0]
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-5)
