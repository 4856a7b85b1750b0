"""PyTorch port, the megakernel step: plain_mega2w_step (the oracle of the
mega2w CUDA kernel), value_and_grad_mega, the megakernel train step and
the trainer, held to torch.autograd in f64 and to the JAX package in f32.

On the CPU the wrapper takes the plain version; the kernel itself is
compared with it on the card by chip_smoke.py.

The tests are split over this file and tests/test_torch_port_mega_2.py
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
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops.cuda import mega2w
from cosinesampler_tpu_torch.utils.convert import (params_from_numpy,
                                                   params_to_numpy)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(n_cells=4, cell_dim=3, cell_size=8, hidden=8)
MLP = ("w1", "b1", "w2", "b2")


def _np_params(seed, **kw):
    """JAX's init_params as NumPy, so both packages start from one set."""
    jparams = jpinn.init_params(jax.random.PRNGKey(seed),
                                jpinn.PINNConfig(**kw))
    return {k: np.asarray(v) for k, v in jparams.items()}


def _points(seed, q, dim=2, lo=-1.1, hi=1.1):
    return np.random.RandomState(seed).uniform(lo, hi, (q, dim))


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0 in f32."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _autograd(params, pts, cfg):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = tpinn.loss_fused_slots(leaves, pts, cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves.items()}


def _plain(params, pts, cfg):
    return mega2w.plain_mega2w_step(
        params["cells"], *(params[k] for k in MLP), pts, cfg.sampler, cfg.pde)


CASES = [dict(pde=pde, padding_mode=pad)
         for pde in ("allen_cahn", "helmholtz")
         for pad in ("zeros", "border", "reflection")] + [
    dict(kernel="linear", multicell=False),
    dict(kernel="smoothstep", align_corners=False, padding_mode="border")]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_plain_mega_matches_autograd_f64(kw):
    """The hand-derived MLP and residual backward equals torch.autograd of
    loss_fused_slots in f64: loss and every leaf at rtol 1e-10."""
    cfg = tpinn.PINNConfig(**KW, **kw)
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in _np_params(0, **KW).items()}
    pts = torch.tensor(_points(1, 300))
    want_loss, want = _autograd(params, pts, cfg)
    loss, grads = _plain(params, pts, cfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-10)
    assert set(grads) == set(want)
    for k in want:
        assert grads[k].shape == want[k].shape and not grads[k].requires_grad
        _close(grads[k].numpy(), want[k].numpy(), 1e-10)


@pytest.mark.parametrize("kw", [dict(), dict(pde="helmholtz",
                                             padding_mode="reflection")],
                         ids=["main-path", "helmholtz-reflection"])
def test_plain_mega_matches_jax_value_and_grad(kw):
    """plain_mega2w_step against jax.value_and_grad(loss_fused_slots) on
    the XLA path in f32: loss at rtol 1e-5, every leaf at rtol 1e-4."""
    cfg_kw = dict(KW, **kw)
    np_params = _np_params(2, **KW)
    pts = _points(3, 512).astype(np.float32)
    jcfg = jpinn.PINNConfig(backend="xla", **cfg_kw)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused_slots),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    loss, grads = _plain(params_from_numpy(np_params, "cpu"),
                         torch.from_numpy(pts), tpinn.PINNConfig(**cfg_kw))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k in want:
        _close(grads[k].numpy(), want[k], 1e-4)


def _adam_step(np_params, pts, cfg, **step_kw):
    params = params_from_numpy(np_params, "cpu")
    step = tpinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), **step_kw)
    args = (params, torch.from_numpy(pts)) + (
        (None,) if step_kw.get("megakernel") or step_kw.get("planned")
        else ())
    return float(step(*args)), params_to_numpy(params)
