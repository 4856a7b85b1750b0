"""PyTorch port, the megakernel step (mega2w): part 2 of the tests of
tests/test_torch_port_mega.py, which holds their helpers. The tests are
split into files of at most 10, which xdist's loadfile queue (ordered by
test count) runs beside tests/test_sharding.py rather than ahead of it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cosinesampler_tpu.ops.pallas as jpallas
from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import mega2w
from cosinesampler_tpu_torch.utils.convert import (params_from_numpy,
                                                   params_to_numpy)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_mega import (KW, MLP, _adam_step, _autograd, _close,
                                  _np_params, _plain, _points)


def test_value_and_grad_mega_matches_jax_megakernel_interpret():
    """The port's megakernel step on the CPU against the JAX megakernel
    itself (Pallas interpret mode) at the smallest shape mega2w.supports
    admits, 4 x 2 x 8^2, hidden 8, Q = 2048: loss at rtol 1e-5, leaves at
    the JAX kernel's own tolerance against value_and_grad (rtol 2e-4,
    atol 2e-5: it uses an exp-based tanh and split-bf16 MXU sums)."""
    kw = dict(n_cells=4, cell_dim=2, cell_size=8, hidden=8)
    jcfg = jpinn.PINNConfig(backend="pallas", **kw)
    np_params = _np_params(4, **kw)
    pts = _points(5, 2048, lo=-0.97, hi=0.97).astype(np.float32)
    old = jpallas.INTERPRET
    jpallas.INTERPRET = True
    try:
        assert jpinn.mega_available(jcfg, 2048)
        want_loss, want = jpinn.value_and_grad_mega(
            {k: jnp.asarray(v) for k, v in np_params.items()},
            jnp.asarray(pts), jcfg)
    finally:
        jpallas.INTERPRET = old
    tcfg = tpinn.PINNConfig(**kw)
    assert tpinn.mega_available(tcfg, 2048)
    loss, grads = tpinn.value_and_grad_mega(
        params_from_numpy(np_params, "cpu"), torch.from_numpy(pts), tcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k], rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_mega_train_step_equals_planned_step():
    """One Adam step of make_train_step(megakernel=True) equals the planned
    (autograd) step leaf for leaf."""
    cfg = tpinn.PINNConfig(**KW)
    np_params = _np_params(6, **KW)
    pts = _points(7, 512).astype(np.float32)
    l1, p1 = _adam_step(np_params, pts, cfg, planned=True)
    l2, p2 = _adam_step(np_params, pts, cfg, megakernel=True)
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_three_mega_steps_match_optax():
    """Three megakernel steps against the JAX package's megakernel step
    (backend="xla": value_and_grad of loss_fused_slots) under optax.adam:
    losses at rtol 1e-5, params at rtol 1e-4."""
    jcfg = jpinn.PINNConfig(backend="xla", **KW)
    np_params = _np_params(8, **KW)
    opt = optax.adam(1e-3)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jstate = opt.init(jparams)
    jstep = jax.jit(jpinn.make_train_step(jcfg, opt, megakernel=True))
    params = params_from_numpy(np_params, "cpu")
    tstep = tpinn.make_train_step(
        tpinn.PINNConfig(**KW), torch.optim.Adam(params.values(), lr=1e-3),
        megakernel=True)
    for step in range(3):
        pts = _points(9 + step, 512).astype(np.float32)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(pts),
                                       None)
        tloss = tstep(params, torch.from_numpy(pts), None)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = params_to_numpy(params)
    for k in got:
        _close(got[k], jparams[k], 1e-4)


def test_train_megakernel_on_cpu():
    """train(megakernel=True) lowers the loss, and its first loss is the
    fused trainer's (same weights and points, same function)."""
    losses = {}
    for mega in (True, False):
        cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW), device="cpu",
                                 steps=4, batch_points=512, log_every=1,
                                 megakernel=mega)
        params, metrics = ttrain.train(cfg)
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        losses[mega] = [m["loss"] for m in metrics]
    assert losses[True][-1] < losses[True][0]
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-5)


def test_cli_megakernel(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--batch-points",
                        "256", "--n-cells", "4", "--megakernel"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2]
    assert np.isfinite(lines[0]["loss"])


def test_mega_available_gates():
    assert tpinn.mega_available(tpinn.PINNConfig(), 100_000)
    assert not tpinn.mega_available(tpinn.PINNConfig(dim=3,
                                                     pde="helmholtz"), 100_000)
    assert not tpinn.mega_available(tpinn.PINNConfig(backend="xla"), 100_000)
    assert not tpinn.mega_available(tpinn.PINNConfig(hidden=64), 100_000)
    # any C with C + 4 <= 128, as JAX's mega2w.supports
    assert tpinn.mega_available(tpinn.PINNConfig(cell_dim=16), 100_000)
    assert tpinn.mega_available(tpinn.PINNConfig(cell_dim=124), 100_000)
    assert not tpinn.mega_available(tpinn.PINNConfig(cell_dim=125), 100_000)
    assert not tpinn.mega_available(tpinn.PINNConfig(precision="bf16"),
                                    100_000)
    assert tfused.make_fused_mega(TConfig(dim=2), (96, 4, 16, 16), 100_000,
                                  "burgers", 16) is None


def test_mega_3d_falls_back_to_autograd():
    kw = dict(dim=3, n_cells=3, cell_dim=2, cell_size=6, hidden=8,
              pde="helmholtz")
    cfg = tpinn.PINNConfig(**kw)
    assert not tpinn.mega_available(cfg, 256)
    params = params_from_numpy(_np_params(10, **kw), "cpu")
    pts = torch.from_numpy(_points(11, 256, dim=3).astype(np.float32))
    want_loss, want = _autograd(params, pts, cfg)
    loss, grads = tpinn.value_and_grad_mega(params, pts, cfg)
    assert float(loss) == want_loss
    for k in want:
        torch.testing.assert_close(grads[k], want[k], rtol=0, atol=0)


def test_mega_plan_must_be_none():
    cfg = tpinn.PINNConfig(**KW)
    params = params_from_numpy(_np_params(12, **KW), "cpu")
    pts = torch.zeros((64, 2))
    step = tpinn.make_train_step(
        cfg, torch.optim.Adam(params.values()), megakernel=True)
    with pytest.raises(ValueError, match="plan"):
        step(params, pts, (pts,))
    with pytest.raises(ValueError, match="plan"):
        tpinn.value_and_grad_mega(params, pts, cfg, plan=(pts,))


def test_cpu_wrapper_takes_plain_version_and_non_cpu_never_falls_back():
    cfg = tpinn.PINNConfig(**KW)
    params = params_from_numpy(_np_params(13, **KW), "cpu")
    pts = torch.from_numpy(_points(14, 200).astype(np.float32))
    before = mega2w.mega2w_step.launches
    loss, grads = mega2w.mega2w_step(params["cells"].detach(),
                                     *(params[k].detach() for k in MLP), pts,
                                     cfg.sampler, cfg.pde)
    want_loss, want = _plain(params, pts, cfg)
    assert mega2w.mega2w_step.launches == before
    assert float(loss) == float(want_loss)
    for k in want:
        torch.testing.assert_close(grads[k], want[k], rtol=0, atol=0)
    meta = [torch.empty(p.shape, device="meta") for p in params.values()]
    with pytest.raises(ValueError, match="CUDA"):
        mega2w.mega2w_step(*meta, torch.empty((200, 2), device="meta"),
                           cfg.sampler, cfg.pde)


def test_mega_stays_finite_at_large_preactivations():
    """tanh saturates: the hand-derived backward must stay finite where
    the pre-activations reach +-40 and beyond."""
    cfg = tpinn.PINNConfig(**KW)
    np_params = _np_params(15, **KW)
    np_params["w1"] = np_params["w1"] * 1e4
    loss, grads = _plain(params_from_numpy(np_params, "cpu"),
                         torch.from_numpy(_points(16, 256).astype(np.float32)),
                         cfg)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
