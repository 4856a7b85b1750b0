"""PyTorch port, the slice as a whole: the fused and the nested-autograd
PINN losses, their gradients, Adam steps, the point stream and the
trainer, held to the JAX package on the same weights and points (f32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu.utils import pointgen as jpointgen
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.models import train as ttrain
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import (params_from_numpy,
                                                   params_to_numpy)

KW = dict(n_cells=8, cell_size=16, hidden=16)
Q = 512


def _setup(seed=0, **extra):
    jcfg = jpinn.PINNConfig(**KW, **extra)
    tcfg = tpinn.PINNConfig(**KW, **extra)
    jparams = jpinn.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    pts = tpointgen.PointGenerator(Q, 2, seed=seed, force_numpy=True).batch(0)
    return jcfg, tcfg, np_params, pts


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0 in f32."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("extra", [{}, {"padding_mode": "border",
                                        "kernel": "smoothstep"}],
                         ids=["main-path", "border-smoothstep"])
def test_slice_loss_and_grads_match_jax(extra):
    """loss at rtol 1e-5 and every gradient leaf at rtol 1e-4 against
    jax.value_and_grad(pinn.loss_fused): the reference's own acceptance bar
    for dloss/dcells."""
    jcfg, tcfg, np_params, pts = _setup(**extra)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jpinn.loss_fused),
                                    static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused(params, torch.from_numpy(pts), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(params) == set(want_grads)
    for k, p in params.items():
        _close(p.grad.numpy(), want_grads[k], 1e-4)


KW3 = dict(dim=3, n_cells=4, cell_size=6, hidden=8, pde="helmholtz")


def _setup3(seed):
    jcfg, tcfg = jpinn.PINNConfig(**KW3), tpinn.PINNConfig(**KW3)
    jparams = jpinn.init_params(jax.random.PRNGKey(seed), jcfg)
    np_params = {k: np.asarray(v) for k, v in jparams.items()}
    pts = tpointgen.PointGenerator(256, 3, seed=seed,
                                   force_numpy=True).batch(0)
    return jcfg, tcfg, np_params, pts


@pytest.mark.parametrize("dim", [2, 3], ids=["2d-allen-cahn",
                                             "3d-helmholtz"])
def test_nested_loss_and_grads_match_jax(dim):
    """pinn.loss, the nested-autograd residual (third-order dloss/dcells),
    against jax.value_and_grad(pinn.loss) on the same weights and points:
    loss at rtol 1e-5, every gradient leaf at rtol 1e-4 (f32)."""
    jcfg, tcfg, np_params, pts = _setup(5) if dim == 2 else _setup3(5)
    value_and_grad = jax.value_and_grad(jpinn.loss)
    if dim == 2:
        # 3D runs eagerly: compiling its third-order graph takes far longer
        # than running it once
        value_and_grad = jax.jit(value_and_grad, static_argnums=2)
    want_loss, want_grads = value_and_grad(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss(params, torch.from_numpy(pts), tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert set(params) == set(want_grads)
    for k, p in params.items():
        _close(p.grad.numpy(), want_grads[k], 1e-4)


def test_nested_loss_equals_fused_loss():
    """The two forms of one loss: nested autograd through the sampler and
    the fused value/derivative pass."""
    _, tcfg, np_params, pts = _setup(6)
    grads = []
    for loss_fn in (tpinn.loss, tpinn.loss_fused):
        params = params_from_numpy(np_params, "cpu")
        loss = loss_fn(params, torch.from_numpy(pts), tcfg)
        loss.backward()
        grads.append((float(loss.detach()),
                      {k: v.grad.numpy() for k, v in params.items()}))
    (l_nested, g_nested), (l_fused, g_fused) = grads
    np.testing.assert_allclose(l_nested, l_fused, rtol=1e-5)
    for k in g_fused:
        _close(g_nested[k], g_fused[k], 1e-4)


def test_spatial_derivative_matches_residual_fields():
    _, tcfg, np_params, pts = _setup(7)
    params = params_from_numpy(np_params, "cpu")
    tp = torch.from_numpy(pts)
    u, u_d, u_dd = tpinn.field_and_grads(params, tp, tcfg)
    for axis in (0, 1):
        _close(tpinn.spatial_derivative(params, tp, tcfg, axis, 1)
               .detach().numpy(), u_d[axis].detach().numpy(), 1e-4)
        _close(tpinn.spatial_derivative(params, tp, tcfg, axis, 2)
               .detach().numpy(), u_dd[axis].detach().numpy(), 1e-4)
    _close(tpinn.spatial_derivative(params, tp, tcfg, 0, 0).detach().numpy(),
           u.detach().numpy(), 1e-6)


def test_slot_loss_equals_query_loss():
    _, tcfg, np_params, pts = _setup(1)
    params = params_from_numpy(np_params, "cpu")
    tp = torch.from_numpy(pts)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tpinn.loss_fused_slots(params, tp, tcfg)),
            float(tpinn.loss_fused(params, tp, tcfg)), rtol=1e-6)


def test_three_adam_steps_match_optax():
    """torch.optim.Adam(lr) is optax.adam(lr): same b1, b2, eps and bias
    correction; params after 3 steps at rtol 1e-4."""
    jcfg, tcfg, np_params, _ = _setup(2)
    gen = tpointgen.PointGenerator(Q, 2, seed=2, force_numpy=True)
    opt = optax.adam(1e-3)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jstate = opt.init(jparams)
    jstep = jax.jit(jpinn.make_train_step(jcfg, opt, fused=True))
    params = params_from_numpy(np_params, "cpu")
    tstep = tpinn.make_train_step(
        tcfg, torch.optim.Adam(params.values(), lr=1e-3), fused=True)
    for step in range(3):
        pts = gen.batch(step)
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(pts))
        tloss = tstep(params, torch.from_numpy(pts))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = params_to_numpy(params)
    for k in got:
        _close(got[k], jparams[k], 1e-4)


def test_mlp_derivs_stay_finite_at_large_preactivations():
    """tanh saturates: the closed-form ladder must stay finite where a
    two-sided-exp tanh would overflow."""
    _, tcfg, np_params, pts = _setup(3)
    np_params["w1"] = np_params["w1"] * 1e4
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused(params, torch.from_numpy(pts), tcfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


def test_init_params_shapes_and_distributions():
    cfg = tpinn.PINNConfig()
    params = tpinn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jshapes = {k: v.shape for k, v in jpinn.init_params(
        jax.random.PRNGKey(0), jpinn.PINNConfig()).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == jshapes
    assert all(v.dtype == torch.float32 and v.requires_grad and v.is_leaf
               for v in params.values())
    cells = params["cells"].detach()
    assert 0.0 <= float(cells.min()) and float(cells.max()) < 1.0
    assert abs(float(cells.mean()) - 0.5) < 0.01
    s1 = np.sqrt(2.0 / (cfg.cell_dim + cfg.hidden))
    assert abs(float(params["w1"].detach().std()) / s1 - 1.0) < 0.35
    assert not params["b1"].detach().any()
    again = tpinn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_params_convert_roundtrip():
    _, _, np_params, _ = _setup(4)
    back = params_to_numpy(params_from_numpy(np_params, "cpu"))
    for k, v in np_params.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("force_numpy", [False, True])
def test_point_stream_bit_equal_to_jax(force_numpy):
    mine = tpointgen.PointGenerator(300, 2, seed=11, force_numpy=force_numpy)
    ref = jpointgen.PointGenerator(300, 2, seed=11, force_numpy=True)
    with mine:
        assert mine.is_native != force_numpy
        for step in (0, 1, 7, 2):    # out of order, as a resume would ask
            np.testing.assert_array_equal(mine.batch(step), ref.batch(step))
    ref.close()


@pytest.mark.parametrize("kwargs,match", [
    (dict(fused=True, megakernel=True), "ROADMAP B3"),
    (dict(fused=True, vol_resident=True), "ROADMAP B10"),
])
def test_make_train_step_unported_modes_raise(kwargs, match):
    params = tpinn.init_params(torch.Generator().manual_seed(0),
                               tpinn.PINNConfig(**KW), "cpu")
    opt = torch.optim.Adam(params.values())
    with pytest.raises(NotImplementedError, match=match):
        tpinn.make_train_step(tpinn.PINNConfig(**KW), opt, **kwargs)


@pytest.mark.parametrize("field,value", [
    ("vol_resident", True), ("megakernel", True), ("shard", True),
    ("autotune", True), ("checkpoint_dir", "ckpt")])
def test_train_unported_options_raise(field, value):
    cfg = ttrain.TrainConfig(device="cpu", steps=1, batch_points=64,
                             **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.train(cfg)


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(ttrain.TrainConfig(device="cuda", steps=1,
                                        batch_points=64))


def test_train_end_to_end_on_cpu():
    seen = []
    cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW), device="cpu",
                             steps=3, batch_points=Q, log_every=1)
    params, metrics = ttrain.train(cfg, on_metrics=seen.append)
    assert [m["step"] for m in metrics] == [1, 2, 3] and seen == metrics
    assert all(np.isfinite(m["loss"]) and m["steps_per_sec"] > 0
               for m in metrics)
    assert params["cells"].shape == (8, 4, 16, 16)
    # fixed points: the same batch every step
    fixed = ttrain.TrainConfig(model=tpinn.PINNConfig(**KW), device="cpu",
                               steps=2, batch_points=Q, log_every=1,
                               fixed_points=True)
    _, fixed_metrics = ttrain.train(fixed)
    assert fixed_metrics[0]["loss"] == metrics[0]["loss"]


@pytest.mark.parametrize("model", [dict(KW), dict(KW3)],
                         ids=["2d-allen-cahn", "3d-helmholtz"])
def test_train_nested_on_cpu(model):
    """fused=False trains on pinn.loss; its first loss is the fused
    trainer's first loss (same weights and points, same function)."""
    losses = {}
    for fused in (False, True):
        cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**model),
                                 device="cpu", steps=2, batch_points=256,
                                 log_every=1, fused=fused)
        params, metrics = ttrain.train(cfg)
        assert [m["step"] for m in metrics] == [1, 2]
        assert all(np.isfinite(m["loss"]) for m in metrics)
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        losses[fused] = metrics[0]["loss"]
    np.testing.assert_allclose(losses[False], losses[True], rtol=1e-5)


def test_cli_no_fused(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--batch-points",
                        "256", "--n-cells", "4", "--no-fused"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2]
    assert np.isfinite(lines[0]["loss"])


def test_cli_prints_json_metrics(capsys):
    assert ttrain.main(["--device", "cpu", "--steps", "2", "--batch-points",
                        "256", "--n-cells", "4"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2]     # the last step always logs
    assert np.isfinite(lines[0]["loss"])
