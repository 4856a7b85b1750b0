"""PyTorch port, the slot-resident and vol-resident fused op (fused3b):
part 3 of the tests of tests/test_torch_port_vol.py, which holds their
helpers. The tests are split into files of at most 10, which xdist's
loadfile queue (ordered by test count) runs beside
tests/test_sharding.py rather than ahead of it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosinesampler_tpu.ops.pallas as jpallas
from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3b
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_vol import (C, N, Q, S, VKW, VQ, _close, _points,
                                 _vol_setup)


def test_fused3b_cpu_wrappers_take_plain_and_never_fall_back():
    cfg = TConfig(dim=3)
    cells = torch.rand((N, C, *S), generator=torch.Generator().manual_seed(0))
    plan = tfused.make_vol_plan(torch.from_numpy(_points(6).astype(
        np.float32)), cells.shape, cfg)
    vol = fused3b.cells_to_vol(cells)
    g_p = torch.randn((7, C, plan[1].shape[0]))
    before = (fused3b.fused3b_blend_vol.launches,
              fused3b.fused3b_bwd_vol.launches)
    torch.testing.assert_close(fused3b.fused3b_blend_vol(vol, plan, cfg),
                               fused3b.plain_fused3b_blend_vol(vol, plan, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        fused3b.fused3b_bwd_vol(g_p, plan, S, cfg, N),
        fused3b.plain_fused3b_bwd_vol(g_p, plan, S, cfg, N), rtol=0, atol=0)
    assert (fused3b.fused3b_blend_vol.launches,
            fused3b.fused3b_bwd_vol.launches) == before
    meta = [t.to("meta") for t in plan]
    with pytest.raises(ValueError, match="CUDA"):
        fused3b.fused3b_blend_vol(vol.to("meta"), meta, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        fused3b.fused3b_bwd_vol(g_p.to("meta"), meta, S, cfg, N)


def test_supports_and_route_rule():
    """fused3b takes 3D stacks of any channel count with 2 queries per
    bin; make_sample_plan gives every 3D shape it takes a brick plan (the
    16^3 3D main path's cells, 4 x 24^3, config 5, and at C = 16, where
    fused3b measured faster than the v1 pair: PERF.md section 4) and no
    plan with too few points per bin."""
    cfg = TConfig(dim=3)
    assert fused3b.supports(cfg, (16, 4, 128, 128, 128), 1_000_000)
    assert not fused3b.supports(cfg, (16, 4, 128, 128, 128), 16_899)
    # the channel-group grid axis: no channel cap, as the JAX fused3b
    assert fused3b.supports(cfg, (16, 9, 8, 8, 8), 10_000)
    assert fused3b.supports(cfg, (16, 16, 128, 128, 128), 1_000_000)
    assert not fused3b.supports(TConfig(dim=2), (16, 4, 8, 8), 10_000)
    pts = torch.from_numpy(_points(7, 20_000, -1, 1).astype(np.float32))
    for shape in ((50, 4, 16, 16, 16), (16, 4, 24, 24, 24),
                  (16, 4, 48, 48, 48), (50, 16, 16, 16, 16)):
        assert tfused.make_sample_plan(pts, shape, cfg) is not None
    assert tfused.make_sample_plan(pts[:100], (50, 4, 16, 16, 16),
                                   cfg) is None
    assert tfused.make_sample_plan(pts, (16, 4, 128, 128, 128),
                                   TConfig(dim=3, backend="xla")) is None
    plan = tfused.make_sample_plan(pts, (16, 4, 128, 128, 128), cfg)
    assert len(plan) == 6 and plan[0].shape == (20_000,)
    assert int(plan[1].sum()) == 20_000
    assert tfused.make_fused_vol(cfg, 5, 3, (6, 6, 6), 120) is not None
    assert tfused.make_fused_vol(TConfig(dim=3, backend="xla"), 5, 3,
                                 (6, 6, 6), 120) is None


def test_planned_and_vol_ops_match_query_order_f64():
    """The planned op (sample_features_padded with a brick plan) and the
    vol op: out_p[:, :, positions] is the query-ordered op, pad slots are
    zero, and the cells and points cotangents equal the query-ordered
    op's, in f64."""
    cfg = TConfig(dim=3, padding_mode="border")
    rng = np.random.RandomState(8)
    cells = rng.rand(N, C, *S)
    pts = _points(9, lo=-1.1, hi=1.1)
    plan = tfused.make_vol_plan(torch.tensor(pts), cells.shape, cfg)
    positions, occ = plan[0], plan[1]
    w = torch.tensor(rng.standard_normal((7, C, Q)))

    def grads(fn, cells_t):
        c = cells_t.clone().requires_grad_(True)
        p = torch.tensor(pts, requires_grad=True)
        out = fn(c, p)
        out.mul(w).sum().backward()
        return out.detach(), c.grad, p.grad

    want, want_dc, want_dp = grads(
        lambda c, p: tfused.sample_features_with_derivs(c, p, cfg),
        torch.tensor(cells))

    def planned(c, p):
        out_p, occ_p, pos = tfused.sample_features_padded(c, p, cfg, plan)
        assert occ_p is occ and pos is positions
        assert bool((out_p[:, :, occ == 0] == 0).all())
        return out_p[:, :, positions]

    fused_vol, to_vol, from_vol = tfused.make_fused_vol(cfg, N, C, S, Q)
    for fn, cells_t in ((planned, torch.tensor(cells)),
                        (lambda v, p: fused_vol(v, p, plan)[0][:, :,
                                                               positions],
                         to_vol(torch.tensor(cells)))):
        got, dc, dp = grads(fn, cells_t)
        _close(got.numpy(), want.numpy(), 1e-10)
        if dc.shape != want_dc.shape:
            dc = from_vol(dc)
        _close(dc.numpy(), want_dc.numpy(), 1e-10)
        _close(dp.numpy(), want_dp.numpy(), 1e-10)
    with pytest.raises(ValueError, match="plan was built for 200 points"):
        tfused.sample_features_padded(torch.tensor(cells),
                                      torch.tensor(pts[:-1]), cfg, plan)


def test_planned_op_under_xla_places_query_rows_in_slots():
    """backend="xla" takes no kernel: the planned op places the
    query-ordered plain rows in the plan's slots, and equals the kernel
    route's plain versions."""
    rng = np.random.RandomState(12)
    cells = torch.tensor(rng.rand(N, C, *S))
    pts = torch.tensor(_points(13))
    plan = tfused.make_vol_plan(pts, cells.shape, TConfig(dim=3))
    got, occ, positions = tfused.sample_features_padded(
        cells, pts, TConfig(dim=3, backend="xla"), plan)
    want, _, _ = tfused.sample_features_padded(cells, pts, TConfig(dim=3),
                                               plan)
    assert occ is plan[1] and positions is plan[0]
    _close(got.numpy(), want.numpy(), 1e-12)
    assert bool((got[:, :, occ == 0] == 0).all())


def test_loss_fused_slots_vol_and_grads_match_jax_interpret(monkeypatch):
    """pinn.loss_fused_slots_vol and its gradient against the JAX package's,
    whose fused3b kernels run in interpret mode: loss at rtol 1e-5, every
    leaf at rtol 1e-4 (f32).  Both take the port's plan, which is the JAX
    package's (test_make_plan_bit_equal_to_jax)."""
    monkeypatch.setattr(jpallas, "INTERPRET", True)
    jcfg, np_params, pts = _vol_setup(10)
    tcfg = tpinn.PINNConfig(**VKW)
    tp = torch.from_numpy(pts)
    plan = tfused.make_vol_plan(tp, np_params["cells"].shape, tcfg.sampler)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    # jitted whole: compiling the two interpret-mode kernels in one
    # program takes a third of the time of compiling them apart
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused_slots_vol),
                              static_argnums=2)(
        jpinn.params_to_vol(jparams, jcfg, VQ), jnp.asarray(pts), jcfg,
        tuple(jnp.asarray(a.numpy()) for a in plan))
    want = jpinn.params_from_vol(want, jcfg, VQ)

    params = tpinn.params_to_vol(params_from_numpy(np_params, "cpu"), tcfg,
                                 VQ)
    loss = tpinn.loss_fused_slots_vol(params, tp, tcfg, plan)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    grads = {k: v.grad for k, v in params.items()}
    grads["cells"] = fused3b.vol_to_cells(grads["cells"])
    for k in want:
        _close(grads[k].numpy(), want[k], 1e-4)


def test_vol_resident_steps_equal_planned_steps():
    """Three steps of make_train_step(vol_resident=True) equal three planned
    steps on the same plan: losses, and params_from_vol of the result."""
    _, np_params, pts = _vol_setup(11)
    cfg = tpinn.PINNConfig(**VKW)
    tp = torch.from_numpy(pts)
    plan = tfused.make_vol_plan(tp, np_params["cells"].shape, cfg.sampler)
    params = params_from_numpy(np_params, "cpu")
    params_v = tpinn.params_to_vol(params_from_numpy(np_params, "cpu"), cfg,
                                   VQ)
    step = tpinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-2), planned=True)
    step_v = tpinn.make_train_step(
        cfg, torch.optim.Adam(params_v.values(), lr=1e-2), vol_resident=True)
    for _ in range(3):
        lval, lval_v = step(params, tp, plan), step_v(params_v, tp, plan)
        np.testing.assert_allclose(float(lval_v), float(lval), rtol=1e-6)
    back = tpinn.params_from_vol(params_v, cfg, VQ)
    assert back["cells"].shape == params["cells"].shape
    for k in params:
        _close(back[k].detach().numpy(), params[k].detach().numpy(), 1e-6)


def test_train_vol_resident_on_cpu(capsys):
    """train(vol_resident=True) lowers the loss, returns the cells in the
    API layout, and its first loss is the fixed-point fused trainer's; the
    CLI takes --vol-resident."""
    losses = {}
    for vol in (True, False):
        cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**VKW), device="cpu",
                                 steps=3, batch_points=VQ, log_every=1,
                                 vol_resident=vol, fixed_points=True)
        params, metrics = ttrain.train(cfg)
        assert params["cells"].shape == (5, 3, 6, 6, 6)
        assert all(bool(torch.isfinite(v).all()) for v in params.values())
        losses[vol] = [m["loss"] for m in metrics]
    assert losses[True][-1] < losses[True][0]
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-5)
    assert ttrain.main(["--device", "cpu", "--dim", "3", "--steps", "2",
                        "--batch-points", "120", "--n-cells", "5",
                        "--cell-size", "6", "--vol-resident"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["step"] for m in lines] == [2] and np.isfinite(lines[0]["loss"])


def test_vol_resident_at_c16_matches_jax_fused_loss():
    """The vol-resident loss and gradient at C = 16 (two channel groups of
    fused3b on the card; the plain vol ops here) against
    jax.value_and_grad of the JAX package's fused loss on its XLA route,
    same weights and points: loss rtol 1e-5, every leaf rtol 1e-4.  Then
    two vol-resident trainer steps at C = 16 on the CPU."""
    kw = {**VKW, "cell_dim": 16}
    tcfg = tpinn.PINNConfig(**kw)
    np_params = {k: v.detach().numpy() for k, v in tpinn.init_params(
        torch.Generator().manual_seed(12), tcfg, "cpu").items()}
    pts = _points(12, VQ, -1.0, 1.0).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jpinn.PINNConfig(backend="xla", **kw))
    tp = torch.from_numpy(pts)
    plan = tfused.make_vol_plan(tp, np_params["cells"].shape, tcfg.sampler)
    params = tpinn.params_to_vol(params_from_numpy(np_params, "cpu"), tcfg,
                                 VQ)
    loss = tpinn.loss_fused_slots_vol(params, tp, tcfg, plan)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    grads = {k: v.grad for k, v in params.items()}
    grads["cells"] = fused3b.vol_to_cells(grads["cells"])
    for k in want:
        _close(grads[k].numpy(), want[k], 1e-4)
    cfg = ttrain.TrainConfig(model=tcfg, device="cpu", steps=2,
                             batch_points=VQ, log_every=1, vol_resident=True)
    trained, metrics = ttrain.train(cfg)
    assert trained["cells"].shape == (5, 16, 6, 6, 6)
    assert all(np.isfinite(m["loss"]) for m in metrics)


@pytest.mark.parametrize("model,fused", [
    (dict(n_cells=4, cell_size=8), True),     # 2D
    (VKW, False),                             # the nested loss
], ids=["2d", "not-fused"])
def test_vol_resident_off_route_raises(model, fused):
    cfg = ttrain.TrainConfig(model=tpinn.PINNConfig(**model), device="cpu",
                             steps=1, batch_points=VQ, vol_resident=True,
                             fused=fused)
    with pytest.raises(ValueError, match="vol_resident"):
        ttrain.train(cfg)
