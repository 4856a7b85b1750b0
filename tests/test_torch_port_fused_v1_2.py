"""PyTorch port, the v1 fused pair, fused2d, the plain route and exact
mode: part 2 of the tests of tests/test_torch_port_fused_v1.py, which
holds their helpers. The tests are split into files of at most 10, which
xdist's loadfile queue (ordered by test count) runs beside
tests/test_sharding.py rather than ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import (fused as fused_v1, fused2d,
                                              fused2w, fused3w, route)
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused_v1 import F32, F64, SLICE, _close, _data


@pytest.mark.parametrize("dim", [2, 3], ids=["2d-allen-cahn",
                                             "3d-helmholtz"])
def test_wide_slice_loss_and_grads_match_jax(dim):
    """pinn.loss_fused at C = 12 through the rule's route (the v1 pair at
    these sizes, where fused2w's / fused3w's bwd would not add in place),
    against
    jax.value_and_grad(pinn.loss_fused) on the same weights and points:
    loss rtol 1e-5, every leaf rtol 1e-4 (the reference's dloss/dcells
    bar)."""
    jcfg, tcfg = jpinn.PINNConfig(**SLICE[dim]), tpinn.PINNConfig(**SLICE[dim])
    np_params = {k: v.detach().numpy() for k, v in tpinn.init_params(
        torch.Generator().manual_seed(dim), tcfg, "cpu").items()}
    pts = tpointgen.PointGenerator(200, dim, seed=dim,
                                   force_numpy=True).batch(0)
    want_loss, want = jax.jit(jax.value_and_grad(jpinn.loss_fused),
                              static_argnums=2)(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
        jcfg)
    assert route.fused_rule(tcfg.sampler, np_params["cells"].shape, 200,
                            "cuda") == "fused"
    before = fused_v1.fused_bwd.launches
    params = params_from_numpy(np_params, "cpu")
    loss = tpinn.loss_fused(params, torch.from_numpy(pts), tcfg)
    loss.backward()
    assert fused_v1.fused_bwd.launches == before     # the CPU takes plain
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k], 1e-4)


def test_wide_trainer_two_steps_on_cpu():
    """Two trainer steps at C = 12 on the CPU: finite, falling losses, equal
    to two make_train_step steps on the trainer's weights and points."""
    model = tpinn.PINNConfig(**SLICE[2])
    cfg = ttrain.TrainConfig(model=model, batch_points=256, steps=2, lr=1e-2,
                             seed=3, device="cpu", log_every=1)
    _, metrics = ttrain.train(cfg)
    losses = [m["loss"] for m in metrics]
    params = tpinn.init_params(torch.Generator().manual_seed(3), model, "cpu")
    step = tpinn.make_train_step(
        model, torch.optim.Adam(params.values(), lr=1e-2), fused=True)
    with tpointgen.PointGenerator(256, 2, seed=3) as gen:
        want = [float(step(params, torch.from_numpy(gen.batch(i))))
                for i in range(2)]
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    assert all(np.isfinite(losses)) and params["cells"].shape[1] == 12


def test_fused_rule_follows_the_jax_order():
    """route.fused_rule as a pure function of shapes, dtypes and device
    type: plain for what no CUDA kernel takes; above 8 channels the v1
    kernels (fused3w's channel groups only over stacks larger than the
    L2, tests/test_torch_port_wide.py); the 3D kernels in 3D (fused3d for
    these small clouds; tests/test_torch_port_fused3ds.py holds the 3D
    branch), fused2d for small 2D clouds (up to FUSED2D_MAX_Q points or
    FUSED2D_MAX_Q_PER_CELL points a cell, whichever allows more, on any
    stack), fused2w otherwise; off the card the same kernel routes."""
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    max_q, per_cell = route.FUSED2D_MAX_Q, route.FUSED2D_MAX_Q_PER_CELL
    rule = route.fused_rule
    assert rule(cfg2, (96, 4, 16, 16), 100_000) == "fused2w"
    # the sweep's points (PERF.md section 4), each to its faster kernel
    for n, q, want in [(96, 2047, "fused2d"), (96, 4096, "fused2d"),
                       (96, 24576, "fused2d"), (96, 32768, "fused2d"),
                       (96, 49152, "fused2w"), (64, 24576, "fused2d"),
                       (64, 32768, "fused2w"), (48, 16384, "fused2d"),
                       (48, 24576, "fused2w"), (32, 1024, "fused2d"),
                       (32, 12288, "fused2d"), (32, 16384, "fused2w"),
                       (32, 32768, "fused2w"), (24, 12288, "fused2d"),
                       (24, 16384, "fused2w"), (16, 512, "fused2d"),
                       (16, 12288, "fused2d"), (16, 32768, "fused2w"),
                       (8, 512, "fused2d"), (8, 12288, "fused2d"),
                       (8, 32768, "fused2w"), (8, 100_000, "fused2w")]:
        assert rule(cfg2, (n, 4, 16, 16), q) == want, (n, q)
    for n in (1, 8, max_q // per_cell):
        assert rule(cfg2, (n, 4, 16, 16), max_q) == "fused2d"
        assert rule(cfg2, (n, 4, 16, 16), max_q + 1) == "fused2w"
    for n in (max_q // per_cell + 1, 96):
        assert rule(cfg2, (n, 4, 16, 16), per_cell * n) == "fused2d"
        assert rule(cfg2, (n, 4, 16, 16), per_cell * n + 1) == "fused2w"
    assert rule(cfg3, (50, 4, 16, 16, 16), 100) == "fused3d"
    for shape in ((96, 16, 16, 16), (50, 16, 16, 16, 16)):
        cfg = cfg2 if len(shape) == 4 else cfg3
        assert rule(cfg, shape, 100_000) == "fused"
        assert rule(cfg, shape, 100) == "fused"
    assert rule(cfg2, (96, 9, 16, 16), 1024) == "fused"
    assert rule(cfg2, (96, 9, 16, 16), 100_000) == "fused"
    assert rule(cfg2, (16, 9, 1024, 1024), 1024) == "fused2w"
    # a 4 x 256^2 cell (1 MB): nothing is staged, so fused2d takes it
    assert rule(cfg2, (2, 4, 256, 256), 100) == "fused2d"
    for what, args in [
            ("f64", (cfg2, (96, 4, 16, 16), 100_000, "cuda", F64)),
            ("f64 at C > 8", (cfg3, (8, 16, 8, 8, 8), 100, "cuda", F64)),
            ("strict, align off",
             (TConfig(dim=2, strict_reference=True, align_corners=False),
              (96, 4, 16, 16), 100_000, "cuda", F32)),
            ("2^31 cells", (cfg2, (2, 4, 16384, 16384), 100, "cuda", F32)),
            ("2^31 rows", (cfg2, (8, 64, 16, 16), 2**31 // 320 + 1, "cuda",
                           F32))]:
        assert rule(*args) == "plain", what
    # strict 3D with align off takes the kernels (no mixed rows in 3D)
    assert rule(TConfig(dim=3, strict_reference=True, align_corners=False),
                (16, 4, 8, 8, 8), 100, "cuda", F32) == "fused3d"
    # off the card the wrappers decide: the CPU takes the plain versions
    assert rule(cfg2, (96, 4, 16, 16), 100_000, "cpu", F64) == "fused2w"
    assert rule(cfg3, (8, 16, 8, 8, 8), 100, "cpu", F64) == "fused"
    assert rule(cfg3, (8, 16, 8, 8, 8), 100_000, "cpu", F64) == "fused"
    assert rule(cfg2, (96, 4, 16, 16), 100_000, "mixed", F64) == "fused2w"


def test_sampler_rule_sends_what_no_kernel_takes_to_plain():
    """route.sampler_rule: f64 and over-2^31 CUDA calls take the plain
    route; the other CUDA calls take route.rule; off the card blend_o,
    whose wrapper decides."""
    cfg2, cfg3 = TConfig(dim=2), TConfig(dim=3)
    sr = route.sampler_rule
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2)) == "blend_o"
    assert sr(cfg3, (16, 4, 128, 128, 128), (1, 1, 1, 100_000, 3)) == \
        "slab"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "cuda", F64) == \
        "plain"
    assert sr(cfg2, (2, 4, 16384, 16384), (1, 1, 4096, 2)) == "plain"
    # N * C * Q output elements over the limit
    assert sr(cfg2, (2**12, 4, 4, 4), (1, 1, 2**17, 2)) == "plain"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "cpu", F64) == \
        "blend_o"
    assert sr(cfg2, (96, 4, 16, 16), (1, 1, 100_000, 2), "mixed", F32) == \
        "blend_o"


@pytest.mark.parametrize("name", ["fused2w", "fused2d", "fused3w", "fused",
                                  "plain"])
def test_fused_op_dispatches_to_the_rule_route(monkeypatch, name):
    """sample_features_with_derivs runs the blend and the cells transpose
    of the route route.fused_rule gives (the bwd mirrors the blend); the
    plain route counts its two calls in route.run_plain.launches."""
    seen = []
    mods = {"fused2w": fused2w, "fused2d": fused2d, "fused3w": fused3w,
            "fused": fused_v1}
    for tag, mod in mods.items():
        for fn_name in ("fused_blend", "fused_bwd"):
            fn = getattr(mod, fn_name)

            def spy(*args, _fn=fn, _tag=(tag, fn_name)):
                seen.append(_tag)
                return _fn(*args)
            monkeypatch.setattr(mod, fn_name, spy)
    monkeypatch.setattr(route, "fused_rule", lambda *args: name)
    cells, pts, g = _data(2, 3, 4, (6, 7), seed=11, q=40)
    tc = torch.tensor(cells, requires_grad=True)
    before = route.run_plain.launches
    out = tfused.sample_features_with_derivs(tc, torch.from_numpy(pts),
                                             TConfig(dim=2))
    (out * torch.from_numpy(g)).sum().backward()
    if name == "plain":
        assert seen == [] and route.run_plain.launches == before + 2
    else:
        assert seen == [(name, "fused_blend"), (name, "fused_bwd")]
        assert route.run_plain.launches == before
    want = fused2w.plain_fused_bwd(torch.from_numpy(g), torch.from_numpy(pts),
                                   (6, 7), TConfig(dim=2), 3)
    torch.testing.assert_close(tc.grad, want, rtol=0, atol=0)
