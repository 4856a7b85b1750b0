"""PyTorch port, the small- and large-cloud 3D fused kernels (fused3d,
fused3s): part 2 of the tests of tests/test_torch_port_fused3ds.py,
which holds their helpers. The tests are split into files of at most 10,
which xdist's loadfile queue (ordered by test count) runs beside
tests/test_sharding.py rather than ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosinesampler_tpu.models import pinn as jpinn
from cosinesampler_tpu_torch.models import pinn as tpinn, train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3d, fused3s, fused3w, route
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from cosinesampler_tpu_torch.utils.convert import params_to_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused3ds import C, F32, N, Q, S, SMALL3, _data


@pytest.mark.parametrize("mod", [fused3d, fused3s], ids=["fused3d",
                                                         "fused3s"])
def test_wrappers_take_plain_on_cpu_and_raise_off_it(mod):
    """On the CPU the wrappers are their plain versions and count no
    launch; a tensor on another device (meta here) raises."""
    cells, pts, g = (torch.from_numpy(a) for a in _data(5, -1.2, 1.2))
    cfg = TConfig(dim=3, padding_mode="border")
    before = (mod.fused_blend.launches, mod.fused_bwd.launches)
    torch.testing.assert_close(mod.fused_blend(cells, pts, cfg),
                               fused3w.plain_fused_blend(cells, pts, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(mod.fused_bwd(g, pts, (S, S, S), cfg, N),
                               fused3w.plain_fused_bwd(g, pts, (S, S, S), cfg,
                                                       N), rtol=0, atol=0)
    assert (mod.fused_blend.launches, mod.fused_bwd.launches) == before
    meta = dict(dtype=F32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mod.fused_blend(torch.empty((N, C, S, S, S), **meta),
                        torch.empty((Q, 3), **meta), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        mod.fused_bwd(torch.empty((7, C, Q), **meta),
                      torch.empty((Q, 3), **meta), (S, S, S), cfg, N)


@pytest.mark.parametrize("name", ["fused3d", "fused3s"])
def test_fused_op_runs_the_routed_pair(monkeypatch, name):
    """sample_features_with_derivs runs the blend and the cells transpose
    of the 3D route the rule gives."""
    seen = []
    for mod in (fused3d, fused3s, fused3w):
        for fn_name in ("fused_blend", "fused_bwd"):
            fn = getattr(mod, fn_name)

            def spy(*args, _fn=fn, _tag=(mod.__name__.rsplit(".", 1)[1],
                                         fn_name)):
                seen.append(_tag)
                return _fn(*args)
            monkeypatch.setattr(mod, fn_name, spy)
    monkeypatch.setattr(route, "fused_rule", lambda *args: name)
    cells, pts, g = (torch.from_numpy(a) for a in _data(6, -1.2, 1.2))
    tc = cells.clone().requires_grad_(True)
    out = tfused.sample_features_with_derivs(tc, pts, TConfig(dim=3))
    (out * g).sum().backward()
    assert seen == [(name, "fused_blend"), (name, "fused_bwd")]


def test_small_cloud_3d_trainer_two_steps_match_jax():
    """Two steps of the 3D fused trainer at a small fresh cloud, the shape
    the card routes to fused3d, on the CPU (the fused3d wrappers take
    their plain versions) against two steps of the JAX package's fused
    step (XLA route) with optax.adam on the same weights and points: loss
    rtol 1e-5, and every leaf after the two steps rtol 1e-4."""
    q, lr, seed = 256, 1e-2, 4
    tcfg = tpinn.PINNConfig(**SMALL3)
    shape = (6, 4, 8, 8, 8)
    assert route.fused_rule(tcfg.sampler, shape, q, "cuda") == "fused3d"
    cfg = ttrain.TrainConfig(model=tcfg, batch_points=q, steps=2, lr=lr,
                             seed=seed, device="cpu", log_every=1)
    before = (fused3d.fused_blend.launches, fused3d.fused_bwd.launches)
    params, metrics = ttrain.train(cfg)
    assert (fused3d.fused_blend.launches,
            fused3d.fused_bwd.launches) == before

    init = tpinn.init_params(torch.Generator().manual_seed(seed), tcfg, "cpu")
    jparams = {k: jnp.asarray(v.detach().numpy()) for k, v in init.items()}
    opt = optax.adam(lr)
    jstate = opt.init(jparams)
    jstep = jax.jit(jpinn.make_train_step(
        jpinn.PINNConfig(backend="xla", **SMALL3), opt, fused=True))
    gen = tpointgen.PointGenerator(q, 3, seed=seed, force_numpy=True)
    for step in range(2):
        jparams, jstate, jloss = jstep(jparams, jstate,
                                       jnp.asarray(gen.batch(step)))
        np.testing.assert_allclose(metrics[step]["loss"], float(jloss),
                                   rtol=1e-5)
    got = params_to_numpy(params)
    for k in got:
        want = np.asarray(jparams[k])
        np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))
