"""PyTorch port, the 3D fused op and trainer: the fused3w wrappers (their
plain versions on the CPU), the fused op's dispatch on dim, loss_fused and
its gradients in 3D and the fused 3D trainer, held to the JAX package.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
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
from cosinesampler_tpu_torch.models import train as ttrain
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused2w, fused3w, route
from cosinesampler_tpu_torch.utils.convert import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, C, S, Q = 3, 2, (6, 7, 5), 200   # (D, H, W) = S


def _data(seed, lo=-1.2, hi=1.2):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N, C, *S)
    pts = rng.uniform(lo, hi, (Q, 3))
    g = rng.standard_normal((7, C, Q))
    return cells, pts, g


def _close(got, want, rtol):
    """rtol per element with an absolute floor of rtol times the largest
    magnitude, for entries that cancel to ~0."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


CONFIGS = [
    dict(padding_mode="zeros"),
    dict(padding_mode="border", align_corners=False),
    dict(padding_mode="reflection", multicell=False),
    dict(kernel="linear", padding_mode="reflection"),
    dict(kernel="smoothstep", padding_mode="zeros", align_corners=False,
         multicell=False),
    dict(kernel="smoothstep", padding_mode="border", strict_reference=True),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_fused3w_plain_matches_jax_f64(kw):
    """fused3w.fused_blend / fused_bwd on CPU tensors against the JAX
    package's sample_features_with_derivs and its cells vjp in f64, at
    rtol 1e-10; out-of-bounds queries included."""
    cells, pts, g = _data(0)
    jcfg, tcfg = JConfig(dim=3, **kw), TConfig(dim=3, **kw)
    want, vjp = jax.vjp(
        lambda c: jfused.sample_features_with_derivs(c, jnp.asarray(pts), jcfg),
        jnp.asarray(cells))
    (want_dc,) = vjp(jnp.asarray(g))
    tc, tp, tg = (torch.tensor(a) for a in (cells, pts, g))
    got = fused3w.fused_blend(tc, tp, tcfg)
    assert got.shape == (7, C, Q)
    _close(got.numpy(), want, 1e-10)
    _close(fused3w.fused_bwd(tg, tp, S, tcfg, N).numpy(), want_dc, 1e-10)


def test_fused_op_3d_dispatches_to_fused3w_wrappers(monkeypatch):
    """sample_features_with_derivs in 3D goes through the fused3w wrappers
    (forward and cells transpose), not the 2D ones, where the rule routes
    the call to fused3w: its small-cloud bound (route.FUSED3D_MAX_Q, which
    would take these 200 points to fused3d) is set to 0 here."""
    monkeypatch.setattr(route, "FUSED3D_MAX_Q", 0)
    cells, pts, g = (a.astype(np.float32) for a in _data(1))
    seen = []
    for mod in (fused2w, fused3w):
        for name in ("fused_blend", "fused_bwd"):
            fn = getattr(mod, name)

            def spy(*args, _fn=fn, _tag=(mod.__name__[-7:], name)):
                seen.append(_tag)
                return _fn(*args)
            monkeypatch.setattr(mod, name, spy)
    tc = torch.tensor(cells, requires_grad=True)
    out = tfused.sample_features_with_derivs(tc, torch.tensor(pts),
                                             TConfig(dim=3))
    (out * torch.tensor(g)).sum().backward()
    assert seen == [("fused3w", "fused_blend"), ("fused3w", "fused_bwd")]


def test_fused3w_cpu_wrappers_count_no_launch_and_never_fall_back():
    cells, pts, g = (torch.tensor(a, dtype=torch.float32) for a in _data(2))
    cfg = TConfig(dim=3)
    before = (fused3w.fused_blend.launches, fused3w.fused_bwd.launches)
    torch.testing.assert_close(fused3w.fused_blend(cells, pts, cfg),
                               fused3w.plain_fused_blend(cells, pts, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused3w.fused_bwd(g, pts, S, cfg, N),
                               fused3w.plain_fused_bwd(g, pts, S, cfg, N),
                               rtol=0, atol=0)
    assert (fused3w.fused_blend.launches,
            fused3w.fused_bwd.launches) == before
    meta = dict(dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused3w.fused_blend(torch.empty((N, C, *S), **meta),
                            torch.empty((Q, 3), **meta), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        fused3w.fused_bwd(torch.empty((7, C, Q), **meta),
                          torch.empty((Q, 3), **meta), S, cfg, N)


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


KW3 = dict(dim=3, n_cells=3, cell_dim=2, cell_size=6, hidden=8,
           pde="helmholtz")


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
