"""PyTorch port, the 3D fused op and trainer: the fused3w wrappers (their
plain versions on the CPU), the fused op's dispatch on dim, loss_fused and
its gradients in 3D and the fused 3D trainer, held to the JAX package.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.

The tests are split over this file and
tests/test_torch_port_fused3d_2.py (files of at most 10 tests, which
xdist's loadfile queue, ordered by test count, runs beside
tests/test_sharding.py rather than ahead of it); the helpers stay here.
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
from cosinesampler_tpu_torch.ops.cuda import fused2w, fused3w, route
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


KW3 = dict(dim=3, n_cells=3, cell_dim=2, cell_size=6, hidden=8,
           pde="helmholtz")
