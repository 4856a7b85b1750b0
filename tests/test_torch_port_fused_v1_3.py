"""PyTorch port, the v1 fused pair, fused2d, the plain route and exact
mode: part 3 of the tests of tests/test_torch_port_fused_v1.py, which
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
from cosinesampler_tpu_torch.models import pinn as tpinn
from cosinesampler_tpu_torch.ops import generic
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused as fused_v1, fused2d, route
from cosinesampler_tpu_torch.utils import pointgen as tpointgen
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_fused_v1 import (F32, F64, Q, _close, _data,
                                      _loss_and_grads)


def test_plain_route_of_the_sampler_counts_and_matches(monkeypatch):
    """route.blend / route.splat on the plain route: the plain versions on
    the call's own device, one count each."""
    monkeypatch.setattr(route, "pick", lambda *args: "plain")
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(3, 2, 5, 6))
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 7, 2)))
    cfg = TConfig(dim=2)
    before = route.run_plain.launches
    out = route.blend(x, grid, cfg, (1, 0))
    back = route.splat(out, grid, (5, 6), cfg, (1, 0))
    assert route.run_plain.launches == before + 2
    torch.testing.assert_close(out, generic.blend(x, grid, cfg,
                                                          (1, 0)))
    torch.testing.assert_close(back, generic.splat(out, grid, (5, 6),
                                                           cfg, (1, 0)))


def test_fused2d_supports_what_a_block_stages():
    """No block stages a channel group of a cell any more (fused2d runs
    fused2w's bodies in blocks of a few queries): every 2D stack is taken,
    whatever its cells' size and channel count, in every padding mode; 3D
    is refused."""
    assert fused2d.supports(TConfig(dim=2), (96, 4, 16, 16))
    assert fused2d.supports(TConfig(dim=2), (96, 16, 16, 16))
    assert fused2d.supports(TConfig(dim=2), (3, 4, 64, 64))
    assert fused2d.supports(TConfig(dim=2), (2, 4, 256, 256))
    assert fused2d.supports(TConfig(dim=2), (16, 16, 1024, 1024))
    assert fused2d.supports(TConfig(dim=2, padding_mode="reflection"),
                            (1, 3, 7, 9))
    assert not fused2d.supports(TConfig(dim=3), (2, 4, 8, 8, 8))
    assert not fused2d.supports(TConfig(dim=2), (2, 4, 8, 8, 8))


@pytest.mark.parametrize("mod", [fused_v1, fused2d], ids=["v1", "fused2d"])
def test_new_wrappers_take_plain_on_cpu_and_raise_off_it(mod):
    """On the CPU the wrappers are their plain versions and count no
    launch; a tensor on another device (meta here) raises."""
    cells, pts, g = (torch.from_numpy(a) for a in _data(2, 3, 9, (6, 7), 13))
    cfg = TConfig(dim=2, padding_mode="border")
    before = (mod.fused_blend.launches, mod.fused_bwd.launches)
    torch.testing.assert_close(mod.fused_blend(cells, pts, cfg),
                               mod.plain_fused_blend(cells, pts, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(mod.fused_bwd(g, pts, (6, 7), cfg, 3),
                               mod.plain_fused_bwd(g, pts, (6, 7), cfg, 3),
                               rtol=0, atol=0)
    assert (mod.fused_blend.launches, mod.fused_bwd.launches) == before
    meta = dict(dtype=F32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mod.fused_blend(torch.empty((3, 9, 6, 7), **meta),
                        torch.empty((Q, 2), **meta), cfg)


@pytest.mark.parametrize("loss", ["loss_fused", "loss", "loss_fused_slots"])
def test_exact_mode_takes_f64_matmuls_where_tf32_would_serve(monkeypatch,
                                                             loss):
    """C2: where an f32 matmul would run in TF32 (pinn._tf32: a CUDA
    tensor under torch.set_float32_matmul_precision("high")), every matmul
    of the MLP and its derivative ladder, forward and backward, nested
    autograd included, runs in f64; the loss and gradients equal the f32
    ones to f32 rounding (rtol 1e-6).  Without TF32 the matmuls stay f32."""
    cfg = tpinn.PINNConfig(n_cells=3, cell_dim=4, cell_size=6, hidden=8)
    params = tpinn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    pts = torch.from_numpy(tpointgen.PointGenerator(
        64, 2, seed=0, force_numpy=True).batch(0))
    want_loss, want, dtypes = _loss_and_grads(loss, cfg, params, pts)
    assert dtypes == {F32}
    monkeypatch.setattr(tpinn, "_tf32", lambda t: True)
    got_loss, got, dtypes = _loss_and_grads(loss, cfg, params, pts)
    assert dtypes == {F64}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for k in want:
        assert got[k].dtype == F32
        _close(got[k].numpy(), want[k].numpy(), 1e-6)


def test_tf32_reads_the_global_setting_on_the_card_only():
    """pinn._tf32 follows torch's effective TF32 flag for CUDA tensors and
    is False for CPU ones, whose matmuls TF32 never serves."""
    cpu = torch.zeros(1)
    meta = torch.empty(1, device="meta")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        assert not tpinn._tf32(cpu) and not tpinn._tf32(meta)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_ladder_matches_jax_in_f64():
    """The ladder (einsum contractions through pinn._contract) against the
    JAX package's unrolled-FMA ladder with its nested jvps, f64: u, u_x,
    u_xx to 1e-12."""
    rng = np.random.RandomState(14)
    for dim in (2, 3):
        c, hidden, q = 5, 7, 33
        feats = rng.standard_normal((1 + 2 * dim, c, q))
        params = {"w1": rng.standard_normal((c, hidden)),
                  "b1": rng.standard_normal((hidden,)),
                  "w2": rng.standard_normal((hidden, 1)),
                  "b2": rng.standard_normal((1,))}
        # tests/conftest.py enables x64
        want = jax.tree_util.tree_map(np.asarray, jpinn._mlp_derivs(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(feats), dim))
        got = tpinn._mlp_derivs({k: torch.from_numpy(v)
                                 for k, v in params.items()},
                                torch.from_numpy(feats), dim)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12,
                                   atol=1e-12)
        for k in (1, 2):
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                           atol=1e-12)
