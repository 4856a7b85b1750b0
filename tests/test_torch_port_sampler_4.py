"""PyTorch port, the public sampler: part 4 of the tests of
tests/test_torch_port_sampler.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosinesampler_tpu as cst
import cosinesampler_tpu.ops.pallas as jpallas
import cosinesampler_tpu_torch as tst
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.kernels import pallas_blend, pallas_splat
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import blend_splat
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sampler import (C, F64, N_CELL, _chain_jax, _chain_torch,
                                     _close, _data, _spatial)


@pytest.mark.parametrize("dim,axis,kw", [
    (2, 0, dict()), (2, 1, dict(padding_mode="reflection")),
    (3, 0, dict()), (3, 2, dict(kernel="smoothstep", padding_mode="border",
                                multicell=False))])
def test_nested_chain_matches_jax_f64(dim, axis, kw):
    """u_ax, u_axax and u_axax_cell (third order) against the JAX package's
    nested jax.grad, at the JAX package's own chain tolerance."""
    cells, grid, _ = _data(dim, 2)
    pts = grid.reshape(-1, dim)
    w = np.random.RandomState(3).rand(C)
    want = _chain_jax(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(w),
                      JConfig(dim=dim, backend="xla", **kw), axis)
    got = _chain_torch(cells, pts, w, TConfig(dim=dim, **kw), axis)
    for a, b, name in zip(got, want, ("u_x", "u_xx", "u_xx_cell")):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("dim,orders", [(2, (0, 0)), (2, (2, 1)),
                                        (3, (0, 0, 0)), (3, (1, 0, 2))])
def test_plain_blend_splat_match_pallas_interpret(dim, orders):
    cells, grid, gout = _data(dim, 4, q=64, lo=-1.3, hi=1.3,
                              grid_batch=N_CELL, dtype=np.float32)
    jcfg = JConfig(dim=dim, backend="pallas")
    tcfg = TConfig(dim=dim)
    want = pallas_blend(jnp.asarray(cells), jnp.asarray(grid), jcfg, orders,
                        q_block=64, interpret=True)
    got = blend_splat.blend(torch.tensor(cells), torch.tensor(grid), tcfg,
                            orders)
    _close(got.numpy(), want, 3e-4, 5e-5)
    spatial = _spatial(dim)
    want_s = pallas_splat(jnp.asarray(gout), jnp.asarray(grid), spatial, jcfg,
                          orders, q_block=64, interpret=True)
    got_s = blend_splat.splat(torch.tensor(gout), torch.tensor(grid), spatial,
                              tcfg, orders)
    _close(got_s.numpy(), want_s, 3e-4, 5e-5)


def test_nested_chain_matches_pallas_interpret(monkeypatch):
    """The third-order chain through the TPU kernels themselves (interpret
    mode) against the port's chain, both f32: u_x at the blend/splat
    tolerance, u_xx and u_xx_cell at the JAX package's third-order one."""
    monkeypatch.setattr(jpallas, "INTERPRET", True)
    cells, grid, _ = _data(2, 5, q=16, dtype=np.float32)
    pts = grid.reshape(-1, 2)
    w = np.random.RandomState(6).rand(C).astype(np.float32)
    want = _chain_jax(jnp.asarray(cells), jnp.asarray(pts), jnp.asarray(w),
                      JConfig(dim=2, backend="pallas"), 0)
    got = _chain_torch(cells, pts, w, TConfig(dim=2), 0)
    _close(got[0], want[0], 3e-4, 5e-5)
    _close(got[1], want[1], 5e-4)
    _close(got[2], want[2], 5e-4)


def test_validate_message_3d_equal_jax():
    with pytest.raises(ValueError) as want:
        cst.cosine_sampler_3d(jnp.zeros((2, 1, 4, 4)),
                              jnp.zeros((2, 1, 4, 4, 3)))
    with pytest.raises(ValueError) as got:
        tst.cosine_sampler_3d(torch.zeros((2, 1, 4, 4), dtype=F64),
                              torch.zeros((2, 1, 4, 4, 3), dtype=F64))
    assert str(got.value) == str(want.value)
