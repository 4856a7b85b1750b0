"""PyTorch port, the public sampler: part 5 of the tests of
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
import cosinesampler_tpu_torch as tst
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import blend_splat
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sampler import C, F32, F64, N_CELL, _BAD, _close, _data


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_shims_match_jax(dim):
    cells, grid, _ = _data(dim, 7, grid_batch=N_CELL)
    args = ("border", False, "smooth-step", True)
    shim_j = cst.CosineSampler2d if dim == 2 else cst.CosineSampler3d
    shim_t = tst.CosineSampler2d if dim == 2 else tst.CosineSampler3d
    want = shim_j.apply(jnp.asarray(cells), jnp.asarray(grid), *args)
    got = shim_t.apply(torch.tensor(cells), torch.tensor(grid), *args)
    assert tuple(got.shape) == want.shape
    _close(got.numpy(), want, 1e-10)
    fn = tst.cosine_sampler_2d if dim == 2 else tst.cosine_sampler_3d
    xla = fn(torch.tensor(cells), torch.tensor(grid), *args, backend="xla",
             precision="highest")
    torch.testing.assert_close(xla, got, rtol=0, atol=0)


@pytest.mark.parametrize("in_shape,grid_shape", _BAD)
def test_validate_messages_equal_jax(in_shape, grid_shape):
    with pytest.raises(ValueError) as want:
        cst.sample(jnp.zeros(in_shape), jnp.zeros(grid_shape),
                   JConfig(dim=2, backend="xla"))
    with pytest.raises(ValueError) as got:
        tst.sample(torch.zeros(in_shape, dtype=F64),
                   torch.zeros(grid_shape, dtype=F64), TConfig(dim=2))
    assert str(got.value) == str(want.value)


def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    cells, grid, gout = _data(2, 9, dtype=np.float32)
    cfg = TConfig(dim=2, padding_mode="reflection")
    tc, tg, to = (torch.tensor(a) for a in (cells, grid, gout))
    before = (blend_splat.blend.launches, blend_splat.splat.launches)
    torch.testing.assert_close(blend_splat.blend(tc, tg, cfg, (1, 2)),
                               tgeneric.blend(tc, tg, cfg, (1, 2)),
                               rtol=0, atol=0)
    torch.testing.assert_close(blend_splat.splat(to, tg, (8, 8), cfg, (1, 2)),
                               tgeneric.splat(to, tg, (8, 8), cfg, (1, 2)),
                               rtol=0, atol=0)
    u = tst.sample(tc, tg, cfg)
    assert u.dtype == F32
    assert (blend_splat.blend.launches, blend_splat.splat.launches) == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) meta tensors must raise, not take the plain version."""
    cfg = TConfig(dim=2)
    cells = torch.empty((N_CELL, C, 8, 8), dtype=F32, device="meta")
    grid = torch.empty((1, 1, 16, 2), dtype=F32, device="meta")
    gout = torch.empty((N_CELL, C, 1, 16), dtype=F32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.blend(cells, grid, cfg, (0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.splat(gout, grid, (8, 8), cfg, (0, 0))
    with pytest.raises(ValueError, match="CUDA"):
        blend_splat.blend(cells, torch.zeros((1, 1, 16, 2), dtype=F32), cfg,
                          (0, 0))


@pytest.mark.parametrize("tensor,exc,match", [
    (torch.zeros((2, 2), dtype=F64), TypeError, "backend='xla'"),
    (torch.zeros((2, 4), dtype=F32)[:, ::2], ValueError, "contiguous"),
])
def test_kernel_input_checks_reject(tensor, exc, match):
    with pytest.raises(exc, match=match):
        blend_splat._check_tensors(tensor)
