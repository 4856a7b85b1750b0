"""PyTorch port, the public sampler: part 3 of the tests of
tests/test_torch_port_sampler.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import numpy as np
import pytest
import torch

import cosinesampler_tpu as cst
import cosinesampler_tpu_torch as tst
from cosinesampler_tpu_torch.ops import sampler as tsampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sampler import ORDER_CASES, _check_plain_blend_splat_f64


@pytest.mark.parametrize("dim,orders,grid_batch", [
    (2, (0, 0), 1), (2, (1, 0), 2), (3, (0, 1, 0), 1)])
def test_blend_splat_gradcheck_and_gradgradcheck(dim, orders, grid_batch):
    """Finite differences against BlendO / SplatO in f64, first and second
    order, on inputs and grid (queries away from the texel ticks)."""
    rng = np.random.RandomState(1)
    spatial = (4, 5) if dim == 2 else (3, 4, 3)
    lead = (1,) * (dim - 1)
    q = 3 if dim == 2 else 2
    cells = torch.tensor(rng.rand(2, 1, *spatial), requires_grad=True)
    grid = torch.tensor(rng.uniform(-0.8, 0.8, (grid_batch, *lead, q, dim)),
                        requires_grad=True)
    gout = torch.tensor(rng.rand(2, 1, *lead, q), requires_grad=True)
    cfg = TConfig(dim=dim)

    def blend(c, g):
        return tsampler.BlendO.apply(c, g, cfg, orders)

    def splat(o, g):
        return tsampler.SplatO.apply(o, g, spatial, cfg, orders)

    assert torch.autograd.gradcheck(blend, (cells, grid))
    assert torch.autograd.gradgradcheck(blend, (cells, grid))
    assert torch.autograd.gradcheck(splat, (gout, grid))
    assert torch.autograd.gradgradcheck(splat, (gout, grid))


def test_exports_cover_the_jax_api():
    assert set(cst.__all__) <= set(tst.__all__)
    from cosinesampler_tpu import ops as jops
    from cosinesampler_tpu_torch import ops as tops
    assert set(jops.__all__) <= set(tops.__all__)


@pytest.mark.parametrize("grid_batch", ["shared", "per-cell"])
@pytest.mark.parametrize("dim,kernel,padding,multicell,orders",
                         ORDER_CASES[10:13])
def test_plain_blend_splat_match_jax_f64(dim, kernel, padding, multicell,
                                         orders, grid_batch):
    """ORDER_CASES[10:13] (tests/test_torch_port_sampler.py)."""
    _check_plain_blend_splat_f64(dim, kernel, padding, multicell, orders,
                                 grid_batch)
