"""PyTorch port, the public sampler: part 2 of the tests of
tests/test_torch_port_sampler.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sampler import ORDER_CASES, _check_plain_blend_splat_f64


@pytest.mark.parametrize("grid_batch", ["shared", "per-cell"])
@pytest.mark.parametrize("dim,kernel,padding,multicell,orders",
                         ORDER_CASES[5:10])
def test_plain_blend_splat_match_jax_f64(dim, kernel, padding, multicell,
                                         orders, grid_batch):
    """ORDER_CASES[5:10] (tests/test_torch_port_sampler.py)."""
    _check_plain_blend_splat_f64(dim, kernel, padding, multicell, orders,
                                 grid_batch)
