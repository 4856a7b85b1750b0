"""PyTorch port, the public sampler: part 6 of the tests of
tests/test_torch_port_sampler.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import pytest

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_sampler import (LINEAR_CASES,
                                     _check_linear_matches_grid_sample)


@pytest.mark.parametrize("dim,padding_mode,align_corners",
                         LINEAR_CASES[0:6])
def test_linear_no_multicell_matches_torch_grid_sample(dim, padding_mode,
                                                       align_corners):
    """LINEAR_CASES[0:6] (tests/test_torch_port_sampler.py): linear
    without multicell is grid_sample."""
    _check_linear_matches_grid_sample(dim, padding_mode, align_corners)
