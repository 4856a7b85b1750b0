"""PyTorch port, the binned per-cell route: part 2 of the tests of
tests/test_torch_port_percell.py, which holds their helpers. The tests
are split into files of at most 10, which xdist's loadfile queue
(ordered by test count) runs beside tests/test_sharding.py rather than
ahead of it.
"""

import numpy as np
import pytest
import torch

from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import percell
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_percell import SHAPE, _close, _data


@pytest.mark.parametrize("per_cell", [True, False], ids=["per-cell",
                                                         "shared"])
@pytest.mark.parametrize("kw,orders", [
    (dict(), (0, 0, 0)),
    (dict(padding_mode="reflection"), (3, 0, 0)),
    (dict(padding_mode="border", multicell=False), (1, 1, 1)),
    (dict(kernel="smoothstep", align_corners=False), (0, 2, 1)),
    (dict(padding_mode="reflection", strict_reference=True,
          multicell=False), (0, 0, 2)),
])
def test_plain_percell_matches_generic_f64(kw, orders, per_cell):
    """Both plain versions against generic.blend / generic.splat in f64 at
    rtol 1e-10, points to +-1.7 (far out-of-bounds queries included)."""
    cells, grid, g = (torch.from_numpy(a) for a in _data(
        2, per_cell, -1.7, 1.7, np.float64))
    cfg = TConfig(dim=3, **kw)
    plan = percell.make_plan(grid, cells.shape, cfg)
    _close(percell.plain_blend_percell(cells, grid, cfg, orders, plan),
           tgeneric.blend(cells, grid, cfg, orders), 1e-10)
    _close(percell.plain_splat_percell(g, grid, SHAPE, cfg, orders, plan),
           tgeneric.splat(g, grid, SHAPE, cfg, orders), 1e-10)
