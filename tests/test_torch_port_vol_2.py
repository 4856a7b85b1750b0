"""PyTorch port, the slot-resident and vol-resident fused op (fused3b):
part 2 of the tests of tests/test_torch_port_vol.py, which holds their
helpers. The tests are split into files of at most 10, which xdist's
loadfile queue (ordered by test count) runs beside
tests/test_sharding.py rather than ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import fused3b
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_vol import C, N, S, _close, _points


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("kernel", ["cosine", "linear", "smoothstep"])
def test_plain_vol_ops_match_jax_f64(kernel, padding):
    """The plain vol blend and bwd in f64 against the JAX package's
    xla_fused_blend / xla_fused_bwd placed in slot order by the same
    positions, at rtol 1e-10; out-of-bounds queries included."""
    rng = np.random.RandomState(3)
    cells = rng.rand(N, C, *S)
    pts = _points(4)
    jcfg = JConfig(dim=3, kernel=kernel, padding_mode=padding)
    tcfg = TConfig(dim=3, kernel=kernel, padding_mode=padding)
    plan = fused3b.make_plan(torch.tensor(pts), S, tcfg)
    positions, occ = plan[0].numpy(), plan[1].numpy()
    qp = occ.shape[0]
    g_p = rng.standard_normal((7, C, qp))

    want = np.zeros((7, C, qp))
    want[:, :, positions] = jfused.xla_fused_blend(
        jnp.asarray(cells), jnp.asarray(pts), jcfg)
    want_dc = jfused.xla_fused_bwd(jnp.asarray(g_p[:, :, positions]),
                                   jnp.asarray(pts), S, jcfg, N)

    vol = fused3b.cells_to_vol(torch.tensor(cells))
    got = fused3b.plain_fused3b_blend_vol(vol, plan, tcfg)
    assert got.shape == (7, C, qp) and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-10)
    dvol = fused3b.plain_fused3b_bwd_vol(torch.tensor(g_p), plan, S, tcfg, N)
    assert dvol.shape == fused3b.vol_layout(N, C, S)
    _close(fused3b.vol_to_cells(dvol).numpy(), want_dc, 1e-10)


def test_vol_layout_roundtrip_is_an_exact_permutation():
    cells = torch.from_numpy(np.random.RandomState(5).rand(N, C, *S))
    vol = fused3b.cells_to_vol(cells)
    assert vol.shape == fused3b.vol_layout(N, C, S) == (*S, N, C)
    assert vol.numel() == cells.numel()        # no pad slots
    assert vol.is_contiguous()
    assert float(vol[4, 2, 7, 1, 0]) == float(cells[1, 0, 4, 2, 7])
    assert torch.equal(fused3b.vol_to_cells(vol), cells)
