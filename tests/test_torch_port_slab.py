"""PyTorch port, the slab route of the public sampler: the slab geometry,
the plain slab blend/splat (the CPU side of the slab wrappers) and the 2D
sampler through it, held to the JAX package on the same NumPy inputs.

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas import slab as jslab
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops import sampler as tsampler
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import percell, route, slab
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_CELL, C, Q = 2, 3, 96
F32 = torch.float32


def _spatial(dim):
    # the JAX package's slab test shapes (tests/test_slab.py)
    return (24, 16) if dim == 2 else (24, 12, 16)


def _data(dim, seed, per_cell=True, lo=-1.25, hi=1.25, dtype=np.float32):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N_CELL, C, *_spatial(dim)).astype(dtype)
    lead = (1,) * (dim - 1)
    grid = rng.uniform(lo, hi, (N_CELL if per_cell else 1, *lead, Q, dim)
                       ).astype(dtype)
    gout = rng.standard_normal((N_CELL, C, *lead, Q)).astype(dtype)
    return cells, grid, gout


def _close(got, want, rtol, atol_scale=None):
    want = np.asarray(want)
    scale = rtol if atol_scale is None else atol_scale
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


# --- plain slab vs the Pallas slab kernels, interpret mode, f32 -------------

# the JAX package's small budget (tests/test_slab.py): several slabs and
# channel chunks on its side; dz 5 and 2-channel chunks on the port's
SMALL_BUDGET = 96 * 1024

INTERPRET_CASES = [
    (2, "zeros", (0, 0), True),
    (2, "border", (0, 2), False),
    (2, "reflection", (1, 0), True),
    (3, "zeros", (1, 0, 1), True),
    (3, "reflection", (0, 2, 0), False),
    (3, "border", (0, 0, 0), False),
]


@pytest.mark.parametrize("dim,padding,orders,per_cell", INTERPRET_CASES)
def test_plain_slab_matches_pallas_interpret(dim, padding, orders, per_cell):
    """plain_blend_slab / plain_splat_slab (5-row slabs, channel chunks of
    2) against the JAX package's slab kernels (interpret mode, its small
    budget) on the same f32 inputs, at the v1 family's tolerance (rtol
    3e-4, atol 5e-5 of the largest magnitude, tests/test_slab.py)."""
    cells, grid, gout = _data(dim, 1, per_cell)
    spatial = _spatial(dim)
    jcfg = JConfig(dim=dim, padding_mode=padding)
    tcfg = TConfig(dim=dim, padding_mode=padding)
    assert jslab._pick_geom(C, spatial, SMALL_BUDGET)[0] < spatial[0]
    want = jslab.pallas_blend_slab(jnp.asarray(cells), jnp.asarray(grid),
                                   jcfg, orders, budget=SMALL_BUDGET,
                                   interpret=True)
    got = slab.plain_blend_slab(torch.from_numpy(cells),
                                torch.from_numpy(grid), tcfg, orders, 5, 2)
    _close(got.numpy(), want, 3e-4, 5e-5)
    want_s = jslab.pallas_splat_slab(jnp.asarray(gout), jnp.asarray(grid),
                                     spatial, jcfg, orders,
                                     budget=SMALL_BUDGET, interpret=True)
    got_s = slab.plain_splat_slab(torch.from_numpy(gout),
                                  torch.from_numpy(grid), spatial, tcfg,
                                  orders, 5, 2)
    _close(got_s.numpy(), want_s, 3e-4, 5e-5)


# --- plain slab vs the port's generic, f64 ----------------------------------

@pytest.mark.parametrize("dz,cc", [(1, 1), (5, 2), (7, 3), (40, 3)])
@pytest.mark.parametrize("dim,kw,orders,per_cell", [
    (2, dict(), (0, 0), True),
    (2, dict(padding_mode="reflection", multicell=False), (3, 0), False),
    (2, dict(padding_mode="border", align_corners=False), (1, 2), True),
    (3, dict(), (0, 0, 0), False),
    (3, dict(padding_mode="reflection", kernel="smoothstep"), (0, 0, 3),
     True),
    (3, dict(padding_mode="border", strict_reference=True), (2, 1, 0),
     False),
])
def test_plain_slab_matches_generic_f64(dim, kw, orders, per_cell, dz, cc):
    """Both plain versions against generic.blend / generic.splat in f64 at
    rtol 1e-10 for any slab height (one row, uneven slabs, one slab taller
    than the volume) and channel chunk, points to +-1.7."""
    cells, grid, gout = (torch.from_numpy(a) for a in _data(
        dim, 2, per_cell, -1.7, 1.7, np.float64))
    spatial = _spatial(dim)
    cfg = TConfig(dim=dim, **kw)
    _close(slab.plain_blend_slab(cells, grid, cfg, orders, dz, cc),
           tgeneric.blend(cells, grid, cfg, orders), 1e-10)
    _close(slab.plain_splat_slab(gout, grid, spatial, cfg, orders, dz, cc),
           tgeneric.splat(gout, grid, spatial, cfg, orders), 1e-10)


# --- the geometry -------------------------------------------------------------

def test_geometry_at_the_slice_shapes():
    """Whole channels with the fattest slab first, channels split only
    when one row of all of them (plus the blend's halo row) does not fit
    the H100's 227 KB: the 4-channel 128^2 rows of the 3D volumes split,
    the 1024-wide 2D rows do not."""
    assert slab.SMEM_BYTES == 227 * 1024
    assert slab.geometry(4, (128, 128, 128), 1) == (2, 1)
    assert slab.geometry(4, (128, 128, 128), 0) == (1, 3)
    assert slab.geometry(4, (1024, 1024), 1) == (13, 4)
    assert slab.geometry(4, (1024, 1024), 0) == (14, 4)
    assert slab.geometry(4, (6, 6, 6), 0) == (6, 4)          # one slab
    assert slab.geometry(1, (4, 256, 256), 1) is None         # 256 KB rows
    assert slab.supports(TConfig(dim=3), (4, 4, 128, 128, 128))
    assert not slab.supports(TConfig(dim=3), (4, 1, 4, 256, 256))


def test_small_budget_splits_slabs_and_channels(monkeypatch):
    """The wrappers on the CPU take the plain versions on the geometry of
    SMEM_BYTES: with a small budget, several slabs and channel chunks, the
    same numbers as generic's (f64, rtol 1e-10)."""
    monkeypatch.setattr(slab, "SMEM_BYTES", 2000)
    spatial = _spatial(3)
    assert slab.geometry(C, spatial, 1) == (1, 1)
    assert slab.geometry(C, spatial, 0) == (1, 2)
    cells, grid, gout = (torch.from_numpy(a) for a in _data(
        3, 3, True, dtype=np.float64))
    cfg = TConfig(dim=3, padding_mode="reflection")
    _close(slab.blend(cells, grid, cfg, (1, 0, 0)),
           tgeneric.blend(cells, grid, cfg, (1, 0, 0)), 1e-10)
    _close(slab.splat(gout, grid, spatial, cfg, (0, 2, 0)),
           tgeneric.splat(gout, grid, spatial, cfg, (0, 2, 0)), 1e-10)


# --- the wrappers -------------------------------------------------------------

def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    cells, grid, gout = (torch.from_numpy(a) for a in _data(3, 4))
    cfg = TConfig(dim=3)
    spatial = _spatial(3)
    plan = percell.make_plan(grid, cells.shape, cfg)
    before = [f.launches for f in (slab.blend, slab.splat, percell.blend,
                                   percell.splat)]
    dz, cc = slab.geometry(C, spatial, 1)
    torch.testing.assert_close(
        slab.blend(cells, grid, cfg, (0, 1, 0)),
        slab.plain_blend_slab(cells, grid, cfg, (0, 1, 0), dz, cc),
        rtol=0, atol=0)
    dz, cc = slab.geometry(C, spatial, 0)
    torch.testing.assert_close(
        slab.splat(gout, grid, spatial, cfg, (0, 1, 0)),
        slab.plain_splat_slab(gout, grid, spatial, cfg, (0, 1, 0), dz, cc),
        rtol=0, atol=0)
    torch.testing.assert_close(
        percell.blend(cells, grid, cfg, (2, 0, 0), plan),
        percell.plain_blend_percell(cells, grid, cfg, (2, 0, 0), plan),
        rtol=0, atol=0)
    torch.testing.assert_close(
        percell.splat(gout, grid, spatial, cfg, (2, 0, 0), plan),
        percell.plain_splat_percell(gout, grid, spatial, cfg, (2, 0, 0),
                                    plan), rtol=0, atol=0)
    assert [f.launches for f in (slab.blend, slab.splat, percell.blend,
                                 percell.splat)] == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) meta tensors must raise, not take the plain version."""
    cfg = TConfig(dim=3)
    spatial = _spatial(3)
    cells = torch.empty((N_CELL, C, *spatial), dtype=F32, device="meta")
    grid = torch.empty((N_CELL, 1, 1, Q, 3), dtype=F32, device="meta")
    gout = torch.empty((N_CELL, C, 1, 1, Q), dtype=F32, device="meta")
    plan = percell.make_plan(torch.zeros((N_CELL, 1, 1, Q, 3)),
                             cells.shape, cfg)
    for call in (lambda: slab.blend(cells, grid, cfg, (0, 0, 0)),
                 lambda: slab.splat(gout, grid, spatial, cfg, (0, 0, 0)),
                 lambda: percell.blend(cells, grid, cfg, (0, 0, 0), plan),
                 lambda: percell.splat(gout, grid, spatial, cfg, (0, 0, 0),
                                       plan)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_percell_plan_must_match_the_call():
    cells, grid, _ = (torch.from_numpy(a) for a in _data(3, 5))
    cfg = TConfig(dim=3)
    plan = percell.make_plan(grid[:, :, :, :50], cells.shape, cfg)
    with pytest.raises(ValueError, match="pair plan"):
        percell.blend(cells, grid, cfg, (0, 0, 0), plan)


# --- the 2D sampler through the slab route ------------------------------------

def test_2d_sample_and_cell_gradient_through_slab_match_jax(monkeypatch):
    """The 2D per-cell surface through the slab route (small budget: 1-row
    slabs of one channel in the blend), f64: sample() and the cell
    gradient of a quadratic loss against the JAX package's generic.blend
    and its jax.grad, at rtol 1e-10."""
    monkeypatch.setattr(route, "pick", lambda *args: "slab")
    monkeypatch.setattr(slab, "SMEM_BYTES", 130)
    assert slab.geometry(C, _spatial(2), 1) == (1, 1)
    cells, grid, _ = _data(2, 6, True, dtype=np.float64)
    cfg = dict(padding_mode="border", kernel="smoothstep")
    want = jgeneric.blend(jnp.asarray(cells), jnp.asarray(grid),
                          JConfig(dim=2, **cfg), (0, 0))
    want_g = jax.grad(lambda c: (jgeneric.blend(
        c, jnp.asarray(grid), JConfig(dim=2, **cfg), (0, 0)) ** 2).sum())(
        jnp.asarray(cells))
    tc = torch.tensor(cells, requires_grad=True)
    out = tsampler.sample(tc, torch.from_numpy(grid), TConfig(dim=2, **cfg))
    (out ** 2).sum().backward()
    _close(out.detach().numpy(), want, 1e-10)
    _close(tc.grad.numpy(), want_g, 1e-10)
