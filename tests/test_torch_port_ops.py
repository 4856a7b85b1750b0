"""PyTorch port, core ops: config, interpolants, coords and the plain
blend/splat, held to the JAX package on the same NumPy inputs (f64)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import coords as jcoords
from cosinesampler_tpu.ops import generic as jgeneric
from cosinesampler_tpu.ops import interpolants as jinterp
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.config import effective_align as j_effective_align
from cosinesampler_tpu_torch.ops import coords as tcoords
from cosinesampler_tpu_torch.ops import generic as tgeneric
from cosinesampler_tpu_torch.ops import interpolants as tinterp
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.config import effective_align

KERNELS = ("cosine", "linear", "smoothstep")
PADDINGS = ("zeros", "border", "reflection")


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().cpu().numpy())


# --- config -----------------------------------------------------------------

@pytest.mark.parametrize("alias,canon", [
    ("bilinear", "linear"), ("trilinear", "linear"), ("linear", "linear"),
    ("smooth-step", "smoothstep"), ("smoothstep", "smoothstep"),
    ("cosine", "cosine")])
def test_config_kernel_aliases(alias, canon):
    assert TConfig(dim=2, kernel=alias).kernel == canon
    assert JConfig(dim=2, kernel=alias).kernel == canon


@pytest.mark.parametrize("kwargs", [
    {"dim": 4}, {"dim": 2, "kernel": "cubic"},
    {"dim": 2, "padding_mode": "wrap"}, {"dim": 2, "backend": "cuda"},
    {"dim": 2, "precision": "tf32"}])
def test_config_rejects_like_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        TConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_config_enums_match():
    from cosinesampler_tpu.ops import config as jc
    from cosinesampler_tpu_torch.ops import config as tc
    assert (tc.PADDING_MODES, tc.BACKENDS, tc.PRECISIONS) == (
        jc.PADDING_MODES, jc.BACKENDS, jc.PRECISIONS)
    assert tinterp.KERNELS == jinterp.KERNELS


@pytest.mark.parametrize("strict,dim,align", list(itertools.product(
    (False, True), (2, 3), (False, True))))
def test_effective_align_matches(strict, dim, align):
    kw = dict(dim=dim, align_corners=align, strict_reference=strict)
    for orders in [(0,) * dim, (1,) + (0,) * (dim - 1), (0,) * (dim - 1) + (2,)]:
        assert effective_align(TConfig(**kw), orders) == j_effective_align(
            JConfig(**kw), orders)


# --- interpolants -----------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_weights_match_f64(kernel):
    t = np.random.RandomState(0).uniform(0.0, 1.0, 512)
    t[:4] = (0.0, 1.0, 0.5, 0.25)
    for order in range(4):
        want = np.asarray(jinterp.kernel_weight(kernel, jnp.asarray(t), order))
        got = tinterp.kernel_weight(kernel, torch.tensor(t), order)
        assert got.dtype == torch.float64
        if kernel == "cosine":
            # XLA's and PyTorch's f64 cos differ in the last bit at a few t
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=4 * np.finfo(np.float64).eps * 0.5 * np.pi**order)
        else:
            _bits_equal(want, got)
        for w_j, w_t in zip(jinterp.corner_weights(kernel, jnp.asarray(t), order),
                            tinterp.corner_weights(kernel, torch.tensor(t), order)):
            np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                                       atol=1e-14 * max(1.0, np.pi**order))


def test_kernel_weight_errors():
    with pytest.raises(ValueError):
        tinterp.kernel_weight("cosine", torch.zeros(2), -1)
    with pytest.raises(ValueError):
        tinterp.canonical_kernel("cubic")


# --- coords -----------------------------------------------------------------

@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("align", (True, False))
@pytest.mark.parametrize("multicell", (True, False))
def test_source_coords_bit_equal_f64(padding, align, multicell):
    rng = np.random.RandomState(1)
    x = rng.uniform(-3.0, 3.0, 400)
    x[:5] = (-1.0, 1.0, 0.0, -3.0, 3.0)
    off = rng.uniform(0.0, 1.0, 400)
    for size, strict in ((7, False), (7, True), (16, False), (2, False)):
        want = jcoords.compute_source_coords(
            jnp.asarray(x), size, padding, align, multicell, jnp.asarray(off),
            strict=strict)
        got = tcoords.compute_source_coords(
            torch.tensor(x), size, padding, align, multicell, torch.tensor(off),
            strict=strict)
        for w, g in zip(want, got):
            _bits_equal(w, g)


def test_reflect_and_clip_bit_equal_f64():
    x = np.random.RandomState(2).uniform(-40.0, 40.0, 1000)
    for lo, hi in ((0, 10), (-1, 13), (0, 0), (-1, 1)):
        for w, g in zip(jcoords.reflect_coordinates(jnp.asarray(x), lo, hi),
                        tcoords.reflect_coordinates(torch.tensor(x), lo, hi)):
            _bits_equal(w, g)
    for w, g in zip(jcoords.clip_coordinates(jnp.asarray(x), 9),
                    tcoords.clip_coordinates(torch.tensor(x), 9)):
        _bits_equal(w, g)


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.float64, jnp.float64)])
def test_multicell_offsets_bit_equal(tdtype, jdtype):
    """torch.linspace / np.linspace differ from jnp.linspace in the last bit
    for most N (68 of 96 f32 offsets at N = 96); the port reproduces the
    JAX values exactly, since a one-ulp offset flips corner floors."""
    for n in (1, 2, 3, 5, 7, 8, 16, 31, 50, 64, 95, 96, 97, 128, 250, 1000):
        want = jcoords.multicell_offsets(n, True, jdtype)
        got = tcoords.multicell_offsets(n, True, tdtype)
        assert got.dtype == tdtype
        _bits_equal(want, got)
    _bits_equal(jcoords.multicell_offsets(5, False, jdtype),
                tcoords.multicell_offsets(5, False, tdtype))
    # the trap itself: torch.linspace really does differ at N = 96
    lin = torch.linspace(0.0, 1.0 - 1.0 / 96, 96, dtype=torch.float32).numpy()
    assert (lin != tcoords.multicell_offsets(96, True, torch.float32).numpy()
            ).sum() > 0


def test_port_ignores_default_dtype():
    """tests/test_torch_parity.py sets the process default dtype to f64 at
    import; the port must pass dtype= everywhere and keep f32 results."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        cfg = TConfig(dim=2)
        rng = np.random.RandomState(3)
        cells = torch.tensor(rng.rand(3, 2, 5, 5), dtype=torch.float32)
        pts = torch.tensor(rng.uniform(-1, 1, (17, 2)), dtype=torch.float32)
        assert tcoords.multicell_offsets(3, True, torch.float32).dtype == \
            torch.float32
        out = tgeneric.blend(cells, pts.reshape(1, 1, 17, 2), cfg, (1, 0))
        assert out.dtype == torch.float32
        back = tgeneric.splat(out, pts.reshape(1, 1, 17, 2), (5, 5), cfg,
                              (0, 2))
        assert back.dtype == torch.float32
    finally:
        torch.set_default_dtype(old)


# --- generic blend / splat --------------------------------------------------

def _check_blend_splat(dim, cells, grid, gout, orders_list, **kw):
    jcfg, tcfg = JConfig(dim=dim, **kw), TConfig(dim=dim, **kw)
    spatial = cells.shape[2:]
    for orders in orders_list:
        want = jgeneric.blend(jnp.asarray(cells), jnp.asarray(grid), jcfg,
                              orders)
        got = tgeneric.blend(torch.tensor(cells), torch.tensor(grid), tcfg,
                             orders)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)
        want = jgeneric.splat(jnp.asarray(gout), jnp.asarray(grid), spatial,
                              jcfg, orders)
        got = tgeneric.splat(torch.tensor(gout), torch.tensor(grid), spatial,
                             tcfg, orders)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("multicell", (True, False))
def test_generic_blend_splat_match_jax_f64(kernel, padding, multicell):
    """2D per-cell grids with out-of-bounds queries, every order <= 2 on
    each axis."""
    rng = np.random.RandomState(4)
    _check_blend_splat(
        2, rng.rand(3, 2, 6, 5), rng.uniform(-1.3, 1.3, (3, 4, 7, 2)),
        rng.rand(3, 2, 4, 7), list(itertools.product(range(3), repeat=2)),
        kernel=kernel, padding_mode=padding, multicell=multicell)


@pytest.mark.parametrize("padding", PADDINGS)
def test_generic_blend_splat_3d_shared_points_f64(padding):
    """3D, a query cloud shared by all cells, align_corners=False, total
    order <= 2."""
    rng = np.random.RandomState(6)
    orders = [o for o in itertools.product(range(3), repeat=3) if sum(o) <= 2]
    _check_blend_splat(
        3, rng.rand(2, 2, 4, 5, 3), rng.uniform(-1.3, 1.3, (1, 1, 1, 20, 3)),
        rng.rand(2, 2, 1, 1, 20), orders, padding_mode=padding,
        align_corners=False)


def test_generic_strict_forward_quirk_matches_jax():
    """strict_reference + align_corners=False: the order-0 2D blend uses
    align=True, every derivative order and the splat the real flag."""
    rng = np.random.RandomState(5)
    _check_blend_splat(
        2, rng.rand(3, 2, 6, 5), rng.uniform(-1.3, 1.3, (3, 4, 7, 2)),
        rng.rand(3, 2, 4, 7), [(0, 0), (1, 0), (0, 2)], align_corners=False,
        strict_reference=True, padding_mode="reflection")
