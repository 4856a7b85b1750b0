"""PyTorch port, fused op: the fused blend/bwd and its autograd Function,
held to the JAX package's fused op on the same NumPy inputs (f32).

On the CPU the kernel wrappers take their plain versions; the CUDA kernels
themselves are compared with those on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosinesampler_tpu.ops import fused as jfused
from cosinesampler_tpu.ops.config import SamplerConfig as JConfig
from cosinesampler_tpu.ops.pallas.fused2w import (pallas_fused2w_blend,
                                                  pallas_fused2w_bwd)
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig as TConfig
from cosinesampler_tpu_torch.ops.cuda import build, fused2w

N, C, H, W, Q = 5, 3, 6, 7, 150
# explicit everywhere: tests/test_torch_parity.py sets an f64 default dtype
# in every process that collects it
F32 = torch.float32

CONFIGS = [
    dict(kernel="cosine", padding_mode="zeros"),
    dict(kernel="cosine", padding_mode="border", align_corners=False),
    dict(kernel="cosine", padding_mode="reflection"),
    dict(kernel="linear", padding_mode="zeros", multicell=False),
    dict(kernel="smoothstep", padding_mode="reflection", multicell=False,
         align_corners=False),
    dict(kernel="smoothstep", padding_mode="border"),
]


def _data(seed, lo=-1.2, hi=1.2, spatial=(H, W)):
    rng = np.random.RandomState(seed)
    cells = rng.rand(N, C, *spatial).astype(np.float32)
    pts = rng.uniform(lo, hi, (Q, 2)).astype(np.float32)
    g = rng.standard_normal((5, C, Q)).astype(np.float32)
    return cells, pts, g


def _close(got, want, rtol):
    """rtol against each element, with an absolute floor of rtol times the
    largest magnitude (elements that cancel to ~0 carry f32 noise)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_fused_op_and_cells_grad_match_jax(kw):
    """Features at rtol 1e-5 and the cells gradient at rtol 1e-4 (f32,
    different summation order), out-of-bounds queries included."""
    cells, pts, g = _data(0)
    jcfg, tcfg = JConfig(dim=2, **kw), TConfig(dim=2, **kw)
    want, vjp = jax.vjp(
        lambda c: jfused.sample_features_with_derivs(c, jnp.asarray(pts), jcfg),
        jnp.asarray(cells))
    (want_dc,) = vjp(jnp.asarray(g))

    tc = torch.tensor(cells, requires_grad=True)
    got = tfused.sample_features_with_derivs(tc, torch.tensor(pts), tcfg)
    (got * torch.tensor(g)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (5, C, Q)
    _close(got.detach().numpy(), want, 1e-5)
    _close(tc.grad.numpy(), want_dc, 1e-4)


@pytest.mark.parametrize("padding", ("zeros", "border", "reflection"))
def test_plain_fused_matches_pallas_fused2w_interpret(padding):
    """The plain versions against the TPU kernels themselves, run in
    interpret mode, at the tolerance of the JAX package's own fused2w
    tests (the TPU kernels use polynomial trig and split-bf16 MXU sums)."""
    cells, pts, g = _data(1, lo=-1.3, hi=1.3)
    pts, g = pts[:64], np.ascontiguousarray(g[..., :64])   # one query block
    jcfg = JConfig(dim=2, padding_mode=padding, backend="pallas")
    tcfg = TConfig(dim=2, padding_mode=padding)
    want = pallas_fused2w_blend(jnp.asarray(cells), jnp.asarray(pts), jcfg,
                                q_block=64, interpret=True)
    got = fused2w.plain_fused_blend(torch.tensor(cells), torch.tensor(pts),
                                    tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-4)
    want_b = pallas_fused2w_bwd(jnp.asarray(g), jnp.asarray(pts), (H, W), jcfg,
                                N, q_block=64, interpret=True)
    got_b = fused2w.plain_fused_bwd(torch.tensor(g), torch.tensor(pts), (H, W),
                                    tcfg, N)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=3e-4,
                               atol=1e-4 * float(np.abs(want_b).max()))


def test_plain_bwd_is_transpose_of_blend():
    """<blend(cells), g> == <cells, bwd(g)> in f64."""
    cells, pts, g = _data(2)
    cfg = TConfig(dim=2, padding_mode="reflection")
    c64, p64, g64 = (torch.tensor(a, dtype=torch.float64)
                     for a in (cells, pts, g))
    lhs = (fused2w.plain_fused_blend(c64, p64, cfg) * g64).sum()
    rhs = (c64 * fused2w.plain_fused_bwd(g64, p64, (H, W), cfg, N)).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_padded_identity_plan_matches_query_order():
    cells, pts, _ = _data(3)
    cfg = TConfig(dim=2)
    tc, tp = torch.tensor(cells), torch.tensor(pts)
    assert tfused.make_sample_plan(tp, tc.shape, cfg) is None
    out, occ, positions = tfused.sample_features_padded(tc, tp, cfg)
    ref = tfused.sample_features_with_derivs(tc, tp, cfg)
    torch.testing.assert_close(out[:, :, positions], ref, rtol=0, atol=0)
    assert occ.shape == (Q,) and bool((occ == 1).all())
    torch.testing.assert_close(positions, torch.arange(Q))
    with pytest.raises(ValueError):
        tfused.sample_features_padded(tc, tp, cfg, plan=(positions, occ))
    with pytest.raises(ValueError):
        tfused.make_sample_plan(tp[:, :1], tc.shape, cfg)


@pytest.mark.parametrize("kw", [dict(), dict(padding_mode="reflection",
                                             kernel="smoothstep")],
                         ids=["main-path", "reflection-smoothstep"])
def test_points_cotangent_matches_jax(kw):
    """The fused op's points cotangent (order-bumped blends) against
    jax.grad of the JAX fused op with respect to the points, f64, plain
    path on both sides."""
    cells, pts, g = (a.astype(np.float64) for a in _data(4, lo=-0.95,
                                                           hi=0.95))
    jcfg = JConfig(dim=2, backend="xla", **kw)
    want_dc, want_dp = jax.grad(
        lambda c, p: (jfused.sample_features_with_derivs(c, p, jcfg)
                      * jnp.asarray(g)).sum(), argnums=(0, 1))(
        jnp.asarray(cells), jnp.asarray(pts))
    tc = torch.tensor(cells, requires_grad=True)
    tp = torch.tensor(pts, requires_grad=True)
    out = tfused.sample_features_with_derivs(tc, tp, TConfig(dim=2, **kw))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), want_dp, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dp).max()))
    np.testing.assert_allclose(tc.grad.numpy(), want_dc, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dc).max()))
    # only the points: no cells cotangent is formed
    tp.grad = None
    out = tfused.sample_features_with_derivs(torch.tensor(cells), tp,
                                             TConfig(dim=2, **kw))
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), want_dp, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want_dp).max()))


def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    cells, pts, g = _data(5)
    cfg = TConfig(dim=2, padding_mode="border")
    before = (fused2w.fused_blend.launches, fused2w.fused_bwd.launches)
    tc, tp, tg = torch.tensor(cells), torch.tensor(pts), torch.tensor(g)
    torch.testing.assert_close(fused2w.fused_blend(tc, tp, cfg),
                               fused2w.plain_fused_blend(tc, tp, cfg),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused2w.fused_bwd(tg, tp, (H, W), cfg, N),
                               fused2w.plain_fused_bwd(tg, tp, (H, W), cfg, N),
                               rtol=0, atol=0)
    assert (fused2w.fused_blend.launches, fused2w.fused_bwd.launches) == before


def test_backend_xla_takes_plain_path():
    cells, pts, _ = _data(6)
    tc, tp = torch.tensor(cells), torch.tensor(pts)
    got = tfused.sample_features_with_derivs(tc, tp, TConfig(dim=2,
                                                             backend="xla"))
    torch.testing.assert_close(got, fused2w.plain_fused_blend(
        tc, tp, TConfig(dim=2)), rtol=0, atol=0)


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here (no CUDA
    device) a meta tensor must raise, not take the plain version."""
    cells = torch.empty((N, C, H, W), dtype=F32, device="meta")
    pts = torch.empty((Q, 2), dtype=F32, device="meta")
    g = torch.empty((5, C, Q), dtype=F32, device="meta")
    cfg = TConfig(dim=2)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_blend(cells, pts, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_bwd(g, pts, (H, W), cfg, N)
    with pytest.raises(ValueError, match="CUDA"):
        fused2w.fused_blend(cells, torch.zeros((Q, 2), dtype=F32), cfg)


def _z(*shape, dtype=F32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("kw,tensor,exc", [
    (dict(dim=3), _z(2, 3), NotImplementedError),
    (dict(dim=2, precision="bf16"), _z(2, 2), NotImplementedError),
    (dict(dim=2, precision="fast"), _z(2, 2), NotImplementedError),
    (dict(dim=2, strict_reference=True, align_corners=False), _z(2, 2),
     NotImplementedError),
    (dict(dim=2), _z(2, 2, dtype=torch.float64), TypeError),
    (dict(dim=2), _z(2, 4)[:, ::2], ValueError),
])
def test_kernel_input_checks_reject(kw, tensor, exc):
    with pytest.raises(exc):
        fused2w.check_kernel_inputs(TConfig(**kw), tensor)


def test_kernel_input_checks_accept_main_path():
    fused2w.check_kernel_inputs(
        TConfig(dim=2, precision="highest", strict_reference=True), _z(3, 2))


def test_build_caches_by_content_and_reports_compiler_errors(tmp_path):
    good = tmp_path / "good.cpp"
    good.write_text('extern "C" int answer() { return 42; }\n')
    cmd = ["g++", "-O1", "-shared", "-fPIC"]
    lib = build.build_shared_library("good", [good], cmd, root=tmp_path / "b")
    assert lib.exists()
    assert build.build_shared_library("good", [good], cmd,
                                      root=tmp_path / "b") == lib
    good.write_text('extern "C" int answer() { return 43; }\n')
    assert build.build_shared_library("good", [good], cmd,
                                      root=tmp_path / "b") != lib
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        build.build_shared_library("bad", [bad], cmd, root=tmp_path / "b")
