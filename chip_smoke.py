"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card (main-path shapes and small
variants).  Then it drives the port's training paths at full width: the
fused trainer (96 cells x 4 ch x 16 x 16, 100 000 points, hidden 16,
Allen-Cahn) for 20 steps through fused2w_blend / fused2w_bwd, the
megakernel trainer (``megakernel=True``) for 20 steps through mega2w, the
nested-autograd trainer (``fused=False``, the public sampler to third
order) for 10 steps through blend_o / splat_o, the 3D Helmholtz trainer
(50 x 4 x 16^3) for 3 steps nested and 3 steps fused through
fused3w_blend / fused3w_bwd, and the vol-resident trainer of BASELINE
config 5 (16 x 4 x 128^3, 1 000 000 points) for 5 steps through
fused3b_blend / fused3b_bwd.  It checks from the launch counters that each
path went through its kernels and no other, compares the megakernel losses
with the fused ones, the vol-resident losses with the fused3w trainer's,
the nested loss with the fused one and the card with the CPU, and times
kernels, library calls and steps against their plain versions, and the
bricked kernels against fused3w at config 5.  The last lines are a JSON
object
of the kernels, the card's name and power limit as nvidia-smi prints
them, and a JSON status object.  Any failure raises: the script then exits
non-zero and prints no status.  It needs one CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from cosinesampler_tpu_torch.models import pinn
from cosinesampler_tpu_torch.models.train import TrainConfig, train
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops.config import SamplerConfig
from cosinesampler_tpu_torch.ops.cuda import (blend_splat, build, fused2w,
                                              fused3b, fused3w, mega2w)
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

# main path: BASELINE config 3 / bench.py's headline
N, C, H, W, Q = 96, 4, 16, 16, 100_000
HIDDEN = 16
# the reference's test_3d workload
N3, S3 = 50, 16
STEPS, NESTED_STEPS, STEPS_3D = 20, 10, 3
# BASELINE config 5: the vol-resident 3D trainer at full width
N5, S5, Q5, STEPS_VOL = 16, 128, 1_000_000, 5
# kernel vs plain: max |kernel - plain| over the largest |plain| of the row
# (f32, other summation order, f32 atomics in the splats).  A blend_o or
# splat_o launch is one row: order k scales it by (pi * mult)^k, so only an
# error relative to its own magnitude is comparable across orders.
REL_TOL = 1e-4
# nested vs fused, card vs CPU: the reference's own dloss/dcells bar
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
SOURCES = {
    "fused2w_blend": "cosinesampler_tpu_torch/csrc/fused2w.cu",
    "fused2w_bwd": "cosinesampler_tpu_torch/csrc/fused2w.cu",
    "blend_o": "cosinesampler_tpu_torch/csrc/blend_splat.cu",
    "splat_o": "cosinesampler_tpu_torch/csrc/blend_splat.cu",
    "mega2w": "cosinesampler_tpu_torch/csrc/mega2w.cu",
    "fused3w_blend": "cosinesampler_tpu_torch/csrc/fused3w.cu",
    "fused3w_bwd": "cosinesampler_tpu_torch/csrc/fused3w.cu",
    "fused3b_blend": "cosinesampler_tpu_torch/csrc/fused3b.cu",
    "fused3b_bwd": "cosinesampler_tpu_torch/csrc/fused3b.cu",
}
REPLACES = {
    "fused2w_blend": "cosinesampler_tpu/ops/pallas/fused2w.py:276",
    "fused2w_bwd": "cosinesampler_tpu/ops/pallas/fused2w.py:432",
    "blend_o": "cosinesampler_tpu/ops/pallas/kernels.py:102",
    "splat_o": "cosinesampler_tpu/ops/pallas/kernels.py:201",
    "mega2w": "cosinesampler_tpu/ops/pallas/mega2w.py:160",
    "fused3w_blend": "cosinesampler_tpu/ops/pallas/fused3w.py:240",
    "fused3w_bwd": "cosinesampler_tpu/ops/pallas/fused3w.py:396",
    "fused3b_blend": "cosinesampler_tpu/ops/pallas/fused3b.py:481",
    "fused3b_bwd": "cosinesampler_tpu/ops/pallas/fused3b.py:831",
}
# each kernel's launch counter
COUNTERS = {
    "fused2w_blend": fused2w.fused_blend, "fused2w_bwd": fused2w.fused_bwd,
    "blend_o": blend_splat.blend, "splat_o": blend_splat.splat,
    "mega2w": mega2w.mega2w_step,
    "fused3w_blend": fused3w.fused_blend, "fused3w_bwd": fused3w.fused_bwd,
    "fused3b_blend": fused3b.fused3b_blend_vol,
    "fused3b_bwd": fused3b.fused3b_bwd_vol,
}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor)
# FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return card


def build_phase():
    t0 = time.perf_counter()
    build.load_kernels()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)


def _bound(nbytes, flops):
    """Least time (ms) and what sets it: each input read once and each
    output written once at the HBM rate, or the FMAs (2 FLOPs each) at the
    f32 peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def _counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def _rel_err(got, want):
    """(max abs error, max over rows of max abs error / row's max |want|)."""
    diff = (got - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1).clamp_min(1e-30)
    return float(diff.max()), float((diff / scale).max())


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _in_turns(kernel, plain, reps=10):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (_time_ms(fn, reps) for fn in (plain, kernel, kernel,
                                                    plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


# --- fused2w ----------------------------------------------------------------

def _fused_inputs(n, c, h, w, q, seed):
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((n, c, h, w), generator=gen, dtype=torch.float32)
    pts = torch.rand((q, 2), generator=gen, dtype=torch.float32) * 2.4 - 1.2
    g = torch.randn((5, c, q), generator=gen, dtype=torch.float32)
    return [t.cuda() for t in (cells, pts, g)]


def compare(name, cfg, n, c, h, w, q, seed=0):
    """Both fused kernels against their plain versions on the card."""
    cells, pts, g = _fused_inputs(n, c, h, w, q, seed)
    out = fused2w.fused_blend(cells, pts, cfg)
    ref = fused2w.plain_fused_blend(cells, pts, cfg)
    dcells = fused2w.fused_bwd(g, pts, (h, w), cfg, n)
    dref = fused2w.plain_fused_bwd(g, pts, (h, w), cfg, n)
    torch.cuda.synchronize()
    if out.shape != ref.shape or dcells.shape != dref.shape:
        raise RuntimeError(f"{name}: shape mismatch")
    if not (torch.isfinite(out).all() and torch.isfinite(dcells).all()):
        raise RuntimeError(f"{name}: non-finite kernel output")
    abs_b, rel_b = _rel_err(out, ref)
    abs_d, rel_d = _rel_err(dcells.reshape(1, -1), dref.reshape(1, -1))
    print(f"compare {name} ({n}x{c}x{h}x{w}, Q={q}): blend max abs err "
          f"{abs_b:.3e}, rel {rel_b:.3e}; bwd max abs err {abs_d:.3e}, "
          f"rel {rel_d:.3e} (tolerance rel {REL_TOL:g})", flush=True)
    if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return abs_b, abs_d


def kernel_phase():
    main = SamplerConfig(dim=2)
    errs = compare("main-path", main, N, C, H, W, Q)
    small = (8, 3, 12, 10, 4096)
    for name, kw in [
            ("border", dict(padding_mode="border")),
            ("reflection", dict(padding_mode="reflection")),
            ("linear", dict(kernel="linear")),
            ("smoothstep", dict(kernel="smoothstep")),
            ("no-multicell", dict(multicell=False)),
            ("align-false", dict(align_corners=False)),
            ("reflection-align-false-no-multicell",
             dict(padding_mode="reflection", align_corners=False,
                  multicell=False)),
            ("reflection-strict-no-multicell",
             dict(padding_mode="reflection", multicell=False,
                  strict_reference=True))]:
        compare(name, SamplerConfig(dim=2, **kw), *small, seed=1)
    # a cell too large for the shared-memory accumulator: global atomics
    compare("large-cell", main, 2, 4, 128, 128, 4096, seed=2)

    cells, pts, g = _fused_inputs(N, C, H, W, Q, seed=3)
    ops = {
        "fused2w_blend": (lambda: fused2w.fused_blend(cells, pts, main),
                          lambda: fused2w.plain_fused_blend(cells, pts, main)),
        "fused2w_bwd": (lambda: fused2w.fused_bwd(g, pts, (H, W), main, N),
                        lambda: fused2w.plain_fused_bwd(g, pts, (H, W), main,
                                                        N)),
    }
    # 5 rows x 4 corners x C FMAs per (query, cell) pair; the blend reads
    # cells and points and writes (5, C, Q), the bwd the other way round
    flops = 2 * 5 * 4 * C * N * Q
    nbytes = 4 * (N * C * H * W + 2 * Q + 5 * C * Q)
    times = {}
    for name, (kernel, plain) in ops.items():
        ms, plain_ms = _in_turns(kernel, plain)
        bound_ms, bound_by = _bound(nbytes, flops)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        print(f"time {name} at the main path: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of it; no library call computes it",
              flush=True)
    return {"fused2w_blend": errs[0], "fused2w_bwd": errs[1]}, times


# --- blend_o / splat_o --------------------------------------------------------

def _v1_inputs(dim, n, c, spatial, q, seed, grid_batch=1, lo=-1.0, hi=1.0):
    gen = torch.Generator().manual_seed(seed)
    lead = (1,) * (dim - 1)
    x = torch.rand((n, c, *spatial), generator=gen, dtype=torch.float32)
    grid = (torch.rand((grid_batch, *lead, q, dim), generator=gen,
                       dtype=torch.float32) * (hi - lo) + lo)
    gout = torch.randn((n, c, *lead, q), generator=gen, dtype=torch.float32)
    return [t.cuda() for t in (x, grid, gout)]


def compare_v1(name, cfg, n, c, spatial, q, orders_list, seed=0,
               grid_batch=1, lo=-1.0, hi=1.0):
    """blend_o and splat_o against generic.blend / generic.splat on the
    card at each order; returns the largest abs errors."""
    x, grid, gout = _v1_inputs(cfg.dim, n, c, spatial, q, seed, grid_batch,
                               lo, hi)
    worst = [0.0, 0.0]
    for orders in orders_list:
        out = blend_splat.blend(x, grid, cfg, orders)
        ref = blend_splat.plain_blend(x, grid, cfg, orders)
        dx = blend_splat.splat(gout, grid, spatial, cfg, orders)
        dref = blend_splat.plain_splat(gout, grid, spatial, cfg, orders)
        torch.cuda.synchronize()
        if out.shape != ref.shape or dx.shape != dref.shape:
            raise RuntimeError(f"{name} {orders}: shape mismatch")
        if not (torch.isfinite(out).all() and torch.isfinite(dx).all()):
            raise RuntimeError(f"{name} {orders}: non-finite kernel output")
        abs_b, rel_b = _rel_err(out.reshape(1, -1), ref.reshape(1, -1))
        abs_s, rel_s = _rel_err(dx.reshape(1, -1), dref.reshape(1, -1))
        print(f"compare v1 {name} ({n}x{c}x{'x'.join(map(str, spatial))}, "
              f"Q={q}, grid batch {grid_batch}) orders {orders}: blend_o "
              f"abs {abs_b:.3e} rel {rel_b:.3e}; splat_o abs {abs_s:.3e} "
              f"rel {rel_s:.3e}", flush=True)
        if not (rel_b <= REL_TOL and rel_s <= REL_TOL):
            raise RuntimeError(f"{name} {orders}: kernel disagrees with the "
                               "plain version")
        worst = [max(worst[0], abs_b), max(worst[1], abs_s)]
    return worst


def _expect_raise(what, exc, fn):
    try:
        fn()
    except exc as err:
        print(f"raises: {what} -> {type(err).__name__}: {err}", flush=True)
        return
    raise RuntimeError(f"{what} did not raise {exc.__name__}")


def v1_kernel_phase():
    errs = compare_v1("2d-main", SamplerConfig(dim=2), N, C, (H, W), Q,
                      [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (3, 0)])
    compare_v1("3d-main", SamplerConfig(dim=3), N3, C, (S3,) * 3, Q,
               [(0, 0, 0), (0, 0, 1), (2, 0, 0), (1, 1, 1)], seed=1)
    small = (8, 3, (12, 10), 4099)       # Q not a multiple of the block
    orders = [(0, 0), (1, 0), (2, 1)]
    wide = dict(lo=-1.2, hi=1.2)
    for name, kw, extra in [
            ("zeros", {}, {}),
            ("border", dict(padding_mode="border"), {}),
            ("reflection", dict(padding_mode="reflection"), {}),
            ("linear", dict(kernel="linear"), {}),
            ("smoothstep", dict(kernel="smoothstep"), {}),
            ("no-multicell", dict(multicell=False), {}),
            ("align-false", dict(align_corners=False), {}),
            ("strict-align-false", dict(strict_reference=True,
                                        align_corners=False,
                                        padding_mode="reflection"), {}),
            ("grid-batch-n", {}, dict(grid_batch=8))]:
        compare_v1(name, SamplerConfig(dim=2, **kw), *small, orders, seed=2,
                   **wide, **extra)
    for name, kw, extra in [
            ("3d-reflection", dict(padding_mode="reflection"), {}),
            ("3d-border-smoothstep", dict(padding_mode="border",
                                          kernel="smoothstep"), {}),
            ("3d-grid-batch-n", dict(align_corners=False),
             dict(grid_batch=6))]:
        compare_v1(name, SamplerConfig(dim=3, **kw), 6, 3, (7, 8, 9), 4099,
                   [(0, 0, 0), (1, 0, 1)], seed=3, **wide, **extra)
    # cells too large for shared memory even opted in: global atomics
    compare_v1("2d-large-cell", SamplerConfig(dim=2), 2, 4, (128, 128), 4096,
               [(0, 0), (0, 1)], seed=4, **wide)
    compare_v1("3d-large-cell", SamplerConfig(dim=3), 2, 4, (32, 32, 32), 4096,
               [(0, 0, 0), (1, 0, 0)], seed=5, **wide)

    cfg = SamplerConfig(dim=2)
    x, grid, _ = _v1_inputs(2, 8, 3, (12, 10), 64, seed=6)
    _expect_raise("f64 CUDA input", TypeError, lambda: blend_splat.blend(
        x.double(), grid.double(), cfg, (0, 0)))
    _expect_raise("non-contiguous CUDA input", ValueError,
                  lambda: blend_splat.blend(x.transpose(2, 3), grid, cfg,
                                            (0, 0)))
    _expect_raise("CUDA input with a CPU grid", ValueError,
                  lambda: blend_splat.blend(x, grid.cpu(), cfg, (0, 0)))
    return {"blend_o": errs[0], "splat_o": errs[1]}


def points_cotangent_phase():
    """The fused op's points cotangent on the card (order-bumped blend_o
    launches) against the same through the plain versions."""
    cells, pts, g = _fused_inputs(8, 3, 12, 10, 4099, seed=8)
    grads = {}
    for backend in ("auto", "xla"):
        p = pts.clone().requires_grad_(True)
        out = tfused.sample_features_with_derivs(
            cells, p, SamplerConfig(dim=2, backend=backend))
        (out * g).sum().backward()
        grads[backend] = p.grad
    abs_e, rel_e = _rel_err(grads["auto"].T, grads["xla"].T)
    print(f"points cotangent of the fused op (8x3x12x10, Q=4099): kernel vs "
          f"plain max abs err {abs_e:.3e}, rel {rel_e:.3e}", flush=True)
    if not rel_e <= REL_TOL:
        raise RuntimeError("points cotangent disagrees with the plain path")


# --- mega2w -------------------------------------------------------------------

def _mlp(c, hidden, gen, scale=1.0):
    """Random MLP leaves (w1, b1, w2, b2) on the card; ``scale`` widens w1
    so the pre-activations reach saturation."""
    w1 = torch.randn((c, hidden), generator=gen) * 0.5 * scale
    b1 = torch.randn((hidden,), generator=gen) * 0.1
    w2 = torch.randn((hidden, 1), generator=gen) * 0.3
    b2 = torch.full((1,), 0.1)
    return [t.cuda() for t in (w1, b1, w2, b2)]


def compare_mega(name, cfg, n, c, h, w, q, hidden=HIDDEN, pde="allen_cahn",
                 seed=0, scale=1.0, check=True):
    """mega2w against plain_mega2w_step on the card: every output finite,
    and (``check``) the loss at rtol LOSS_RTOL, the cells gradient and each
    MLP leaf within REL_TOL of its largest magnitude.  Returns the largest
    abs error of any output."""
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((n, c, h, w), generator=gen).cuda()
    pts = (torch.rand((q, 2), generator=gen) * 2.2 - 1.1).cuda()
    mlp = _mlp(c, hidden, gen, scale)
    loss, grads = mega2w.mega2w_step(cells, *mlp, pts, cfg, pde)
    ref_loss, ref = mega2w.plain_mega2w_step(cells, *mlp, pts, cfg, pde)
    torch.cuda.synchronize()
    outs = [loss[None], *grads.values()]
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        raise RuntimeError(f"mega2w {name}: non-finite kernel output")
    if any(grads[k].shape != ref[k].shape for k in ref):
        raise RuntimeError(f"mega2w {name}: shape mismatch")
    errs = {k: _rel_err(grads[k].reshape(1, -1), ref[k].reshape(1, -1))
            for k in ref}
    loss_err = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    worst = max(rel for _, rel in errs.values())
    print(f"compare mega2w {name} ({n}x{c}x{h}x{w}, Q={q}, hidden {hidden}, "
          f"{pde}): loss {float(loss):.8g} vs {float(ref_loss):.8g} (rel "
          f"{loss_err:.2e}); leaf rel err "
          f"{', '.join(f'{k} {rel:.2e}' for k, (_, rel) in errs.items())} "
          f"(tolerances loss {LOSS_RTOL:g}, leaf {REL_TOL:g})", flush=True)
    if check and not (loss_err <= LOSS_RTOL and worst <= REL_TOL):
        raise RuntimeError(f"mega2w {name}: kernel disagrees with the plain "
                           "version")
    return max(max(a for a, _ in errs.values()),
               abs(float(loss) - float(ref_loss)))


def mega_kernel_phase():
    main = SamplerConfig(dim=2)
    err = compare_mega("main-path", main, N, C, H, W, Q)
    small = (8, 3, 12, 10, 4096)
    for name, kw, extra in [
            ("helmholtz", {}, dict(pde="helmholtz")),
            ("border", dict(padding_mode="border"), {}),
            ("reflection", dict(padding_mode="reflection"), {}),
            ("linear", dict(kernel="linear"), {}),
            ("smoothstep", dict(kernel="smoothstep"), {}),
            ("no-multicell", dict(multicell=False), {}),
            ("align-false", dict(align_corners=False), {}),
            ("hidden-8", {}, dict(hidden=8)),
            ("hidden-32", {}, dict(hidden=32))]:
        compare_mega(name, SamplerConfig(dim=2, **kw), *small, seed=1,
                     **extra)
    for c in (1, 3, 8):
        compare_mega(f"channels-{c}", main, 8, c, 12, 10, 4096, seed=2)
    compare_mega("q-4099", main, 8, 3, 12, 10, 4099, seed=3)
    compare_mega("q-1000", main, 8, 3, 12, 10, 1000, seed=4)
    # a cell too large for the shared-memory chunk: global atomics
    compare_mega("large-cell", main, 2, 4, 128, 128, 4096, seed=5)
    # w1 scaled so |pre-activation| reaches ~40: tanh saturates and d1 -> 0;
    # the outputs must stay finite (the errors are printed, not checked:
    # d1 = 1 - h^2 keeps only a few bits there)
    compare_mega("saturated-tanh", main, 8, 4, 16, 16, 4096, seed=6,
                 scale=10.0, check=False)
    return err


# --- fused3w ------------------------------------------------------------------

def compare_3d(name, cfg, n, c, s, q, seed=0):
    """Both fused3w kernels against their plain versions on the card."""
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((n, c, s, s, s), generator=gen).cuda()
    pts = (torch.rand((q, 3), generator=gen) * 2.4 - 1.2).cuda()
    g = torch.randn((7, c, q), generator=gen).cuda()
    out = fused3w.fused_blend(cells, pts, cfg)
    ref = fused3w.plain_fused_blend(cells, pts, cfg)
    dcells = fused3w.fused_bwd(g, pts, (s, s, s), cfg, n)
    dref = fused3w.plain_fused_bwd(g, pts, (s, s, s), cfg, n)
    torch.cuda.synchronize()
    if out.shape != ref.shape or dcells.shape != dref.shape:
        raise RuntimeError(f"fused3w {name}: shape mismatch")
    if not (torch.isfinite(out).all() and torch.isfinite(dcells).all()):
        raise RuntimeError(f"fused3w {name}: non-finite kernel output")
    abs_b, rel_b = _rel_err(out, ref)
    abs_d, rel_d = _rel_err(dcells.reshape(1, -1), dref.reshape(1, -1))
    print(f"compare fused3w {name} ({n}x{c}x{s}^3, Q={q}): blend max abs err "
          f"{abs_b:.3e}, rel {rel_b:.3e}; bwd max abs err {abs_d:.3e}, rel "
          f"{rel_d:.3e} (tolerance rel {REL_TOL:g})", flush=True)
    if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
        raise RuntimeError(f"fused3w {name}: kernel disagrees with the plain "
                           "version")
    return abs_b, abs_d


def fused3w_kernel_phase():
    main = SamplerConfig(dim=3)
    errs = compare_3d("main-path", main, N3, C, S3, Q)
    small = (6, 3, 7, 4096)
    for name, kw in [
            ("border", dict(padding_mode="border")),
            ("reflection", dict(padding_mode="reflection")),
            ("linear", dict(kernel="linear")),
            ("smoothstep", dict(kernel="smoothstep")),
            ("no-multicell", dict(multicell=False)),
            ("align-false", dict(align_corners=False)),
            ("reflection-strict-align-false",
             dict(padding_mode="reflection", strict_reference=True,
                  align_corners=False))]:
        compare_3d(name, SamplerConfig(dim=3, **kw), *small, seed=1)
    for c in (1, 3, 8):
        compare_3d(f"channels-{c}", main, 6, c, 7, 4096, seed=2)
    compare_3d("q-4099", main, 6, 3, 7, 4099, seed=3)
    # a 4 x 32^3 cell (512 KB) is over the opted-in limit: global atomics
    compare_3d("large-cell", main, 2, 4, 32, 4096, seed=4)

    gen = torch.Generator().manual_seed(5)
    cells = torch.rand((6, 3, 7, 7, 7), generator=gen).cuda()
    pts = (torch.rand((4099, 3), generator=gen) * 2.4 - 1.2).cuda()
    g = torch.randn((7, 3, 4099), generator=gen).cuda()
    grads = {}
    for backend in ("auto", "xla"):
        p = pts.clone().requires_grad_(True)
        out = tfused.sample_features_with_derivs(
            cells, p, SamplerConfig(dim=3, backend=backend))
        (out * g).sum().backward()
        grads[backend] = p.grad
    abs_e, rel_e = _rel_err(grads["auto"].T, grads["xla"].T)
    print(f"points cotangent of the 3D fused op (6x3x7^3, Q=4099): kernel vs "
          f"plain max abs err {abs_e:.3e}, rel {rel_e:.3e}", flush=True)
    if not rel_e <= REL_TOL:
        raise RuntimeError("3D points cotangent disagrees with the plain path")
    return {"fused3w_blend": errs[0], "fused3w_bwd": errs[1]}


# --- fused3b ------------------------------------------------------------------

def _cuda_gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _vol_case(n, c, spatial, q, seed, lo=-1.2, hi=1.2, cfg=None, pts=None):
    """Cells, their kernel-layout volume, points (``pts`` if given) and
    their trimmed brick plan, made on the card."""
    gen = _cuda_gen(seed)
    cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
    if pts is None:
        pts = (torch.rand((q, 3), generator=gen, device="cuda") * (hi - lo)
               + lo)
    plan = tfused.make_vol_plan(pts, cells.shape, cfg)
    return cells, fused3b.cells_to_vol(cells), pts, plan


def compare_3b(name, cfg, n, c, spatial, q, seed=0, lo=-1.2, hi=1.2,
               pts=None):
    """Both fused3b kernels against their plain versions on the card: the
    (7, C, QP) slot output, and the volume cotangent through from_vol.
    The layout has no pad slots: the cotangent has exactly the cells'
    elements."""
    cells, vol, pts, plan = _vol_case(n, c, spatial, q, seed, lo, hi, cfg,
                                      pts)
    g_p = torch.randn((7, c, plan[1].shape[0]), generator=_cuda_gen(seed + 1),
                      device="cuda")
    out = fused3b.fused3b_blend_vol(vol, plan, cfg)
    ref = fused3b.plain_fused3b_blend_vol(vol, plan, cfg)
    dvol = fused3b.fused3b_bwd_vol(g_p, plan, spatial, cfg, n)
    dref = fused3b.plain_fused3b_bwd_vol(g_p, plan, spatial, cfg, n)
    torch.cuda.synchronize()
    if (out.shape != ref.shape or dvol.shape != dref.shape
            or dvol.numel() != cells.numel()):
        raise RuntimeError(f"fused3b {name}: shape mismatch")
    if not (torch.isfinite(out).all() and torch.isfinite(dvol).all()):
        raise RuntimeError(f"fused3b {name}: non-finite kernel output")
    if bool((out[:, :, plan[1] == 0] != 0).any()):
        raise RuntimeError(f"fused3b {name}: a pad slot is not zero")
    abs_b, rel_b = _rel_err(out, ref)
    abs_d, rel_d = _rel_err(fused3b.vol_to_cells(dvol).reshape(1, -1),
                            fused3b.vol_to_cells(dref).reshape(1, -1))
    print(f"compare fused3b {name} ({n}x{c}x{'x'.join(map(str, spatial))}, "
          f"Q={q}, QP={plan[1].shape[0]}): blend max abs err {abs_b:.3e}, "
          f"rel {rel_b:.3e}; bwd max abs err {abs_d:.3e}, rel {rel_d:.3e} "
          f"(tolerance rel {REL_TOL:g})", flush=True)
    if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
        raise RuntimeError(f"fused3b {name}: kernel disagrees with the plain "
                           "version")
    return abs_b, abs_d


def _trainer_points(q, dim, seed=0):
    """The fixed points train() draws for ``seed``, on the card."""
    with PointGenerator(q, dim, seed=seed) as gen:
        return torch.from_numpy(gen.batch(0)).cuda()


def fused3b_kernel_phase():
    """fused3b at config 5 (the vol-resident trainer's 1 000 000 points and
    so its plan) and in variants; the layout round trip; the slot rows
    against fused3w's at the same points."""
    main = SamplerConfig(dim=3)
    pts5 = _trainer_points(Q5, 3)
    errs = compare_3b("config-5", main, N5, C, (S5,) * 3, Q5, pts=pts5)
    small = (6, 3, (9, 9, 9), 4099)
    for name, kw, extra in [
            ("border", dict(padding_mode="border"), {}),
            ("reflection", dict(padding_mode="reflection"), {}),
            ("linear", dict(kernel="linear"), {}),
            ("smoothstep", dict(kernel="smoothstep"), {}),
            ("no-multicell", dict(multicell=False), {}),
            ("align-false", dict(align_corners=False), {}),
            ("reflection-strict-align-false",
             dict(padding_mode="reflection", strict_reference=True,
                  align_corners=False), {}),
            ("points-1.4", {}, dict(lo=-1.4, hi=1.4))]:
        compare_3b(name, SamplerConfig(dim=3, **kw), *small, seed=1, **extra)
    for c in (1, 3, 8):
        compare_3b(f"channels-{c}", main, 6, c, (9, 9, 9), 4099, seed=2)
    compare_3b("non-cubic-20x28x36", main, 6, 4, (20, 28, 36), 8192, seed=3)
    # 9^3: 11 z slabs x 6 y groups = 66 bins; the route takes Q >= 132
    compare_3b("q-133", main, 6, 3, (9, 9, 9), 133, seed=4)

    cells, vol, pts, plan = _vol_case(N5, C, (S5,) * 3, Q5, 5, cfg=main,
                                      pts=pts5)
    if not torch.equal(fused3b.vol_to_cells(vol), cells):
        raise RuntimeError("from_vol(to_vol(cells)) differs from the cells")
    slots = fused3b.fused3b_blend_vol(vol, plan, main)[:, :, plan[0]]
    diff = float((slots - fused3w.fused_blend(cells, pts, main)).abs().max())
    print(f"fused3b vs fused3w blend at config 5 (Q={Q5}): max "
          f"abs diff {diff:.3e}; from_vol(to_vol(cells)) == cells", flush=True)
    if diff > REL_TOL * float(slots.abs().max()):
        raise RuntimeError("fused3b and fused3w disagree")
    return {"fused3b_blend": errs[0], "fused3b_bwd": errs[1]}


# --- trainers -----------------------------------------------------------------

def _train_checked(name, cfg, steps, launched, decrease=True):
    """Train with every launch count set to 0 just before and read just
    after: each kernel of ``launched`` must have launched, every other
    kernel not at all."""
    _reset_counts()
    params, metrics = train(cfg)
    launches = _counts()
    losses = [m["loss"] for m in metrics]
    per_step = {k: v / steps for k, v in launches.items() if v}
    print(f"train {name}: {steps} steps; losses "
          f"{' '.join(f'{v:.6g}' for v in losses)}; launches per step "
          f"{per_step}", flush=True)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{name}: loss is not finite at every step")
    if decrease and not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: loss did not decrease")
    if any(launches[k] == 0 for k in launched):
        raise RuntimeError(f"{name}: a kernel of the path never launched: "
                           f"{launches}")
    if any(v != 0 for k, v in launches.items() if k not in launched):
        raise RuntimeError(f"{name}: another path's kernel launched: "
                           f"{launches}")
    for k, v in params.items():
        if not (v.is_cuda and torch.isfinite(v).all()):
            raise RuntimeError(f"{name}: parameter {k} is not finite")
    return launches, losses


def fused_trainer_phase():
    """The port's default trainer at the main path, on the card."""
    launches, losses = _train_checked(
        f"fused {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", steps=STEPS, log_every=1, seed=0), STEPS,
        ("fused2w_blend", "fused2w_bwd"))
    if launches["fused2w_blend"] != STEPS or launches["fused2w_bwd"] != STEPS:
        raise RuntimeError(f"expected {STEPS} launches of each fused kernel")
    return launches, losses


def mega_trainer_phase(fused_losses):
    """The megakernel trainer at the main path: one mega2w launch a step
    and no other kernel; its losses are the fused trainer's, the first at
    rtol LOSS_RTOL and each within GRAD_TOL relative (the parameters drift
    apart by f32 rounding, step by step)."""
    launches, losses = _train_checked(
        f"megakernel {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", megakernel=True, steps=STEPS, log_every=1,
                    seed=0), STEPS, ("mega2w",))
    if launches["mega2w"] != STEPS:
        raise RuntimeError(f"expected {STEPS} mega2w launches")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, fused_losses)]
    print(f"megakernel vs fused trainer losses: worst rel diff {max(rel):.3e} "
          f"(step {rel.index(max(rel)) + 1}), first {rel[0]:.3e}", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError("megakernel and fused trainers disagree")
    return launches


def nested_trainer_phase():
    """The nested-autograd trainer (fused=False) at full width."""
    return _train_checked(
        f"nested {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", fused=False, steps=NESTED_STEPS,
                     log_every=1, seed=0), NESTED_STEPS,
        ("blend_o", "splat_o"))[0]


MODEL_3D = pinn.PINNConfig(dim=3, n_cells=N3, cell_size=S3, pde="helmholtz")


def nested_3d_phase():
    """The 3D Helmholtz trainer (the reference's test_3d workload)."""
    _train_checked(
        f"nested 3D {N3}x{C}x{S3}^3, {Q} points",
        TrainConfig(model=MODEL_3D, device="cuda", fused=False,
                    steps=STEPS_3D, log_every=1, seed=0), STEPS_3D,
        ("blend_o", "splat_o"), decrease=False)


def fused_3d_phase():
    """The default (fused) 3D trainer: fused3w_blend / fused3w_bwd once a
    step each."""
    launches, _ = _train_checked(
        f"fused 3D {N3}x{C}x{S3}^3, {Q} points",
        TrainConfig(model=MODEL_3D, device="cuda", steps=STEPS_3D,
                    log_every=1, seed=0), STEPS_3D,
        ("fused3w_blend", "fused3w_bwd"), decrease=False)
    if (launches["fused3w_blend"] != STEPS_3D
            or launches["fused3w_bwd"] != STEPS_3D):
        raise RuntimeError(f"expected {STEPS_3D} launches of each fused3w "
                           "kernel")
    return launches


MODEL_5 = pinn.PINNConfig(dim=3, n_cells=N5, cell_size=S5, pde="helmholtz")


def _fixed_point_losses(cfg, q, steps, seed=0):
    """The losses of ``steps`` query-ordered fused steps (fused3w in 3D) on
    the trainer's fixed points and initial weights for ``seed``."""
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              "cuda")
    pts = _trainer_points(q, cfg.dim, seed)
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), fused=True)
    return [float(step(params, pts)) for _ in range(steps)]


def _vol_loss_and_grads(cfg, device, pts, seed):
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device)
    params = pinn.params_to_vol(params, cfg, pts.shape[0])
    pts = pts.to(device)
    plan = tfused.make_vol_plan(pts, (cfg.n_cells, cfg.cell_dim,
                                      *(cfg.cell_size,) * 3), cfg.sampler)
    loss = pinn.loss_fused_slots_vol(params, pts, cfg, plan)
    loss.backward()
    grads = {k: v.grad for k, v in params.items()}
    grads["cells"] = fused3b.vol_to_cells(grads["cells"])
    return float(loss.detach()), {k: v.cpu() for k, v in grads.items()}


def vol_trainer_phase():
    """The vol-resident trainer at BASELINE config 5: one fused3b_blend and
    one fused3b_bwd launch a step and no other kernel; its losses are the
    query-ordered fused3w trainer's on the same fixed points, the first at
    rtol LOSS_RTOL and each within GRAD_TOL relative.  Then card vs CPU
    at 5 x 3 x 6^3, Q = 120."""
    launches, losses = _train_checked(
        f"vol-resident {N5}x{C}x{S5}^3, {Q5} points",
        TrainConfig(model=MODEL_5, device="cuda", batch_points=Q5,
                    steps=STEPS_VOL, log_every=1, seed=0, vol_resident=True),
        STEPS_VOL, ("fused3b_blend", "fused3b_bwd"))
    if (launches["fused3b_blend"] != STEPS_VOL
            or launches["fused3b_bwd"] != STEPS_VOL):
        raise RuntimeError(f"expected {STEPS_VOL} launches of each fused3b "
                           "kernel")
    _reset_counts()
    ref = _fixed_point_losses(MODEL_5, Q5, STEPS_VOL)
    ref_launches = _counts()
    if (ref_launches["fused3w_blend"] != STEPS_VOL
            or ref_launches["fused3b_blend"] != 0):
        raise RuntimeError(f"the fused3w trainer took another route: "
                           f"{ref_launches}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"vol-resident vs fused3w trainer losses on the same fixed points: "
          f"{' '.join(f'{v:.8g}' for v in ref)} (fused3w); worst rel diff "
          f"{max(rel):.3e}, first {rel[0]:.3e}; the (D, H, W, N, C) volume "
          f"has no pad slots", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError("vol-resident and fused3w trainers disagree")
    cfg = pinn.PINNConfig(dim=3, n_cells=5, cell_dim=3, cell_size=6,
                          pde="helmholtz")
    with PointGenerator(120, 3, seed=7) as gen:
        pts = torch.from_numpy(gen.batch(0))
    _compare_losses("reference vol-resident: fused3b on the card vs plain "
                    "CPU (5x3x6^3, Q=120)",
                    _vol_loss_and_grads(cfg, "cuda", pts, 7),
                    _vol_loss_and_grads(cfg, "cpu", pts, 7))
    return launches


def launch_breakdown_phase():
    """One nested step's launches, split at loss.backward(): the splats
    before it go to the cells from autograd.grad(..., points) calls and are
    dropped (needs_input_grad is fixed at forward time)."""
    cfg = pinn.PINNConfig()
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    with PointGenerator(Q, 2, seed=9) as gen:
        pts = torch.from_numpy(gen.batch(0)).cuda()
    _reset_counts()
    loss = pinn.loss(params, pts, cfg)
    fwd = _counts()
    _reset_counts()
    loss.backward()
    bwd = _counts()
    print(f"launches of one nested step: loss (u and the two autograd.grad "
          f"calls) blend_o {fwd['blend_o']}, splat_o {fwd['splat_o']} (all "
          f"dropped); loss.backward() blend_o {bwd['blend_o']}, splat_o "
          f"{bwd['splat_o']}", flush=True)


def _loss_and_grads(loss_fn, cfg, device, pts, seed):
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device)
    loss = loss_fn(params, pts.to(device), cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad.cpu() for k, v in params.items()}


def _compare_losses(what, a, b):
    (l_a, g_a), (l_b, g_b) = a, b
    worst = max(float((g_a[k] - g_b[k]).abs().max()
                      / g_b[k].abs().max().clamp_min(1e-30)) for k in g_b)
    print(f"{what}: loss {l_a:.8g} vs {l_b:.8g}; worst gradient leaf rel "
          f"err {worst:.3e} (tolerances loss rtol {LOSS_RTOL:g}, leaf "
          f"{GRAD_TOL:g} of its largest magnitude)", flush=True)
    if abs(l_a - l_b) > LOSS_RTOL * abs(l_b) or worst > GRAD_TOL:
        raise RuntimeError(f"{what}: disagree")


def nested_vs_fused_phase():
    """pinn.loss and pinn.loss_fused are one function: same params and
    points at full width on the card, 2D (fused2w) and 3D (fused3w)."""
    for what, cfg, dim in (("2D", pinn.PINNConfig(), 2), ("3D", MODEL_3D, 3)):
        with PointGenerator(Q, dim, seed=10) as gen:
            pts = torch.from_numpy(gen.batch(0))
        _compare_losses(f"nested vs fused {what} on the card (full width)",
                        _loss_and_grads(pinn.loss, cfg, "cuda", pts, 10),
                        _loss_and_grads(pinn.loss_fused, cfg, "cuda", pts, 10))


def _mega_loss_and_grads(cfg, device, pts, seed):
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device)
    loss, grads = pinn.value_and_grad_mega(params, pts.to(device), cfg)
    return float(loss), {k: v.cpu() for k, v in grads.items()}


def reference_phase():
    """Kernel paths on the card against the plain paths on the CPU, on a
    small input (8 cells, 4096 points): fused, nested and megakernel in 2D,
    fused in 3D."""
    cfg = pinn.PINNConfig(n_cells=8)
    with PointGenerator(4096, 2, seed=5) as gen:
        pts = torch.from_numpy(gen.batch(0))
    for name, loss_fn in (("fused", pinn.loss_fused), ("nested", pinn.loss)):
        _compare_losses(f"reference {name}: kernel path on the card vs plain "
                        f"CPU", _loss_and_grads(loss_fn, cfg, "cuda", pts, 5),
                        _loss_and_grads(loss_fn, cfg, "cpu", pts, 5))
    _compare_losses("reference megakernel: mega2w on the card vs plain CPU",
                    _mega_loss_and_grads(cfg, "cuda", pts, 5),
                    _mega_loss_and_grads(cfg, "cpu", pts, 5))
    cfg3 = pinn.PINNConfig(dim=3, n_cells=8, cell_size=S3, pde="helmholtz")
    with PointGenerator(4096, 3, seed=6) as gen:
        pts3 = torch.from_numpy(gen.batch(0))
    _compare_losses("reference fused 3D: fused3w on the card vs plain CPU",
                    _loss_and_grads(pinn.loss_fused, cfg3, "cuda", pts3, 6),
                    _loss_and_grads(pinn.loss_fused, cfg3, "cpu", pts3, 6))


# --- times -------------------------------------------------------------------

def v1_time_phase():
    """blend_o / splat_o at the main shape against their plain versions,
    and against the one PyTorch call that computes the same function where
    there is one (linear, order 0, no multicell, zeros, align_corners)."""
    main = SamplerConfig(dim=2)
    x, grid, gout = _v1_inputs(2, N, C, (H, W), Q, seed=11)
    o = (0, 0)
    pairs = N * Q
    bounds = {
        "blend_o": _bound(4 * (N * C * H * W + 2 * Q + N * C * Q),
                          2 * 4 * C * pairs),
        "splat_o": _bound(4 * (N * C * Q + 2 * Q + N * C * H * W),
                          2 * 4 * C * pairs),
    }
    times = {}
    for name, kernel, plain in [
            ("blend_o", lambda: blend_splat.blend(x, grid, main, o),
             lambda: blend_splat.plain_blend(x, grid, main, o)),
            ("splat_o", lambda: blend_splat.splat(gout, grid, (H, W), main, o),
             lambda: blend_splat.plain_splat(gout, grid, (H, W), main, o))]:
        ms, plain_ms = _in_turns(kernel, plain)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bounds[name][0],
                           bound_by=bounds[name][1])

    lib = {}
    for dim, spatial, n in ((2, (H, W), N), (3, (S3,) * 3, N3)):
        cfg = SamplerConfig(dim=dim, kernel="linear", multicell=False)
        x, grid, gout = _v1_inputs(dim, n, C, spatial, Q, seed=12)
        full = grid.expand(n, *grid.shape[1:])    # grid_sample wants batch N
        bwd = (torch.ops.aten.grid_sampler_2d_backward if dim == 2
               else torch.ops.aten.grid_sampler_3d_backward)
        ops = {
            "blend_o": (lambda: blend_splat.blend(x, grid, cfg, (0,) * dim),
                        lambda: F.grid_sample(x, full, mode="bilinear",
                                              padding_mode="zeros",
                                              align_corners=True)),
            "splat_o": (lambda: blend_splat.splat(gout, grid, spatial, cfg,
                                                  (0,) * dim),
                        lambda: bwd(gout, x, full, 0, 0, True,
                                    [True, False])[0]),
        }
        for name, (kernel, library) in ops.items():
            _, err = _rel_err(kernel().reshape(1, -1),
                              library().reshape(1, -1))
            if not err <= REL_TOL:
                raise RuntimeError(f"{name} {dim}D: the library call "
                                   f"computes another function ({err:.3e})")
            ms, lib_ms = _in_turns(kernel, library)
            lib[(name, dim)] = (ms, lib_ms)
            print(f"time {name} {dim}D at linear, order 0, no multicell "
                  f"({n}x{C}x{'x'.join(map(str, spatial))}, Q={Q}): kernel "
                  f"{ms:.4f} ms, library {lib_ms:.4f} ms (rel diff "
                  f"{err:.2e})", flush=True)
    for name, t in times.items():
        t["library_ms"] = lib[(name, 2)][1]
        t["ms_at_library_setting"] = lib[(name, 2)][0]
        print(f"time {name} at the main shape (cosine, multicell, order 0): "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of it", flush=True)
    return times


def mega_fused3w_time_phase():
    """mega2w, fused3w_blend and fused3w_bwd at the main paths against
    their plain versions, and mega2w against the two fused2w kernels that
    compute the same cells gradient in the two-kernel step, in turns."""
    times = {}
    main = SamplerConfig(dim=2)
    gen = torch.Generator().manual_seed(13)
    cells = torch.rand((N, C, H, W), generator=gen).cuda()
    pts = (torch.rand((Q, 2), generator=gen) * 2 - 1).cuda()
    mlp = _mlp(C, HIDDEN, gen)
    g = torch.randn((5, C, Q), generator=gen).cuda()
    # blend and splat: 5 rows x 4 corners x C FMAs per (query, cell) each;
    # the MLP ~(20 C + 40) operations per (query, hidden unit); reads the
    # cells, points and MLP, writes the cells gradient and the MLP's
    flops = 2 * (2 * 5 * 4 * C * N * Q) + 2 * Q * HIDDEN * (20 * C + 40)
    nbytes = 4 * (2 * N * C * H * W + 2 * Q + 2 * (C + 2) * HIDDEN + 3)
    ms, plain_ms = _in_turns(
        lambda: mega2w.mega2w_step(cells, *mlp, pts, main, "allen_cahn"),
        lambda: mega2w.plain_mega2w_step(cells, *mlp, pts, main,
                                         "allen_cahn"))
    bound_ms, bound_by = _bound(nbytes, flops)
    times["mega2w"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)

    def two_kernels():
        fused2w.fused_blend(cells, pts, main)
        fused2w.fused_bwd(g, pts, (H, W), main, N)

    pair_ms, mega_ms = _in_turns(two_kernels, lambda: mega2w.mega2w_step(
        cells, *mlp, pts, main, "allen_cahn"))
    print(f"time mega2w at the main path: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of it; fused2w_blend + fused2w_bwd "
          f"{pair_ms:.4f} ms vs mega2w {mega_ms:.4f} ms in turns; no library "
          f"call computes it", flush=True)

    cfg3 = SamplerConfig(dim=3)
    cells3 = torch.rand((N3, C, S3, S3, S3), generator=gen).cuda()
    pts3 = (torch.rand((Q, 3), generator=gen) * 2 - 1).cuda()
    g3 = torch.randn((7, C, Q), generator=gen).cuda()
    # 7 rows x 8 corners x C FMAs per (query, cell); the blend reads cells
    # and points and writes (7, C, Q), the bwd the other way round
    flops3 = 2 * 7 * 8 * C * N3 * Q
    nbytes3 = 4 * (N3 * C * S3 ** 3 + 3 * Q + 7 * C * Q)
    for name, kernel, plain in [
            ("fused3w_blend", lambda: fused3w.fused_blend(cells3, pts3, cfg3),
             lambda: fused3w.plain_fused_blend(cells3, pts3, cfg3)),
            ("fused3w_bwd",
             lambda: fused3w.fused_bwd(g3, pts3, (S3,) * 3, cfg3, N3),
             lambda: fused3w.plain_fused_bwd(g3, pts3, (S3,) * 3, cfg3, N3))]:
        ms, plain_ms = _in_turns(kernel, plain)
        bound_ms, bound_by = _bound(nbytes3, flops3)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        print(f"time {name} at the 3D main path: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of it; no library call computes it",
              flush=True)
    return times


def fused3b_time_phase():
    """fused3b_blend_vol / fused3b_bwd_vol at config 5 (1 000 000 points)
    against their bounds and plain versions, and against fused3w_blend /
    fused3w_bwd on the same volume and points in query order, in turns;
    the plan's build time; step medians of the vol-resident, planned and
    query-ordered (fused3w) steps in turns, and the vol-resident step's
    peak device memory."""
    cfg = SamplerConfig(dim=3)
    spatial = (S5,) * 3
    pts = _trainer_points(Q5, 3)
    cells = torch.rand((N5, C, *spatial), generator=_cuda_gen(14),
                       device="cuda")
    vol = fused3b.cells_to_vol(cells)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = tfused.make_vol_plan(pts, cells.shape, cfg)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) * 1e3
    plan_ms2 = _time_ms(lambda: tfused.make_vol_plan(pts, cells.shape, cfg),
                        3)
    qp = plan[1].shape[0]
    real_blocks = int(plan[4].sum())
    print(f"plan at config 5: first build {plan_ms:.2f} ms (host clock), "
          f"then {plan_ms2:.3f} ms (CUDA events, 3 builds); QP {qp} slots "
          f"(bound {(-(-Q5 // 128) + (S5 + 2) * 65) * 128}), "
          f"{plan[4].numel()} blocks, {real_blocks} with queries", flush=True)
    g_p = torch.randn((7, C, qp), generator=_cuda_gen(15), device="cuda")
    g_q = torch.randn((7, C, Q5), generator=_cuda_gen(16), device="cuda")
    # 7 rows x 8 corners x C FMAs per (real query, cell).  Both kernels
    # read the mask of every slot and the flag of every block, and the
    # points of the Q real slots only; the blend reads the volume once and
    # writes (7, C, QP), zeros in the pad slots included; the bwd reads
    # the cotangent of the real slots and writes the volume once
    flops = 2 * 7 * 8 * C * N5 * Q5
    vol_bytes = 4 * N5 * C * S5 ** 3
    plan_bytes = 4 * (3 * Q5 + qp + plan[4].numel())
    bounds = {"fused3b_blend": _bound(vol_bytes + plan_bytes + 4 * 7 * C * qp,
                                      flops),
              "fused3b_bwd": _bound(4 * 7 * C * Q5 + plan_bytes + vol_bytes,
                                    flops)}
    ops = {
        "fused3b_blend": (lambda: fused3b.fused3b_blend_vol(vol, plan, cfg),
                          lambda: fused3b.plain_fused3b_blend_vol(vol, plan,
                                                                  cfg),
                          lambda: fused3w.fused_blend(cells, pts, cfg)),
        "fused3b_bwd": (lambda: fused3b.fused3b_bwd_vol(g_p, plan, spatial,
                                                        cfg, N5),
                        lambda: fused3b.plain_fused3b_bwd_vol(g_p, plan,
                                                              spatial, cfg,
                                                              N5),
                        lambda: fused3w.fused_bwd(g_q, pts, spatial, cfg,
                                                  N5)),
    }
    # the layout check: fused3w (the (N, C, D, H, W) layout) on the real
    # queries in the plan's slot order, i.e. sorted as fused3b sees them
    srt = plan[5][plan[1] > 0].contiguous()
    sorted_ops = {
        "fused3b_blend": lambda: fused3w.fused_blend(cells, srt, cfg),
        "fused3b_bwd": lambda: fused3w.fused_bwd(g_q, srt, spatial, cfg, N5),
    }
    times = {}
    for name, (kernel, plain, other) in ops.items():
        ms, plain_ms = _in_turns(kernel, plain, reps=2)
        ms, other_ms = _in_turns(kernel, other, reps=5)
        _, sorted_ms = _in_turns(kernel, sorted_ops[name], reps=5)
        bound_ms, bound_by = bounds[name]
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None,
                           fused3w_ms_same_work=other_ms)
        print(f"time {name} at config 5 ({N5}x{C}x{S5}^3, Q={Q5}, QP={qp}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it; "
              f"{name.replace('3b', '3w')} on the same volume and points "
              f"in query order {other_ms:.4f} ms, in the plan's sorted "
              f"order {sorted_ms:.4f} ms; no library call computes it",
              flush=True)

    del cells, vol, g_p, g_q
    torch.cuda.empty_cache()

    _fixed_step_turns("config 5", MODEL_5, pts, ("vol", "planned", "fused3w"),
                      plan)
    return times


def _fixed_step(model, pts, kind, plan=None):
    """One fixed-point train step of ``kind``: "vol" (vol-resident, on
    ``plan``), "planned" (make_sample_plan's plan, per-call relayout) or
    "fused3w" (query order, no plan)."""
    params = pinn.init_params(_cuda_gen(0), model, "cuda")
    step_plan = None
    if kind == "vol":
        step_plan = plan
        params = pinn.params_to_vol(params, model, pts.shape[0])
    elif kind == "planned":
        step_plan = tfused.make_sample_plan(pts, tuple(params["cells"].shape),
                                            model.sampler)
        if step_plan is None:
            raise RuntimeError("the shape should take the planned route")
    step = pinn.make_train_step(
        model, torch.optim.Adam(params.values(), lr=1e-3), fused=True,
        planned=kind == "planned", vol_resident=kind == "vol")
    args = (params, pts) + ((step_plan,) if step_plan is not None else ())
    return lambda: step(*args)


def _fixed_step_median(run):
    """Median ms of 10 steps after 3 warm-up steps (CUDA events), and the
    peak device memory of the timed steps in GiB."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times_ms = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times_ms.append(start.elapsed_time(end))
    return statistics.median(times_ms), torch.cuda.max_memory_allocated() / 2**30


def _fixed_step_turns(what, model, pts, kinds, plan=None):
    """Step medians of each kind of fixed-point step, in turns (the kinds,
    then the same reversed)."""
    runs = []
    for kind in kinds + kinds[::-1]:
        run = _fixed_step(model, pts, kind, plan)
        runs.append((kind, *_fixed_step_median(run)))
        del run
        torch.cuda.empty_cache()
    for kind in kinds:
        ms = [m for k, m, _ in runs if k == kind]
        peak = max(p for k, _, p in runs if k == kind)
        print(f"step {what} {kind}: {sum(ms) / 2:.4f} ms (turns "
              f"{ms[0]:.4f} {ms[1]:.4f}); peak device memory {peak:.3f} GiB",
              flush=True)


def route_phase():
    """Both 3D routes' kernels (blend + bwd) at cells below and above the
    shared memory of one block (4 x 24^3 is 221 KB, 4 x 32^3 512 KB) and
    stacks below and above the card's L2, in turns: fused3w in query
    order against fused3b over the kernel layout with the stack's plan.
    Then the fixed-point step on both routes (make_sample_plan's planned
    step against the query-ordered fused3w step) at the two smallest."""
    cfg = SamplerConfig(dim=3)
    for n, s, q in ((N3, S3, Q), (16, 24, Q5), (16, 32, Q5), (16, 48, Q5),
                    (16, 64, Q5)):
        spatial = (s,) * 3
        with PointGenerator(q, 3, seed=17) as gen:
            pts = torch.from_numpy(gen.batch(0)).cuda()
        cells = torch.rand((n, C, *spatial), generator=_cuda_gen(17),
                           device="cuda")
        vol = fused3b.cells_to_vol(cells)
        plan = tfused.make_vol_plan(pts, cells.shape, cfg)
        g_q = torch.randn((7, C, q), generator=_cuda_gen(18), device="cuda")
        g_p = torch.randn((7, C, plan[1].shape[0]), generator=_cuda_gen(19),
                          device="cuda")

        def bricked():
            fused3b.fused3b_blend_vol(vol, plan, cfg)
            fused3b.fused3b_bwd_vol(g_p, plan, spatial, cfg, n)

        def windowed():
            fused3w.fused_blend(cells, pts, cfg)
            fused3w.fused_bwd(g_q, pts, spatial, cfg, n)

        b_ms, w_ms = _in_turns(bricked, windowed, reps=5)
        planned = tfused.make_sample_plan(pts, cells.shape, cfg) is not None
        print(f"route {n}x{C}x{s}^3 ({4 * cells.numel() / 1e6:.1f} MB), "
              f"Q={q}: fused3b blend + bwd {b_ms:.4f} ms, fused3w blend + "
              f"bwd {w_ms:.4f} ms; make_sample_plan routes it to "
              f"{'fused3b' if planned else 'fused3w'}", flush=True)
        if not planned:
            raise RuntimeError("make_sample_plan gave no plan")
        del cells, vol, plan, g_q, g_p
        torch.cuda.empty_cache()
        if s <= 24:
            _fixed_step_turns(
                f"fixed points {n}x{C}x{s}^3, Q={q},",
                pinn.PINNConfig(dim=3, n_cells=n, cell_size=s,
                                pde="helmholtz"), pts, ("planned", "fused3w"))


def _median_step_ms(cfg, batches, **step_kw):
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), **step_kw)
    for pts in batches[:3]:
        step(params, pts)
    times = []
    for pts in batches[3:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, pts)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _step_turns(what, a, b, batches):
    """Median step ms of two step setups (cfg, step kwargs), in turns
    a, b, b, a."""
    ta1, tb1, tb2, ta2 = (_median_step_ms(cfg, batches, **kw)
                          for cfg, kw in (a, b, b, a))
    print(f"step {what}: {(tb1 + tb2) / 2:.4f} ms vs {(ta1 + ta2) / 2:.4f} ms "
          f"(turns {ta1:.4f} {tb1:.4f} {tb2:.4f} {ta2:.4f})", flush=True)


def step_phase():
    """Median step ms (CUDA events, 3 warm-up steps, 10 timed) in turns: the
    kernel path against the same steps through the plain versions
    (backend='xla'), fused and nested; the megakernel step against the
    two-kernel fused step; the 3D fused step against the 3D nested step."""
    with PointGenerator(Q, 2, seed=7) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda() for i in range(13)]
    for name, fused in (("fused", True), ("nested", False)):
        _step_turns(f"{name}, kernel path vs plain path",
                    (pinn.PINNConfig(backend="xla"), dict(fused=fused)),
                    (pinn.PINNConfig(), dict(fused=fused)), batches)
    _step_turns("megakernel vs two-kernel fused",
                (pinn.PINNConfig(), dict(fused=True)),
                (pinn.PINNConfig(), dict(megakernel=True)), batches)
    with PointGenerator(Q, 3, seed=8) as gen:
        batches3 = [torch.from_numpy(gen.batch(i)).cuda() for i in range(13)]
    _step_turns("3D fused vs 3D nested", (MODEL_3D, dict(fused=False)),
                (MODEL_3D, dict(fused=True)), batches3)


def main():
    card = device_phase()
    build_phase()
    errs, times = kernel_phase()
    errs.update(v1_kernel_phase())
    points_cotangent_phase()
    errs["mega2w"] = mega_kernel_phase()
    errs.update(fused3w_kernel_phase())
    errs.update(fused3b_kernel_phase())
    launches, fused_losses = fused_trainer_phase()
    mega = mega_trainer_phase(fused_losses)
    nested = nested_trainer_phase()
    launch_breakdown_phase()
    nested_3d_phase()
    fused3 = fused_3d_phase()
    vol = vol_trainer_phase()
    launches.update(blend_o=nested["blend_o"], splat_o=nested["splat_o"],
                    mega2w=mega["mega2w"],
                    fused3w_blend=fused3["fused3w_blend"],
                    fused3w_bwd=fused3["fused3w_bwd"],
                    fused3b_blend=vol["fused3b_blend"],
                    fused3b_bwd=vol["fused3b_bwd"])
    nested_vs_fused_phase()
    reference_phase()
    times.update(v1_time_phase())
    times.update(mega_fused3w_time_phase())
    times.update(fused3b_time_phase())
    route_phase()
    step_phase()
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], **times[name]}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
