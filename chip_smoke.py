"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card (main-path shapes and small
variants).  Then it drives the port's two training paths at full width:
the fused trainer (96 cells x 4 ch x 16 x 16, 100 000 points, hidden 16,
Allen-Cahn) for 20 steps through fused2w_blend / fused2w_bwd, and the
nested-autograd trainer (``fused=False``, the public sampler to third
order) for 10 steps through blend_o / splat_o, plus 3 steps of the 3D
Helmholtz trainer (50 x 4 x 16^3).  It checks from the launch counters
that each path went through its kernels, compares the nested loss with
the fused one and the card with the CPU, and times kernels, library calls
and steps against their plain versions.  The last lines are a JSON object
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
from cosinesampler_tpu_torch.ops.cuda import blend_splat, build, fused2w
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

# main path: BASELINE config 3 / bench.py's headline
N, C, H, W, Q = 96, 4, 16, 16, 100_000
# the reference's test_3d workload
N3, S3 = 50, 16
STEPS, NESTED_STEPS, STEPS_3D = 20, 10, 3
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
}
REPLACES = {
    "fused2w_blend": "cosinesampler_tpu/ops/pallas/fused2w.py:276",
    "fused2w_bwd": "cosinesampler_tpu/ops/pallas/fused2w.py:432",
    "blend_o": "cosinesampler_tpu/ops/pallas/kernels.py:102",
    "splat_o": "cosinesampler_tpu/ops/pallas/kernels.py:201",
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
    for fn in (fused2w.fused_blend, fused2w.fused_bwd, blend_splat.blend,
               blend_splat.splat):
        fn.launches = 0


def _counts():
    return {"fused2w_blend": fused2w.fused_blend.launches,
            "fused2w_bwd": fused2w.fused_bwd.launches,
            "blend_o": blend_splat.blend.launches,
            "splat_o": blend_splat.splat.launches}


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


# --- trainers -----------------------------------------------------------------

def _train_checked(name, cfg, steps, must_launch, must_not, decrease=True):
    _reset_counts()
    params, metrics = train(cfg)
    launches = _counts()
    losses = [m["loss"] for m in metrics]
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"train {name}: {steps} steps; losses "
          f"{' '.join(f'{v:.6g}' for v in losses)}; launches {launches}; "
          f"per step {per_step}", flush=True)
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{name}: loss is not finite at every step")
    if decrease and not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: loss did not decrease")
    if any(launches[k] == 0 for k in must_launch):
        raise RuntimeError(f"{name}: a kernel of the path never launched: "
                           f"{launches}")
    if any(launches[k] != 0 for k in must_not):
        raise RuntimeError(f"{name}: another path's kernel launched: "
                           f"{launches}")
    for k, v in params.items():
        if not (v.is_cuda and torch.isfinite(v).all()):
            raise RuntimeError(f"{name}: parameter {k} is not finite")
    return launches


def fused_trainer_phase():
    """The port's default trainer at the main path, on the card."""
    launches = _train_checked(
        f"fused {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", steps=STEPS, log_every=1, seed=0), STEPS,
        ("fused2w_blend", "fused2w_bwd"), ("blend_o", "splat_o"))
    if launches["fused2w_blend"] != STEPS or launches["fused2w_bwd"] != STEPS:
        raise RuntimeError(f"expected {STEPS} launches of each fused kernel")
    return launches


def nested_trainer_phase():
    """The nested-autograd trainer (fused=False) at full width."""
    return _train_checked(
        f"nested {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", fused=False, steps=NESTED_STEPS,
                     log_every=1, seed=0), NESTED_STEPS,
        ("blend_o", "splat_o"), ("fused2w_blend", "fused2w_bwd"))


def nested_3d_phase():
    """The 3D Helmholtz trainer (the reference's test_3d workload)."""
    model = pinn.PINNConfig(dim=3, n_cells=N3, cell_size=S3,
                            pde="helmholtz")
    _train_checked(
        f"nested 3D {N3}x{C}x{S3}^3, {Q} points",
        TrainConfig(model=model, device="cuda", fused=False, steps=STEPS_3D,
                    log_every=1, seed=0), STEPS_3D,
        ("blend_o", "splat_o"), ("fused2w_blend", "fused2w_bwd"),
        decrease=False)


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
    points at full width on the card."""
    cfg = pinn.PINNConfig()
    with PointGenerator(Q, 2, seed=10) as gen:
        pts = torch.from_numpy(gen.batch(0))
    _compare_losses("nested vs fused on the card (full width)",
                    _loss_and_grads(pinn.loss, cfg, "cuda", pts, 10),
                    _loss_and_grads(pinn.loss_fused, cfg, "cuda", pts, 10))


def reference_phase():
    """Kernel paths on the card against the plain paths on the CPU, on a
    small input (8 cells, 4096 points), fused and nested."""
    cfg = pinn.PINNConfig(n_cells=8)
    with PointGenerator(4096, 2, seed=5) as gen:
        pts = torch.from_numpy(gen.batch(0))
    for name, loss_fn in (("fused", pinn.loss_fused), ("nested", pinn.loss)):
        _compare_losses(f"reference {name}: kernel path on the card vs plain "
                        f"CPU", _loss_and_grads(loss_fn, cfg, "cuda", pts, 5),
                        _loss_and_grads(loss_fn, cfg, "cpu", pts, 5))


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


def _median_step_ms(cfg, fused, batches):
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), fused=fused)
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


def step_phase():
    """Median step ms (CUDA events, 3 warm-up steps, 10 timed) on the
    kernel path and with the same steps through the plain versions
    (backend='xla'), fused and nested, in turns."""
    with PointGenerator(Q, 2, seed=7) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda() for i in range(13)]
    for name, fused in (("fused", True), ("nested", False)):
        p1, k1, k2, p2 = (
            _median_step_ms(pinn.PINNConfig(backend=b), fused, batches)
            for b in ("xla", "auto", "auto", "xla"))
        print(f"step {name}: median train step {(k1 + k2) / 2:.4f} ms on "
              f"the kernel path, {(p1 + p2) / 2:.4f} ms on the plain path "
              f"(turns {p1:.4f} {k1:.4f} {k2:.4f} {p2:.4f})", flush=True)


def main():
    card = device_phase()
    build_phase()
    errs, times = kernel_phase()
    v1_errs = v1_kernel_phase()
    errs.update(v1_errs)
    points_cotangent_phase()
    launches = fused_trainer_phase()
    nested = nested_trainer_phase()
    launches.update(blend_o=nested["blend_o"], splat_o=nested["splat_o"])
    launch_breakdown_phase()
    nested_3d_phase()
    nested_vs_fused_phase()
    reference_phase()
    times.update(v1_time_phase())
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
