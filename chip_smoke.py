"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card (main-path shape and small
variants), drives the port's default trainer at the main path (96 cells x
4 ch x 16 x 16, 100 000 points, hidden 16, Allen-Cahn) for 20 steps, checks
that the trainer went through both kernels, compares the kernel path with
the plain path on a small input, and times kernels and steps against their
plain versions.  The last lines are a JSON object of the kernels, the card's
name and power limit as nvidia-smi prints them, and a JSON status object.
Any failure raises: the script then exits non-zero and prints no status.
It needs one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import torch

from cosinesampler_tpu_torch.models import pinn
from cosinesampler_tpu_torch.models.train import TrainConfig, train
from cosinesampler_tpu_torch.ops.config import SamplerConfig
from cosinesampler_tpu_torch.ops.cuda import build, fused2w
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

# main path: BASELINE config 3 / bench.py's headline
N, C, H, W, Q = 96, 4, 16, 16, 100_000
STEPS = 20
# kernel vs plain: max |kernel - plain| over the largest |plain| of the row
# (f32, other summation order, f32 atomics in the bwd)
REL_TOL = 1e-4
SOURCE = "cosinesampler_tpu_torch/csrc/fused2w.cu"
REPLACES = {
    "fused2w_blend": "cosinesampler_tpu/ops/pallas/fused2w.py:276",
    "fused2w_bwd": "cosinesampler_tpu/ops/pallas/fused2w.py:432",
}


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


def _inputs(n, c, h, w, q, seed):
    gen = torch.Generator().manual_seed(seed)
    cells = torch.rand((n, c, h, w), generator=gen, dtype=torch.float32)
    pts = torch.rand((q, 2), generator=gen, dtype=torch.float32) * 2.4 - 1.2
    g = torch.randn((5, c, q), generator=gen, dtype=torch.float32)
    return [t.cuda() for t in (cells, pts, g)]


def _rel_err(got, want):
    """(max abs error, max over rows of max abs error / row's max |want|)."""
    diff = (got - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1).clamp_min(1e-30)
    return float(diff.max()), float((diff / scale).max())


def compare(name, cfg, n, c, h, w, q, seed=0):
    """Both kernels against their plain versions on the card."""
    cells, pts, g = _inputs(n, c, h, w, q, seed)
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

    cells, pts, g = _inputs(N, C, H, W, Q, seed=3)
    ops = {
        "fused2w_blend": (lambda: fused2w.fused_blend(cells, pts, main),
                          lambda: fused2w.plain_fused_blend(cells, pts, main)),
        "fused2w_bwd": (lambda: fused2w.fused_bwd(g, pts, (H, W), main, N),
                        lambda: fused2w.plain_fused_bwd(g, pts, (H, W), main,
                                                        N)),
    }
    times = {}
    for name, (kernel, plain) in ops.items():
        # in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (_time_ms(fn, 10) for fn in (plain, kernel, kernel,
                                                      plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"time {name} at the main path: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms", flush=True)
    return {"fused2w_blend": errs[0], "fused2w_bwd": errs[1]}, times


def trainer_phase():
    """The port's default trainer at the main path, on the card."""
    fused2w.fused_blend.launches = 0
    fused2w.fused_bwd.launches = 0
    params, metrics = train(TrainConfig(device="cuda", steps=STEPS,
                                        log_every=1, seed=0))
    launches = {"fused2w_blend": fused2w.fused_blend.launches,
                "fused2w_bwd": fused2w.fused_bwd.launches}
    losses = [m["loss"] for m in metrics]
    print(f"train: {STEPS} steps at {N}x{C}x{H}x{W}, {Q} points; losses "
          f"{' '.join(f'{v:.6g}' for v in losses)}; launches {launches}",
          flush=True)
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        raise RuntimeError("trainer loss is not finite at every step")
    if not losses[-1] < losses[0]:
        raise RuntimeError("trainer loss did not decrease")
    if any(n != STEPS for n in launches.values()):
        raise RuntimeError(f"expected {STEPS} launches of each kernel, got "
                           f"{launches}")
    for k, v in params.items():
        if not (v.is_cuda and torch.isfinite(v).all()):
            raise RuntimeError(f"parameter {k} is not finite on the card")
    return launches


def reference_phase():
    """Kernel path on the card against the plain path on the CPU, on a
    small input: loss at rtol 1e-5, every gradient leaf at rtol 1e-4 of its
    largest magnitude."""
    cfg = pinn.PINNConfig(n_cells=8)
    with PointGenerator(4096, 2, seed=5) as gen:
        pts = torch.from_numpy(gen.batch(0))
    results = {}
    for device in ("cpu", "cuda"):
        params = pinn.init_params(torch.Generator().manual_seed(5), cfg,
                                  device)
        loss = pinn.loss_fused(params, pts.to(device), cfg)
        loss.backward()
        results[device] = (float(loss.detach()),
                           {k: v.grad.cpu() for k, v in params.items()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results["cpu"], results["cuda"]
    worst = max(float((g_gpu[k] - g_cpu[k]).abs().max()
                      / g_cpu[k].abs().max().clamp_min(1e-30)) for k in g_cpu)
    print(f"reference: loss kernel path {l_gpu:.8g} vs plain CPU {l_cpu:.8g}; "
          f"worst gradient leaf rel err {worst:.3e}", flush=True)
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu) or worst > 1e-4:
        raise RuntimeError("kernel path disagrees with the plain CPU path")


def step_phase():
    """Median step ms (CUDA events, 3 warm-up steps) on the kernel path and
    with the same steps through the plain versions (backend='xla')."""
    with PointGenerator(Q, 2, seed=7) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda() for i in range(13)]

    def median_ms(backend):
        cfg = pinn.PINNConfig(backend=backend)
        params = pinn.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cuda")
        step = pinn.make_train_step(
            cfg, torch.optim.Adam(params.values(), lr=1e-3), fused=True)
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

    p1, k1, k2, p2 = (median_ms(b) for b in ("xla", "auto", "auto", "xla"))
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"step: median train step {kernel_ms:.4f} ms on the kernel path, "
          f"{plain_ms:.4f} ms on the plain path (turns {p1:.4f} {k1:.4f} "
          f"{k2:.4f} {p2:.4f})", flush=True)


def main():
    card = device_phase()
    build_phase()
    errs, times = kernel_phase()
    launches = trainer_phase()
    reference_phase()
    step_phase()
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
