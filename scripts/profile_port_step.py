"""Time and profile the PyTorch port's PINN train step on one CUDA card.

    python scripts/profile_port_step.py [--nested] [--dim 3] [--profile]

Runs the port's train step (``pinn.make_train_step``) at the main path
(96 x 4 x 16 x 16 cells, 100 000 points, hidden 16, Allen-Cahn; with
``--dim 3``: 50 x 4 x 16^3, Helmholtz), fused by default or through nested
autograd with ``--nested``, on points already on the card.  Prints the
card's name and power limit, the median step time (CUDA events, 3 warm-up
steps) and the kernel launches per step.  ``--profile`` adds a
torch.profiler window of 5 steps: device time per step, the device's busy
share of the host wall time, and the kernels that take the most device
time.  The package it imports is the one on ``PYTHONPATH``, so one call
can time two checkouts in turns.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from cosinesampler_tpu_torch.models import pinn
from cosinesampler_tpu_torch.ops.cuda import fused2w
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

_COUNTERS = {"fused2w_blend": fused2w.fused_blend,
             "fused2w_bwd": fused2w.fused_bwd}
try:    # checkouts from before the blend_o / splat_o kernels lack them
    from cosinesampler_tpu_torch.ops.cuda import blend_splat
    _COUNTERS.update(blend_o=blend_splat.blend, splat_o=blend_splat.splat)
except ImportError:
    pass


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nested", action="store_true",
                    help="train on the nested-autograd loss (fused=False)")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--steps", type=int, default=10, help="timed steps")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = (pinn.PINNConfig() if args.dim == 2 else
           pinn.PINNConfig(dim=3, n_cells=50, pde="helmholtz"))
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3),
        fused=not args.nested)
    with PointGenerator(100_000, args.dim, seed=7) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda()
                   for i in range(3 + args.steps)]
    for pts in batches[:3]:
        step(params, pts)
    torch.cuda.synchronize()
    for fn in _COUNTERS.values():
        fn.launches = 0
    times = []
    for pts in batches[3:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, pts)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    per_step = {k: fn.launches / args.steps for k, fn in _COUNTERS.items()}
    path = "nested" if args.nested else "fused"
    print(f"{card}; {path} {args.dim}D step: median "
          f"{statistics.median(times):.4f} ms over {args.steps} (min {min(times):.4f}, max {max(times):.4f});"
          f" launches per step {per_step}", flush=True)
    if not args.profile:
        return 0

    window = batches[3:8]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pts in window:
            step(params, pts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    n = len(window)
    print(f"profile ({n} steps): device {device_ms / n:.4f} ms per step, "
          f"host wall {wall_ms / n:.4f} ms per step, device busy "
          f"{device_ms / wall_ms:.1%}; {sum(e.count for e in events) / n:.0f}"
          f" device operations per step", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/step "
              f"{e.count / n:6.1f} calls/step  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
