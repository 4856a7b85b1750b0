"""Time and profile the PyTorch port's PINN train step on one CUDA card.

    python scripts/profile_port_step.py [--nested | --megakernel] [--dim 3]
                                        [--profile]
    python scripts/profile_port_step.py --config5 vol|planned|fused
                                        [--profile]
    python scripts/profile_port_step.py --nested-vol [percell|blend_o|slab]
                                        [--points Q] [--profile]
    python scripts/profile_port_step.py --fused3b [--reps R]
    python scripts/profile_port_step.py --kernels [--cell-dim C] [--reps R]

Runs the port's train step (``pinn.make_train_step``) at the main path
(96 x 4 x 16 x 16 cells, 100 000 points, hidden 16, Allen-Cahn; with
``--dim 3``: 50 x 4 x 16^3, Helmholtz), fused by default, through nested
autograd with ``--nested`` or as the one-launch megakernel gradient with
``--megakernel``, on points already on the card.  ``--config5`` runs
BASELINE config 5 (16 x 4 x 128^3, 1 000 000 fixed points, Helmholtz):
the vol-resident step (``vol``), the planned step with its per-call
relayout (``planned``) or the query-ordered step through the fused op's
route (``fused``: fused3s at this volume and point count), and prints the
step's peak device memory.  ``--nested-vol`` runs the nested
3D trainer's step on config 5's volume (16 x 4 x 128^3, Helmholtz) with
``--points`` fresh points a step (100 000 by default), every sampler call
through the route ops/cuda/route.py gives it or, when named, through
that route.  ``--fused3b`` times fused3b's blend and bwd kernels alone
on config 5's volume and points (4 channels, the kernel layout), each the
median of ``--reps`` calls (CUDA events) after 3 warm-up calls;
``--kernels`` so times fused2w's and fused3w's blend and bwd (96 x C x
16^2 and 50 x C x 16^3, 100 000 points) and mega2w (96 x C x 16^2).
``--cell-dim`` sets C (4 by default) for these and for the main-path
steps (at C = 16 the megakernel step of a checkout whose mega2w takes at
most 8 channels is its autograd fallback).  Prints the
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
try:    # and those from before the mega2w / fused3w kernels these
    from cosinesampler_tpu_torch.ops.cuda import fused3w, mega2w
    _COUNTERS.update(mega2w=mega2w.mega2w_step,
                     fused3w_blend=fused3w.fused_blend,
                     fused3w_bwd=fused3w.fused_bwd)
except ImportError:
    pass
try:    # and those from before the fused3b kernels these
    from cosinesampler_tpu_torch.ops import fused as tfused
    from cosinesampler_tpu_torch.ops.cuda import fused3b
    _COUNTERS.update(fused3b_blend=fused3b.fused3b_blend_vol,
                     fused3b_bwd=fused3b.fused3b_bwd_vol)
except ImportError:
    pass
try:    # and those from before the fused3d / fused3s kernels these
    from cosinesampler_tpu_torch.ops.cuda import fused3d, fused3s
    _COUNTERS.update(fused3d_blend=fused3d.fused_blend,
                     fused3d_bwd=fused3d.fused_bwd,
                     fused3s_blend=fused3s.fused_blend,
                     fused3s_bwd=fused3s.fused_bwd)
except ImportError:
    pass
try:    # and those from before the percell / slab kernels these
    from cosinesampler_tpu_torch.ops.cuda import percell, route, slab
    _COUNTERS.update(percell_blend=percell.blend, percell_splat=percell.splat,
                     slab_blend=slab.blend, slab_splat=slab.splat)
except ImportError:
    route = None


def _config5_step(kind):
    """(step taking a point batch, its fixed points) of BASELINE config 5."""
    cfg = pinn.PINNConfig(dim=3, n_cells=16, cell_size=128, pde="helmholtz")
    q = 1_000_000
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    with PointGenerator(q, 3, seed=7) as gen:
        pts = torch.from_numpy(gen.batch(0)).cuda()
    shape = tuple(params["cells"].shape)
    plan = None
    if kind == "vol":
        plan = tfused.make_vol_plan(pts, shape, cfg.sampler)
        params = pinn.params_to_vol(params, cfg, q)
    elif kind == "planned":
        plan = tfused.make_sample_plan(pts, shape, cfg.sampler)
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), fused=True,
        planned=kind == "planned", vol_resident=kind == "vol")
    if plan is None:
        return lambda p: step(params, p), pts
    return lambda p: step(params, p, plan), pts


def _fused3b_kernels(card, reps):
    """Median ms of fused3b_blend_vol and fused3b_bwd_vol at config 5."""
    cfg = pinn.PINNConfig(dim=3, n_cells=16, cell_size=128, pde="helmholtz")
    shape = (cfg.n_cells, cfg.cell_dim, *(cfg.cell_size,) * 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    vol = fused3b.cells_to_vol(torch.rand(shape, generator=gen,
                                          device="cuda"))
    with PointGenerator(1_000_000, 3, seed=7) as pgen:
        pts = torch.from_numpy(pgen.batch(0)).cuda()
    plan = tfused.make_vol_plan(pts, shape, cfg.sampler)
    g_p = torch.randn((7, shape[1], plan[1].shape[0]), generator=gen,
                      device="cuda")
    ops = {"blend": lambda: fused3b.fused3b_blend_vol(vol, plan, cfg.sampler),
           "bwd": lambda: fused3b.fused3b_bwd_vol(g_p, plan, shape[2:],
                                                  cfg.sampler, shape[0])}
    medians = {}
    for name, fn in ops.items():
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        medians[name] = statistics.median(times)
    print(f"{card}; fused3b kernels at config 5 "
          f"({'x'.join(map(str, shape))}, 1000000 points), median of {reps}:"
          f" blend {medians['blend']:.4f} ms, bwd {medians['bwd']:.4f} ms",
          flush=True)
    return 0


def _median_ms(fn, reps):
    """Median ms of ``reps`` calls of ``fn`` (CUDA events), after 3."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _main_kernels(card, c, reps):
    """Median ms of fused2w's and fused3w's kernels and mega2w at the 2D
    and 3D main paths' shapes with C channels."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = 100_000
    medians = {}
    for mod, dim, n in ((fused2w, 2, 96), (fused3w, 3, 50)):
        cfg = SamplerConfig(dim=dim)
        spatial = (16,) * dim
        cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
        pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((1 + 2 * dim, c, q), generator=gen, device="cuda")
        medians[f"fused{dim}w_blend"] = _median_ms(
            lambda: mod.fused_blend(cells, pts, cfg), reps)
        medians[f"fused{dim}w_bwd"] = _median_ms(
            lambda: mod.fused_bwd(g, pts, spatial, cfg, n), reps)
    cfg = SamplerConfig(dim=2)
    cells = torch.rand((96, c, 16, 16), generator=gen, device="cuda")
    pts = torch.rand((q, 2), generator=gen, device="cuda") * 2.2 - 1.1
    mlp = [torch.randn((c, 16), generator=gen, device="cuda") * 0.5,
           torch.randn((16,), generator=gen, device="cuda") * 0.1,
           torch.randn((16, 1), generator=gen, device="cuda") * 0.3,
           torch.full((1,), 0.1, device="cuda")]
    if c <= 8 or mega2w.supports(cfg, tuple(cells.shape), "allen_cahn", 16):
        medians["mega2w"] = _median_ms(
            lambda: mega2w.mega2w_step(cells, *mlp, pts, cfg, "allen_cahn"),
            reps)
    print(f"{card}; kernels at C = {c} (2D 96 x {c} x 16^2, 3D 50 x {c} x "
          f"16^3, 100000 points), median of {reps}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items()),
          flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nested", action="store_true",
                    help="train on the nested-autograd loss (fused=False)")
    ap.add_argument("--megakernel", action="store_true",
                    help="train with the one-launch megakernel gradient")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--config5", choices=("vol", "planned", "fused"),
                    help="BASELINE config 5 instead of the main path")
    ap.add_argument("--nested-vol", nargs="?", const="rule",
                    choices=("rule", "percell", "blend_o", "slab"),
                    help="the nested 3D step on config 5's volume, through "
                         "the route rule or the route named")
    ap.add_argument("--points", type=int, default=100_000,
                    help="points a step of --nested-vol")
    ap.add_argument("--fused3b", action="store_true",
                    help="time fused3b's kernels alone at config 5")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls of each --fused3b / --kernels kernel")
    ap.add_argument("--kernels", action="store_true",
                    help="time fused2w, fused3w and mega2w alone")
    ap.add_argument("--cell-dim", type=int, default=4,
                    help="channels of --kernels and the main-path steps")
    ap.add_argument("--steps", type=int, default=10, help="timed steps")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.fused3b:
        return _fused3b_kernels(card, args.reps)
    if args.kernels:
        return _main_kernels(card, args.cell_dim, args.reps)
    if args.config5:
        run, pts = _config5_step(args.config5)
        batches = [pts] * (3 + args.steps)
        path = f"config 5 {args.config5}"
    elif args.nested_vol:
        if args.nested_vol != "rule":
            route.pick = lambda *a: args.nested_vol
        cfg = pinn.PINNConfig(dim=3, n_cells=16, cell_size=128,
                              pde="helmholtz")
        params = pinn.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cuda")
        step = pinn.make_train_step(
            cfg, torch.optim.Adam(params.values(), lr=1e-3))
        run = lambda p: step(params, p)     # noqa: E731
        with PointGenerator(args.points, 3, seed=7) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(3 + args.steps)]
        path = f"nested 128^3 ({args.points} points, {args.nested_vol})"
    else:
        cfg = (pinn.PINNConfig(cell_dim=args.cell_dim) if args.dim == 2 else
               pinn.PINNConfig(dim=3, n_cells=50, cell_dim=args.cell_dim,
                               pde="helmholtz"))
        params = pinn.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cuda")
        step = pinn.make_train_step(
            cfg, torch.optim.Adam(params.values(), lr=1e-3),
            fused=not args.nested, megakernel=args.megakernel)
        run = lambda p: step(params, p)     # noqa: E731
        with PointGenerator(100_000, args.dim, seed=7) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(3 + args.steps)]
        path = ("megakernel" if args.megakernel else
                "nested" if args.nested else "fused") + \
            f" {args.dim}D C={args.cell_dim}"

    for pts in batches[:3]:
        run(pts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in _COUNTERS.values():
        fn.launches = 0
    times = []
    for pts in batches[3:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(pts)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    per_step = {k: fn.launches / args.steps for k, fn in _COUNTERS.items()
                if fn.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{card}; {path} step: median "
          f"{statistics.median(times):.4f} ms over {args.steps} (min {min(times):.4f}, max {max(times):.4f});"
          f" launches per step {per_step}; peak device memory {peak:.3f} GiB",
          flush=True)
    if not args.profile:
        return 0

    window = batches[3:8]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pts in window:
            run(pts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device work only: a user annotation (the optimizer's step range) is
    # also listed on the device and would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
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
