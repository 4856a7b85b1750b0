"""Time and profile the PyTorch port's PINN train step on one CUDA card.

    python scripts/profile_port_step.py [--nested | --megakernel] [--dim 3]
                                        [--profile]
    python scripts/profile_port_step.py --config5 vol|planned|fused
                                        [--profile]
    python scripts/profile_port_step.py --nested-vol [percell|blend_o|slab]
                                        [--points Q] [--cell-size S]
                                        [--n-cells N] [--profile]
    python scripts/profile_port_step.py --fused3b [--reps R]
    python scripts/profile_port_step.py --fused3s [--points Q] [--reps R]
    python scripts/profile_port_step.py --kernels [--cell-dim C] [--reps R]
    python scripts/profile_port_step.py --fused3d [--points Q] [--cell-dim C]
                                        [--reps R]
    python scripts/profile_port_step.py --fused2d [--points Q] [--cell-dim C]
                                        [--reps R]
    python scripts/profile_port_step.py --v1 [config5] [--cell-dim C]
                                        [--reps R]
    python scripts/profile_port_step.py --slab [--reps R]
    python scripts/profile_port_step.py --sampler [--reps R]

Runs the port's train step (``pinn.make_train_step``) at the main path
(96 x 4 x 16 x 16 cells, 100 000 points, hidden 16, Allen-Cahn; with
``--dim 3``: 50 x 4 x 16^3, Helmholtz; ``--points`` fresh points a step,
1 024 for path (c)), fused by default, through nested
autograd with ``--nested`` or as the one-launch megakernel gradient with
``--megakernel``, on points already on the card.  ``--config5`` runs
BASELINE config 5 (16 x 4 x 128^3, 1 000 000 fixed points, Helmholtz):
the vol-resident step (``vol``), the planned step with its per-call
relayout (``planned``) or the query-ordered step through the fused op's
route (``fused``: fused3s at this volume and point count), and prints the
step's peak device memory.  ``--nested-vol`` runs the nested
3D trainer's step on config 5's volume (16 x 4 x 128^3, Helmholtz; or
``--n-cells`` x 4 x ``--cell-size``^3, 8 x 4 x 192^3 the cells percell
takes by the rule) with ``--points`` fresh points a step (100 000 by
default), every sampler call through the route ops/cuda/route.py gives
it or, when named, through that route.  ``--fused3b`` times fused3b's
blend and bwd kernels alone
on config 5's volume and points (``--cell-dim`` channels, 4 by default,
the kernel layout), each the median of ``--reps`` calls (CUDA events)
after 3 warm-up calls; ``--fused3s`` so times fused3s's blend and bwd and
its z sort on config 5's volume at ``--points`` uniform points (the sort
made once for the kernels); ``--kernels`` so times fused2w's and
fused3w's blend and bwd (96 x C x 16^2 and 50 x C x 16^3, 100 000
points), with each one's device ms (torch.profiler) and host
microseconds to enqueue a call, and mega2w (96 x C x 16^2);
``--fused3d`` so times fused3d's and fused3w's blend and bwd at path
(c)'s stack (50 x C x 16^3) and ``--points`` uniform points (1 024 by
default); ``--fused2d`` so times fused2d's and fused2w's blend and bwd
at path (b)'s stacks (96 x C x 16^2 at 200, 1 024 and 2 047 points and
8 x C x 16^2 at 512, or 96 x C x 16^2 at ``--points``); ``--v1`` so
times the v1 pair's
blend and bwd (ops/cuda/fused.py, the fused op's route above 8 channels)
at path (a)'s shapes (96 x C x 16^2 and 50 x C x 16^3, 100 000 points)
or, with ``--v1 config5``, at config 5's volume in query order (16 x C x
128^3, 1 000 000 points);
``--slab`` so times the slab route's blend and splat kernels on config
5's volume at 100 000 shared points (cosine, and linear without
multicell, the setting of grid_sample) and on 1024 x 4 x 16^3 cells at
2^18 and 2^20 per-cell pairs, each with the bins (where the checkout's
kernels take bins) built once before the timed calls; ``--sampler`` so
times splat_o and blend_o at the 2D and 3D main paths' shapes and the
percell route's blend, splat and plan build on config 5's volume at the
nested trainer's points and on 8 x 4 x 32 x 256^2 cells at 2^20 pairs.
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
try:    # checkouts from before the fused2d kernels lack them
    from cosinesampler_tpu_torch.ops.cuda import fused2d
    _COUNTERS.update(fused2d_blend=fused2d.fused_blend,
                     fused2d_bwd=fused2d.fused_bwd)
except ImportError:
    fused2d = None
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


def _fused3b_kernels(card, reps, c):
    """Median ms of fused3b_blend_vol and fused3b_bwd_vol at config 5 with
    ``c`` channels."""
    cfg = pinn.PINNConfig(dim=3, n_cells=16, cell_dim=c, cell_size=128,
                          pde="helmholtz")
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


def _fused3s_kernels(card, reps, q):
    """Median ms of fused3s's blend and bwd on config 5's volume at ``q``
    uniform points, the z sort made once outside the timed calls."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    cfg = SamplerConfig(dim=3)
    shape = (16, 4, 128, 128, 128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = torch.rand(shape, generator=gen, device="cuda")
    pts = torch.rand((q, 3), generator=gen, device="cuda") * 2 - 1
    g = torch.randn((7, shape[1], q), generator=gen, device="cuda")
    order = fused3s.zsort(pts, shape[2], cfg)
    medians = {
        "blend": _median_ms(lambda: fused3s.fused_blend(cells, pts, cfg,
                                                        order), reps),
        "bwd": _median_ms(lambda: fused3s.fused_bwd(g, pts, shape[2:], cfg,
                                                    shape[0], order), reps),
        "z sort": _median_ms(lambda: fused3s.zsort(pts, shape[2], cfg),
                             reps)}
    print(f"{card}; fused3s kernels on {'x'.join(map(str, shape))} at {q} "
          f"points, median of {reps}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items()),
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


def _device_ms(fn, reps):
    """Device ms of one call of ``fn``: the device time of every kernel,
    fill and copy of ``reps`` calls (torch.profiler) over ``reps``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


def _device_kernels(fn, reps):
    """Each device operation of one call of ``fn``: {name: ms a call}
    (torch.profiler over ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation}


def _host_us(fn, calls=50):
    """Host microseconds to enqueue one call of ``fn``: the host clock
    around ``calls`` calls with no synchronisation inside (the launch
    queue holds them), the median of 5 such runs."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(runs)


def _main_kernels(card, c, reps):
    """Median ms of fused2w's and fused3w's kernels and mega2w at the 2D
    and 3D main paths' shapes with C channels (single calls, the host's
    share in), and each one's device ms (torch.profiler) and host
    microseconds to enqueue a call."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = 100_000
    medians, device, host = {}, {}, {}
    for mod, dim, n in ((fused2w, 2, 96), (fused3w, 3, 50)):
        cfg = SamplerConfig(dim=dim)
        spatial = (16,) * dim
        cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
        pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((1 + 2 * dim, c, q), generator=gen, device="cuda")
        for name, fn in (
                (f"fused{dim}w_blend",
                 lambda: mod.fused_blend(cells, pts, cfg)),
                (f"fused{dim}w_bwd",
                 lambda: mod.fused_bwd(g, pts, spatial, cfg, n))):
            medians[name] = _median_ms(fn, reps)
            device[name] = _device_ms(fn, reps)
            host[name] = _host_us(fn)
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
          + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items())
          + "; device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in device.items())
          + "; host us to enqueue a call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return 0


def _fused3d_kernels(card, c, reps, q):
    """Median ms of fused3d's blend and bwd and of fused3w's (the 3D small
    cloud's two routes) at path (c)'s stack (50 x C x 16^3) and ``q``
    uniform points (single calls, the host's share in), and each one's
    device ms (torch.profiler) and host microseconds to enqueue a call."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    cfg = SamplerConfig(dim=3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, spatial = 50, (16, 16, 16)
    cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
    pts = torch.rand((q, 3), generator=gen, device="cuda") * 2 - 1
    g = torch.randn((7, c, q), generator=gen, device="cuda")
    medians, device, host = {}, {}, {}
    for kind, mod in (("fused3d", fused3d), ("fused3w", fused3w)):
        for name, fn in (
                (f"{kind}_blend", lambda: mod.fused_blend(cells, pts, cfg)),
                (f"{kind}_bwd",
                 lambda: mod.fused_bwd(g, pts, spatial, cfg, n))):
            medians[name] = _median_ms(fn, reps)
            device[name] = _device_ms(fn, reps)
            host[name] = _host_us(fn)
    print(f"{card}; 3D small-cloud kernels at {n} x {c} x 16^3, {q} points, "
          f"median of {reps}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items())
          + "; device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in device.items())
          + "; host us to enqueue a call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return 0


def _fused2d_kernels(card, c, reps, q):
    """Median ms of fused2d's blend and bwd and of fused2w's (the 2D small
    cloud's two routes) at path (b)'s stacks (96 x C x 16^2 at 200, 1 024
    and 2 047 uniform points and 8 x C x 16^2 at 512, or 96 x C x 16^2 at
    ``q``; single calls, the host's share in), and each one's device ms
    (torch.profiler) and host microseconds to enqueue a call."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    cfg = SamplerConfig(dim=2)
    spatial = (16, 16)
    clouds = ((96, q),) if q else ((96, 200), (96, 1024), (96, 2047),
                                   (8, 512))
    parts = []
    for n, nq in clouds:
        gen = torch.Generator(device="cuda").manual_seed(0)
        cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
        pts = torch.rand((nq, 2), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((5, c, nq), generator=gen, device="cuda")
        medians, device, host = {}, {}, {}
        for kind, mod in (("fused2d", fused2d), ("fused2w", fused2w)):
            for name, fn in (
                    (f"{kind}_blend",
                     lambda: mod.fused_blend(cells, pts, cfg)),
                    (f"{kind}_bwd",
                     lambda: mod.fused_bwd(g, pts, spatial, cfg, n))):
                medians[name] = _median_ms(fn, reps)
                device[name] = _device_ms(fn, reps)
                host[name] = _host_us(fn)
        parts.append(
            f"{n} x {c} x 16^2, {nq} points: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items())
            + "; device ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in device.items())
            + "; host us: "
            + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    print(f"{card}; 2D small-cloud kernels, median of {reps}: "
          + " | ".join(parts), flush=True)
    return 0


def _v1_kernels(card, c, reps, shapes):
    """Median ms of the v1 blend and bwd with C channels at path (a)'s
    2D and 3D shapes (100 000 points) or at config 5's volume (1 000 000
    points), and the peak device memory of each pair."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    from cosinesampler_tpu_torch.ops.cuda import fused as fused_v1
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = ([(2, 96, 16, 100_000), (3, 50, 16, 100_000)]
             if shapes == "main" else [(3, 16, 128, 1_000_000)])
    medians = {}
    for dim, n, s, q in cases:
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        cells = torch.rand((n, c, *spatial), generator=gen, device="cuda")
        pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((1 + 2 * dim, c, q), generator=gen, device="cuda")
        what = f"{n}x{c}x{s}^{dim}, Q={q}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        medians[f"blend {what}"] = _median_ms(
            lambda: fused_v1.fused_blend(cells, pts, cfg), reps)
        medians[f"bwd {what}"] = _median_ms(
            lambda: fused_v1.fused_bwd(g, pts, spatial, cfg, n), reps)
        medians[f"peak GiB above the inputs {what}"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        del cells, pts, g
        torch.cuda.empty_cache()
    print(f"{card}; v1 pair at C = {c}, median of {reps}: "
          + ", ".join(f"{k} {v:.4f}" + ("" if "GiB" in k else " ms")
                      for k, v in medians.items()), flush=True)
    return 0


def _slab_kernels(card, reps):
    """Median ms of the slab blend and splat at the nested volume and the
    routed small cells, bins (where the wrappers take them) built once;
    and of the bins' build (also its device ms)."""
    import inspect
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    from cosinesampler_tpu_torch.ops.cuda import slab
    takes_bins = "bins" in inspect.signature(slab.blend).parameters
    gen = torch.Generator(device="cuda").manual_seed(0)
    with PointGenerator(100_000, 3, seed=7) as pgen:
        shared = torch.from_numpy(pgen.batch(0)).cuda().reshape(
            1, 1, 1, -1, 3)
    cases = [("nested 16x4x128^3, Q=100000", (16, 4, 128, 128, 128), shared)]
    for q in (256, 1024):
        grid = torch.rand((1024, 1, 1, q, 3), generator=gen,
                          device="cuda") * 1.9 - 0.95
        cases.append((f"1024x4x16^3, {1024 * q} pairs", (1024, 4, 16, 16, 16),
                      grid))
    medians = {}
    for what, shape, grid in cases:
        x = torch.rand(shape, generator=gen, device="cuda")
        gout = torch.randn((shape[0], 4, *grid.shape[1:-1]), generator=gen,
                           device="cuda")
        for name, cfg in (("cosine", SamplerConfig(dim=3)),
                          ("linear", SamplerConfig(dim=3, kernel="linear",
                                                   multicell=False))):
            if name == "linear" and shape[0] != 16:
                continue
            o = (0, 0, 0)
            kw = ({"bins": slab.make_bins(grid, shape, cfg, True)}
                  if takes_bins else {})
            if takes_bins and name == "cosine":
                build = lambda: slab.make_bins(grid, shape, cfg, True)  # noqa: E731
                medians[f"{what} bins build"] = _median_ms(build, reps)
                medians[f"{what} bins build device"] = _device_ms(build,
                                                                   reps)
            medians[f"{what} {name} blend"] = _median_ms(
                lambda: slab.blend(x, grid, cfg, o, **kw), reps)
            medians[f"{what} {name} splat"] = _median_ms(
                lambda: slab.splat(gout, grid, shape[2:], cfg, o, **kw), reps)
        del x, gout
        torch.cuda.empty_cache()
    print(f"{card}; slab kernels, median of {reps} (bins "
          f"{'built once' if takes_bins else 'not taken'}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in medians.items()),
          flush=True)
    return 0


def _sampler_kernels(card, reps):
    """Median ms of splat_o and blend_o at the 2D and 3D main paths'
    shapes (shared 100 000 points), and of the percell route's blend,
    splat and plan build on the nested volume (16 x 4 x 128^3, the nested
    trainer's 100 000 shared points; cosine, and linear without multicell,
    the setting of grid_sample) and on 8 x 4 x 32 x 256^2 cells at 2^20
    per-cell pairs; the percell ones also as device ms (torch.profiler,
    "device")."""
    from cosinesampler_tpu_torch.ops.config import SamplerConfig
    gen = torch.Generator(device="cuda").manual_seed(0)
    medians = {}
    q = 100_000
    for dim, n in ((2, 96), (3, 50)):
        cfg = SamplerConfig(dim=dim)
        spatial = (16,) * dim
        lead = (1,) * (dim - 1)
        x = torch.rand((n, 4, *spatial), generator=gen, device="cuda")
        grid = torch.rand((1, *lead, q, dim), generator=gen,
                          device="cuda") * 2 - 1
        gout = torch.randn((n, 4, *lead, q), generator=gen, device="cuda")
        o = (0,) * dim
        medians[f"{dim}D splat_o"] = _median_ms(
            lambda: blend_splat.splat(gout, grid, spatial, cfg, o), reps)
        medians[f"{dim}D blend_o"] = _median_ms(
            lambda: blend_splat.blend(x, grid, cfg, o), reps)
    with PointGenerator(q, 3, seed=7) as pgen:
        shared = torch.from_numpy(pgen.batch(0)).cuda().reshape(
            1, 1, 1, -1, 3)
    wide = torch.rand((8, 1, 1, 1 << 17, 3), generator=gen,
                      device="cuda") * 2 - 1
    for what, shape, grid in (("nested 16x4x128^3", (16, 4, 128, 128, 128),
                               shared),
                              ("8x4x32x256^2 2^20 pairs", (8, 4, 32, 256, 256),
                               wide)):
        x = torch.rand(shape, generator=gen, device="cuda")
        gout = torch.randn((shape[0], 4, *grid.shape[1:-1]), generator=gen,
                           device="cuda")
        for name, cfg in (("cosine", SamplerConfig(dim=3)),
                          ("linear", SamplerConfig(dim=3, kernel="linear",
                                                   multicell=False))):
            o = (0, 0, 0)
            plan = percell.make_plan(grid, shape, cfg)
            ops = {"plan": lambda: percell.make_plan(grid, shape, cfg),
                   "blend": lambda: percell.blend(x, grid, cfg, o, plan),
                   "splat": lambda: percell.splat(gout, grid, shape[2:], cfg,
                                                  o, plan)}
            for op, fn in ops.items():
                medians[f"{what} {name} percell {op}"] = _median_ms(fn, reps)
                medians[f"{what} {name} percell {op} device"] = _device_ms(
                    fn, reps)
            if name == "cosine":
                print(f"{card}; {what} percell plan build, device ms a "
                      "build: " + ", ".join(
                          f"{k[:60]} {v:.4f}" for k, v in
                          _device_kernels(ops["plan"], reps).items()),
                      flush=True)
        del x, gout
        torch.cuda.empty_cache()
    print(f"{card}; sampler kernels, median of {reps}: "
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
    ap.add_argument("--points", type=int,
                    help="points a step of the fused and --nested-vol "
                         "steps, or of --fused3s (100 000 by default) and "
                         "--fused3d (1 024) and --fused2d (path (b)'s "
                         "clouds)")
    ap.add_argument("--fused3b", action="store_true",
                    help="time fused3b's kernels alone at config 5")
    ap.add_argument("--fused3s", action="store_true",
                    help="time fused3s's kernels alone on config 5's "
                         "volume at --points points")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed calls of each --fused3b / --fused3s / "
                         "--kernels / --slab / --sampler kernel")
    ap.add_argument("--kernels", action="store_true",
                    help="time fused2w, fused3w and mega2w alone")
    ap.add_argument("--fused3d", action="store_true",
                    help="time fused3d's and fused3w's kernels alone at "
                         "path (c)'s stack")
    ap.add_argument("--fused2d", action="store_true",
                    help="time fused2d's and fused2w's kernels alone at "
                         "path (b)'s stacks")
    ap.add_argument("--v1", nargs="?", const="main",
                    choices=("main", "config5"),
                    help="time the v1 pair's blend and bwd alone at path "
                         "(a)'s shapes or config 5's")
    ap.add_argument("--slab", action="store_true",
                    help="time the slab route's blend and splat alone")
    ap.add_argument("--sampler", action="store_true",
                    help="time splat_o, blend_o and the percell route "
                         "alone")
    ap.add_argument("--cell-size", type=int, default=128,
                    help="cells of --cell-size^3 texels in --nested-vol "
                         "(128: config 5's volume)")
    ap.add_argument("--n-cells", type=int, default=16,
                    help="cells of --nested-vol")
    ap.add_argument("--cell-dim", type=int, default=4,
                    help="channels of --fused3b, --kernels, --v1 and the "
                         "main-path steps")
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
        return _fused3b_kernels(card, args.reps, args.cell_dim)
    if args.fused3d:
        return _fused3d_kernels(card, args.cell_dim, args.reps,
                                args.points or 1024)
    if args.fused2d:
        return _fused2d_kernels(card, args.cell_dim, args.reps, args.points)
    points = args.points or 100_000
    if args.fused3s:
        return _fused3s_kernels(card, args.reps, points)
    if args.kernels:
        return _main_kernels(card, args.cell_dim, args.reps)
    if args.v1:
        return _v1_kernels(card, args.cell_dim, args.reps, args.v1)
    if args.slab:
        return _slab_kernels(card, args.reps)
    if args.sampler:
        return _sampler_kernels(card, args.reps)
    if args.config5:
        run, pts = _config5_step(args.config5)
        batches = [pts] * (3 + args.steps)
        path = f"config 5 {args.config5}"
    elif args.nested_vol:
        if args.nested_vol != "rule":
            route.pick = lambda *a: args.nested_vol
        cfg = pinn.PINNConfig(dim=3, n_cells=args.n_cells,
                              cell_size=args.cell_size, pde="helmholtz")
        params = pinn.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cuda")
        step = pinn.make_train_step(
            cfg, torch.optim.Adam(params.values(), lr=1e-3))
        run = lambda p: step(params, p)     # noqa: E731
        with PointGenerator(points, 3, seed=7) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(3 + args.steps)]
        path = (f"nested {args.n_cells}x4x{args.cell_size}^3 ({points} "
                f"points, {args.nested_vol})")
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
        with PointGenerator(points, args.dim, seed=7) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(3 + args.steps)]
        path = ("megakernel" if args.megakernel else
                "nested" if args.nested else "fused") + \
            f" {args.dim}D C={args.cell_dim}, {points} points"

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
