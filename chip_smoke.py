"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--parent CHECKOUT]

Builds the CUDA kernels from the sources in this checkout and holds each
against its plain PyTorch version on the card (main-path shapes and small
variants).  Then it drives the port's training paths at full width: the
fused trainer (96 cells x 4 ch x 16 x 16, 100 000 points, hidden 16,
Allen-Cahn) for 20 steps through fused2w_blend / fused2w_bwd, the
megakernel trainer (``megakernel=True``) for 20 steps through mega2w, the
nested-autograd trainer (``fused=False``, the public sampler to third
order) for 10 steps through blend_o / splat_o, the 3D Helmholtz trainer
(50 x 4 x 16^3) for 3 steps nested and 3 steps fused through
fused3w_blend / fused3w_bwd, the vol-resident trainer of BASELINE config 5
(16 x 4 x 128^3, 1 000 000 points) for 5 steps through fused3b_blend /
fused3b_bwd (and 3 steps with the ghost route on, through
fused3b_bwd_ghost: private super-bricks and their fold, held to its
plain versions and timed against fused3b_bwd at rb 1, 2, 4 and 8 and at
16 channels), and the nested 3D trainer on config 5's volume (100 000
points) for 3 steps through the route ops/cuda/route.py gives it
(slab_blend / slab_splat over the slab bins, one build a step) and 3
steps forced through percell (percell_blend / percell_splat); the
per-cell surface of 4 x 4 x 128^3 cells (per-cell 16^3 grids), its
sparse case, a 4 x 4 x 1024^2 2D volume and a stack of 1024 x 4 x 16^3
cells go through their routes too, and percell, slab, the percell plan
and the slab bins are held to their plain versions at all those shapes,
at a skewed and a sparse cloud on config 5's volume and (percell) on 8 x
4 x 32 x 256^2 cells at 2^20 pairs; percell's tiles, splat_o's and
blend_o's launch geometries, mega2w's work units and the lane layouts
of fused3b_bwd's and fused3s_bwd's shared scatter and of fused3b_blend's
and fused3s_blend's shared gather are each timed against their
alternatives (the sweeps behind percell.geometry,
blend_splat.splat_geometry, blend_splat.blend_geometry,
mega2w.geometry, scatter.scatter_geometry and gather.gather_geometry), and
so is fused2w_bwd's and fused3w_bwd's scatter, with its destination
(the texel-major scratch or the cotangent in place) on both sides of its
planar bound (the sweep behind fused2w.bwd_geometry), and fused2w_blend's
and fused3w_blend's gather (cell lanes, threads, the texel-major copy or
the cells in place: the sweep behind v1.narrow_lanes and the planar
bound), each blend held to its plain version under every interpolant,
padding, multicell and align_corners setting, strict reference, and C
in {1, 3, 4, 8, 12, 16}, through both reads.
The layout move between the cells and the texel-major volume
(fused3b.cells_to_vol / vol_to_cells, a tiled transpose on the card) is
held to torch's permuted copy bit for bit and counted on the planned
op.  At 16 feature channels
the 2D trainer (20 steps) and the 3D trainer (5) go through the routed
v1 kernels (fused_blend / fused_bwd: texel-major gathers and scatters),
held to their plain versions at C in {9, 12, 16, 32, 64}, in every
variant and on large cells in every launch layout their sweep times
(v1_layout_sweep_phase, the measurement behind ops/cuda/v1.py), and at
config 5's C = 16 volume in query order; the megakernel trainer (5)
through mega2w's channel groups; fused2w's and fused3w's channel groups
and the wide mega2w are held to their plain versions at 9 to 124
channels and timed
against the v1 pair (the sweep behind the fused op's rule above 8
channels); the nested trainers' blends and splats a step are counted
(no kernel for a cotangent nothing reads);
the small-cloud kernels (fused2d_blend / fused2d_bwd) are held to theirs
(also in every launch layout their sweep times, the sweep behind
ops/cuda/fused2d.py's layout rule, the blend bit-identical across calls),
timed against fused2w (the sweep behind the fused op's rule), routed at
their shapes, and the 2D fused trainer runs through them at 96 x 4 x 16^2
with 1 024 fresh points a step (path (b), 3 steps, card vs CPU).  In 3D
the small- and large-cloud kernels (fused3d_blend / fused3d_bwd,
fused3s_blend / fused3s_bwd) are held to their plain
versions (fused3d also in every launch layout its sweep times, the
sweep behind ops/cuda/fused3d.py's layout rule), timed against fused3w
and fused3b (the sweep behind the 3D rule), and the 3D fused trainer runs
through them with fresh points: 50 x 4 x 16^3 at 1024 points and 16 x 4 x
32^3 at 4096 (both fused3d by the rule) and config 5's 16 x 4 x 128^3 at
393 216 (fused3s), 3 steps each; with ``--parent CHECKOUT`` fused3d's
pair is also timed in turns against that checkout's.  fused3b's channel groups are held to its plain versions at C = 16
on config 5's volume, and the vol-resident trainer runs there at C = 16
(16 x 16 x 128^3, 3 steps) against the query-ordered v1 trainer.  The
calls no kernel takes (f64, strict 2D with align_corners off, 2^31
elements) must take the counted plain route and match the CPU, so must
a fused op call and a step of the 2D and 3D fused, the megakernel and
the vol-resident trainers at precision "bf16" (matching "exact"), and
exact mode must give the same losses under
torch.set_float32_matmul_precision("high").  It checks from the launch
counters that each path went through its kernels and no other, compares
the megakernel losses with the fused ones, the vol-resident losses with
the query-ordered trainer's, the routed nested 128^3 losses with the blend_o
route's, the nested loss with the fused one and the card with the CPU,
and times kernels, library calls and steps against their plain versions,
the bricked kernels against fused3w at config 5, and the sampler's routes
against each other (the measurement behind route.rule).  The last lines
are a JSON object of the kernels, the card's name and power limit as
nvidia-smi prints them, and a JSON status object.  Any failure raises: the script then exits
non-zero and prints no status.  It needs one CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from cosinesampler_tpu_torch.models import pinn
from cosinesampler_tpu_torch.models.train import TrainConfig, train
from cosinesampler_tpu_torch.ops import fused as tfused
from cosinesampler_tpu_torch.ops import generic
from cosinesampler_tpu_torch.ops.api import (cosine_sampler_2d,
                                             cosine_sampler_3d)
from cosinesampler_tpu_torch.ops.config import SamplerConfig, effective_align
from cosinesampler_tpu_torch.ops.cuda import fused as fused_v1
from cosinesampler_tpu_torch.ops.cuda import (blend_splat, build, fused2d,
                                              fused2w, fused3b, fused3d,
                                              fused3s, fused3w, gather,
                                              mega2w, percell, route,
                                              scatter, slab, v1)
from cosinesampler_tpu_torch.ops.sampler import sample
from cosinesampler_tpu_torch.utils.pointgen import PointGenerator

# main path: BASELINE config 3 / bench.py's headline
N, C, H, W, Q = 96, 4, 16, 16, 100_000
HIDDEN = 16
# the reference's test_3d workload
N3, S3 = 50, 16
STEPS, NESTED_STEPS, STEPS_3D = 20, 10, 3
# BASELINE config 5: the vol-resident 3D trainer at full width
N5, S5, Q5, STEPS_VOL = 16, 128, 1_000_000, 5
# the nested 3D trainer on config 5's volume with the reference's 3D point
# count (test_3d.py), through the over-budget route (slab; percell forced)
QN, STEPS_NESTED_VOL = 100_000, 3
# the per-cell surface of scripts/smoke_slab.py: 4 x 4 x 128^3 cells,
# per-cell (16, 16, 16) grids; its sparse case (2, 2, 2); and a 2D volume
# over a block's shared memory, 4 x 4 x 1024^2 with per-cell 128^2 grids
NP, SP, GP, GP_SPARSE = 4, 128, 16, 2
S2D, G2D = 1024, 128
# a stack over L2 of cells under a block's shared memory: per-cell points
NS, SS, GS = 1024, 16, 1024
# cells whose rows the slab kernels cannot stage (percell's route): 8 x 4
# x 32 x 256^2 at 2^20 (cell, query) pairs
NW, SW, QW = 8, (32, 256, 256), 1 << 20
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
    "fused3b_bwd_ghost": "cosinesampler_tpu_torch/csrc/fused3b_ghost.cu",
    "percell_blend": "cosinesampler_tpu_torch/csrc/percell.cu",
    "percell_splat": "cosinesampler_tpu_torch/csrc/percell.cu",
    "slab_blend": "cosinesampler_tpu_torch/csrc/slab.cu",
    "slab_splat": "cosinesampler_tpu_torch/csrc/slab.cu",
    "fused_blend": "cosinesampler_tpu_torch/csrc/fused.cu",
    "fused_bwd": "cosinesampler_tpu_torch/csrc/fused.cu",
    "fused2d_blend": "cosinesampler_tpu_torch/csrc/fused2d.cu",
    "fused2d_bwd": "cosinesampler_tpu_torch/csrc/fused2d.cu",
    "fused3d_blend": "cosinesampler_tpu_torch/csrc/fused3d.cu",
    "fused3d_bwd": "cosinesampler_tpu_torch/csrc/fused3d.cu",
    "fused3s_blend": "cosinesampler_tpu_torch/csrc/fused3s.cu",
    "fused3s_bwd": "cosinesampler_tpu_torch/csrc/fused3s.cu",
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
    "fused3b_bwd_ghost": "cosinesampler_tpu/ops/pallas/fused3b.py:908",
    "percell_blend": "cosinesampler_tpu/ops/pallas/percell.py:238",
    "percell_splat": "cosinesampler_tpu/ops/pallas/percell.py:368",
    "slab_blend": "cosinesampler_tpu/ops/pallas/slab.py:146",
    "slab_splat": "cosinesampler_tpu/ops/pallas/slab.py:295",
    "fused_blend": "cosinesampler_tpu/ops/pallas/fused.py:93",
    "fused_bwd": "cosinesampler_tpu/ops/pallas/fused.py:193",
    "fused2d_blend": "cosinesampler_tpu/ops/pallas/fused2d.py:74",
    "fused2d_bwd": "cosinesampler_tpu/ops/pallas/fused2d.py:154",
    "fused3d_blend": "cosinesampler_tpu/ops/pallas/fused3d.py:77",
    "fused3d_bwd": "cosinesampler_tpu/ops/pallas/fused3d.py:158",
    "fused3s_blend": "cosinesampler_tpu/ops/pallas/fused3s.py:110",
    "fused3s_bwd": "cosinesampler_tpu/ops/pallas/fused3s.py:197",
}
# each kernel's launch counter
COUNTERS = {
    "fused2w_blend": fused2w.fused_blend, "fused2w_bwd": fused2w.fused_bwd,
    "blend_o": blend_splat.blend, "splat_o": blend_splat.splat,
    "mega2w": mega2w.mega2w_step,
    "fused3w_blend": fused3w.fused_blend, "fused3w_bwd": fused3w.fused_bwd,
    "fused3b_blend": fused3b.fused3b_blend_vol,
    "fused3b_bwd": fused3b.fused3b_bwd_vol,
    "fused3b_bwd_ghost": fused3b.fused3b_bwd_ghost_vol,
    "percell_blend": percell.blend, "percell_splat": percell.splat,
    "slab_blend": slab.blend, "slab_splat": slab.splat,
    "fused_blend": fused_v1.fused_blend, "fused_bwd": fused_v1.fused_bwd,
    "fused2d_blend": fused2d.fused_blend, "fused2d_bwd": fused2d.fused_bwd,
    "fused3d_blend": fused3d.fused_blend, "fused3d_bwd": fused3d.fused_bwd,
    "fused3s_blend": fused3s.fused_blend, "fused3s_bwd": fused3s.fused_bwd,
    # the plain route of the calls no kernel takes (ops/cuda/route.py): no
    # training path may take it
    "plain": route.run_plain,
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

FUSED_MODS = {"fused2w": fused2w, "fused3w": fused3w, "fused": fused_v1,
              "fused2d": fused2d, "fused3d": fused3d, "fused3s": fused3s}
# points to +-1.4: corners out of range on every side
WIDE = dict(lo=-1.4, hi=1.4)


def _fused_inputs(n, c, spatial, q, seed, lo=-1.2, hi=1.2):
    """Cells (N, C, *spatial), points (Q, d) in [lo, hi] and a cotangent
    (1+2d, C, Q) on the card, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    dim = len(spatial)
    cells = torch.rand((n, c, *spatial), generator=gen, dtype=torch.float32)
    pts = (torch.rand((q, dim), generator=gen, dtype=torch.float32)
           * (hi - lo) + lo)
    g = torch.randn((1 + 2 * dim, c, q), generator=gen, dtype=torch.float32)
    return [t.cuda() for t in (cells, pts, g)]


def compare_fused(kind, name, cfg, n, c, spatial, q, seed=0, lo=-1.2,
                  hi=1.2, pts=None):
    """The blend and bwd of ``kind`` (a key of FUSED_MODS) against their
    plain versions on the card; points in [lo, hi], or ``pts`` (Q, d)."""
    mod = FUSED_MODS[kind]
    cells, rand_pts, g = _fused_inputs(n, c, spatial, q, seed, lo, hi)
    pts = rand_pts if pts is None else pts.cuda()
    out = mod.fused_blend(cells, pts, cfg)
    ref = mod.plain_fused_blend(cells, pts, cfg)
    dcells = mod.fused_bwd(g, pts, spatial, cfg, n)
    dref = mod.plain_fused_bwd(g, pts, spatial, cfg, n)
    torch.cuda.synchronize()
    if out.shape != ref.shape or dcells.shape != dref.shape:
        raise RuntimeError(f"{kind} {name}: shape mismatch")
    if not (torch.isfinite(out).all() and torch.isfinite(dcells).all()):
        raise RuntimeError(f"{kind} {name}: non-finite kernel output")
    abs_b, rel_b = _rel_err(out, ref)
    abs_d, rel_d = _rel_err(dcells.reshape(1, -1), dref.reshape(1, -1))
    print(f"compare {kind} {name} ({n}x{c}x{'x'.join(map(str, spatial))}, "
          f"Q={q}, points in [{lo:g}, {hi:g}]): blend max abs err "
          f"{abs_b:.3e}, rel {rel_b:.3e}; bwd max abs err {abs_d:.3e}, rel "
          f"{rel_d:.3e} (tolerance rel {REL_TOL:g})", flush=True)
    if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
        raise RuntimeError(f"{kind} {name}: kernel disagrees with the plain "
                           "version")
    return abs_b, abs_d


def compare_bwd_planar_sides(dim, n, spatial, c=C, seed=6):
    """fused{dim}w at half and twice fused2w.PLANAR_POINTS_PER_TEXEL
    points a texel of (N, C, *spatial) cells, points to +-1.4: the rule's
    bwd adds into the cotangent in place (planar) below the bound and
    through the texel-major scratch above it, each held to plain."""
    bound = fused2w.PLANAR_POINTS_PER_TEXEL[dim] * math.prod(spatial)
    for q, planar in ((max(1, int(bound / 2)), True),
                      (int(2 * bound) + 1, False)):
        if fused2w.bwd_geometry(dim, n, c, q, spatial).planar != planar:
            raise RuntimeError(f"fused{dim}w_bwd's rule is not planar "
                               f"{planar} at Q = {q}")
        compare_fused(f"fused{dim}w",
                      f"bwd {'planar' if planar else 'texel-major'} "
                      f"C={c}", SamplerConfig(dim=dim), n, c, spatial, q,
                      seed=seed, **WIDE)


def kernel_phase():
    main = SamplerConfig(dim=2)
    errs = compare_fused("fused2w", "main-path", main, N, C, (H, W), Q)
    small = (8, 3, (12, 10), 4096)
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
        compare_fused("fused2w", name, SamplerConfig(dim=2, **kw), *small,
                      seed=1)
    compare_fused("fused2w", "large-cell", main, 2, 4, (128, 128), 4096,
                  seed=2)
    # scalar reductions (C = 1, 3, 5), two float4 groups (8), a partial
    # last block of queries, and both sides of the bwd's planar bound
    for c in (1, 3, 5, 8):
        compare_fused("fused2w", f"channels-{c}", main, 6, c, (12, 10),
                      4096, seed=2)
    compare_fused("fused2w", "q-4099", main, 6, 3, (12, 10), 4099, seed=3)
    compare_bwd_planar_sides(2, 2, (128, 128))

    cells, pts, g = _fused_inputs(N, C, (H, W), Q, seed=3)
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


# orders that put each of 0..3 on every axis
STAGED_ORDERS = {2: [(0, 0), (1, 2), (2, 3), (3, 1)],
                 3: [(0, 0, 0), (1, 2, 3), (2, 3, 0), (3, 0, 1)]}


def staged_blend_checks():
    """blend_o alone against generic.blend at orders 0..3 on every axis,
    shared and per-cell grids, all three paddings: on the 3D main shape and
    a 2D stack (staged, channels interleaved), at 3 channels (staged,
    channel planes) and on a stack too large to stage (unstaged)."""
    cases = [(3, N3, C, (S3,) * 3, Q), (2, 24, C, (H, W), 20_000),
             (2, 10, 3, (12, 20), 4099), (3, 2, C, (32, 32, 32), 4096)]
    for dim, n, c, spatial, q in cases:
        geom = blend_splat.blend_geometry(n, c, spatial, q)
        worst = 0.0
        for padding in ("zeros", "border", "reflection"):
            cfg = SamplerConfig(dim=dim, padding_mode=padding)
            for grid_batch in (1, n):
                x, grid, _ = _v1_inputs(dim, n, c, spatial, q, seed=21,
                                        grid_batch=grid_batch, lo=-1.2,
                                        hi=1.2)
                for orders in STAGED_ORDERS[dim]:
                    out = blend_splat.blend(x, grid, cfg, orders)
                    ref = blend_splat.plain_blend(x, grid, cfg, orders)
                    if not torch.isfinite(out).all():
                        raise RuntimeError("blend_o: non-finite output")
                    _, rel = _rel_err(out.reshape(1, -1), ref.reshape(1, -1))
                    worst = max(worst, rel)
                    if not rel <= REL_TOL:
                        raise RuntimeError(
                            f"blend_o {n}x{c}x{spatial} {padding} grid batch "
                            f"{grid_batch} orders {orders}: rel {rel:.3e}")
                del x, grid
        print(f"compare blend_o {n}x{c}x{'x'.join(map(str, spatial))}, Q={q} "
              f"(geometry {tuple(geom)}): 3 paddings x grid batch 1 and {n} "
              f"x orders {STAGED_ORDERS[dim]}: worst rel {worst:.3e} "
              f"(tolerance {REL_TOL:g})", flush=True)
    if blend_splat.blend_geometry(2, C, (32, 32, 32), 4096).cells != 0:
        raise RuntimeError("blend_o: the 512 KB cell is staged")


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
    # per-cell grids at the main shapes: splat_o's blocks of cells then
    # read a grid row a cell
    compare_v1("2d-main-per-cell", SamplerConfig(dim=2), N, C, (H, W), Q,
               [(0, 0), (1, 2)], seed=7, grid_batch=N)
    compare_v1("3d-main-per-cell", SamplerConfig(dim=3), N3, C, (S3,) * 3, Q,
               [(0, 0, 0), (0, 2, 1)], seed=8, grid_batch=N3)
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
    # 3 cells of 3 x 7 x 9 floats: lanes over 2 cells, and a cell whose
    # floats are not a multiple of 4 flushed by global atomics
    if blend_splat.splat_geometry(3, 3, (7, 9), 4099).lanes != 2:
        raise RuntimeError("splat_o: the odd-cell variant takes other lanes")
    compare_v1("odd-cell", SamplerConfig(dim=2), 3, 3, (7, 9), 4099,
               [(0, 0), (1, 2)], seed=9, **wide)
    # cells too large for shared memory even opted in: global atomics
    compare_v1("2d-large-cell", SamplerConfig(dim=2), 2, 4, (128, 128), 4096,
               [(0, 0), (0, 1)], seed=4, **wide)
    compare_v1("3d-large-cell", SamplerConfig(dim=3), 2, 4, (32, 32, 32), 4096,
               [(0, 0, 0), (1, 0, 0)], seed=5, **wide)

    staged_blend_checks()

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
    cells, pts, g = _fused_inputs(8, 3, (12, 10), 4099, seed=8)
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
    # the staged units' edges: N not a multiple of the chunks (7 cells in
    # one chunk, 97 in three of 25 and one of 22), fewer queries than slices
    # (100 and 1), and the largest cell one block stages (4 x 120 x 120)
    # beside the smallest it cannot (4 x 121 x 120: the global path)
    for name, args in [("n-7", (7, 4, 16, 16, Q)), ("n-97", (97, 4, 16, 16, Q)),
                       ("q-100", (N, 4, 16, 16, 100)),
                       ("q-1", (N, 4, 16, 16, 1)),
                       ("staging-limit", (2, 4, 120, 120, 4096)),
                       ("past-staging-limit", (2, 4, 121, 120, 4096)),
                       # 189 floats a cell: staged and flushed without
                       # bulk copies (not a multiple of 16 bytes)
                       ("odd-cell", (5, 3, 7, 9, 4099))]:
        geom = mega2w.geometry(*args, HIDDEN)
        print(f"mega2w {name}: work units {tuple(geom)}", flush=True)
        compare_mega(name, main, *args, seed=7)
    if (mega2w.geometry(2, 4, 120, 120, 4096, HIDDEN).chunks == 0
            or mega2w.geometry(2, 4, 121, 120, 4096, HIDDEN).chunks != 0):
        raise RuntimeError("mega2w: the staging limit moved; the cases "
                           "above no longer straddle it")
    # w1 scaled so |pre-activation| reaches ~40: tanh saturates and d1 -> 0;
    # the outputs must stay finite (the errors are printed, not checked:
    # d1 = 1 - h^2 keeps only a few bits there)
    compare_mega("saturated-tanh", main, 8, 4, 16, 16, 4096, seed=6,
                 scale=10.0, check=False)
    return err


# --- fused3w ------------------------------------------------------------------

def fused3w_kernel_phase():
    main = SamplerConfig(dim=3)
    errs = compare_fused("fused3w", "main-path", main, N3, C, (S3,) * 3, Q)
    small = (6, 3, (7,) * 3, 4096)
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
        compare_fused("fused3w", name, SamplerConfig(dim=3, **kw), *small,
                      seed=1)
    for c in (1, 3, 5, 8):
        compare_fused("fused3w", f"channels-{c}", main, 6, c, (7,) * 3,
                      4096, seed=2)
    compare_fused("fused3w", "q-4099", main, 6, 3, (7,) * 3, 4099, seed=3)
    compare_fused("fused3w", "large-cell", main, 2, 4, (32,) * 3, 4096,
                  seed=4)
    compare_bwd_planar_sides(3, 2, (32,) * 3)

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


# --- fused2w_blend / fused3w_blend: the texel-major gather -------------------

# the blends' settings: every interpolant, padding mode, multicell and
# align_corners, and strict reference where the kernels take it (in 2D
# with align_corners only)
W_BLEND_SETTINGS = [
    dict(kernel=k, padding_mode=p, multicell=m, align_corners=a)
    for k in ("cosine", "linear", "smoothstep")
    for p in ("zeros", "border", "reflection")
    for m in (True, False) for a in (True, False)]
W_BLEND_STRICT = {
    2: [dict(padding_mode="reflection", multicell=m, strict_reference=True)
        for m in (True, False)],
    3: [dict(padding_mode="reflection", multicell=m, align_corners=a,
             strict_reference=True) for m in (True, False)
        for a in (True, False)]}
W_BLEND_CHANNELS = (1, 3, 4, 8, 12, 16)


def _w_blend_reads(dim, n, c, q, spatial):
    """The rule's layout and the same lanes through the other read (the
    texel-major copy or the cells in place)."""
    rule = v1.blend_geometry(dim, n, c, q, spatial)
    return {"rule": rule, "other read": rule._replace(planar=not rule.planar)}


def compare_w_blend(dim, what, cfg, n, c, spatial, q, seed):
    """fused{dim}w_blend through each of _w_blend_reads's layouts against
    plain_fused_blend on the same inputs (points to +-1.4); the worst
    relative error."""
    cells, pts, _ = _fused_inputs(n, c, spatial, q, seed, **WIDE)
    want = fused2w.plain_fused_blend(cells, pts, cfg)
    worst = 0.0
    for name, geom in _w_blend_reads(dim, n, c, q, spatial).items():
        got = fused2w.launch_blend(cells, pts, cfg, geom)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"fused{dim}w_blend {what} {name}: shape or "
                               "non-finite values")
        _, rel = _rel_err(got, want)
        if not rel <= REL_TOL:
            raise RuntimeError(f"fused{dim}w_blend {what} {name} "
                               f"{tuple(geom)}: disagrees with the plain "
                               f"version ({rel:.3e})")
        worst = max(worst, rel)
    return worst


def w_blend_kernel_phase():
    """fused2w_blend and fused3w_blend against plain_fused_blend at 1e-4
    of each row's largest |plain|, each through the rule's layout and the
    other read (texel-major copy or planar): every
    setting of W_BLEND_SETTINGS and the strict ones at C = 3 (scalar
    loads) and 4 (float4), and C in W_BLEND_CHANNELS in each padding
    mode, at N = 6 on small cells, 1000 points to +-1.4 (a full and a
    partial block of 128 queries)."""
    for dim, spatial in ((2, (12, 10)), (3, (7, 8, 9))):
        worst, count = 0.0, 0
        for kw in W_BLEND_SETTINGS + W_BLEND_STRICT[dim]:
            for c in (3, 4):
                worst = max(worst, compare_w_blend(
                    dim, f"{kw} C={c}", SamplerConfig(dim=dim, **kw), 6, c,
                    spatial, 1000, seed=40 + c))
                count += 1
        for c in W_BLEND_CHANNELS:
            for pad in ("zeros", "border", "reflection"):
                worst = max(worst, compare_w_blend(
                    dim, f"{pad} C={c}",
                    SamplerConfig(dim=dim, padding_mode=pad), 6, c, spatial,
                    1000, seed=50 + c))
                count += 1
        print(f"compare fused{dim}w_blend: {count} settings x (rule, other "
              f"read) against plain, worst rel err "
              f"{worst:.3e} (tolerance {REL_TOL:g})", flush=True)


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
    qp = plan[1].shape[0]
    g_p = torch.randn((7, c, qp), generator=_cuda_gen(seed + 1),
                      device="cuda")
    # the blend's torch.empty output most likely gets this freed block of
    # NaNs back from the caching allocator: a slot it leaves unwritten
    # then reads NaN, not a stale zero
    torch.full((7, c, qp), math.nan, device="cuda")
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
    pads = plan[1] == 0
    empty = (plan[4] == 0).repeat_interleave(fused3b.Q_BLOCK)
    if bool((out[:, :, pads] != 0).any()):
        raise RuntimeError(f"fused3b {name}: a pad slot is not exactly 0")
    abs_b, rel_b = _rel_err(out, ref)
    abs_d, rel_d = _rel_err(fused3b.plain_vol_to_cells(dvol).reshape(1, -1),
                            fused3b.plain_vol_to_cells(dref).reshape(1, -1))
    print(f"compare fused3b {name} ({n}x{c}x{'x'.join(map(str, spatial))}, "
          f"Q={q}, QP={qp}): blend max abs err {abs_b:.3e}, rel "
          f"{rel_b:.3e}, its {int(pads.sum())} pad slots ({int(empty.sum())} "
          f"in blocks with hasv == 0) exactly 0; bwd max abs err "
          f"{abs_d:.3e}, rel {rel_d:.3e} (tolerance rel {REL_TOL:g})",
          flush=True)
    if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
        raise RuntimeError(f"fused3b {name}: kernel disagrees with the plain "
                           "version")
    return abs_b, abs_d


def _trainer_points(q, dim, seed=0):
    """The fixed points train() draws for ``seed``, on the card."""
    with PointGenerator(q, dim, seed=seed) as gen:
        return torch.from_numpy(gen.batch(0)).cuda()


# the cells and channels of the scatter cases of fused3b_bwd and
# fused3s_bwd (csrc/texel_scatter.cuh)
SCATTER_CELLS, SCATTER_CHANNELS = (1, 3, 6, 50), (1, 3, 8, 16)


def fused3b_kernel_phase():
    """fused3b at config 5 (the vol-resident trainer's 1 000 000 points and
    so its plan) and in variants, the blend's gather and the bwd's scatter
    at N in {1, 3, 6, 50} x C in {1, 3, 8, 16}, every pad slot exactly 0;
    the layout round trip; the slot rows against fused3w's at the same
    points.  Returns each kernel's worst max abs error."""
    main = SamplerConfig(dim=3)
    pts5 = _trainer_points(Q5, 3)
    worst = [0.0, 0.0]

    def track(errs):
        worst[:] = [max(w, e) for w, e in zip(worst, errs)]

    track(compare_3b("config-5", main, N5, C, (S5,) * 3, Q5, pts=pts5))
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
        track(compare_3b(name, SamplerConfig(dim=3, **kw), *small, seed=1,
                         **extra))
    for c in (1, 3, 8):
        track(compare_3b(f"channels-{c}", main, 6, c, (9, 9, 9), 4099,
                         seed=2))
    track(compare_3b("non-cubic-20x28x36", main, 6, 4, (20, 28, 36), 8192,
                     seed=3))
    # 9^3: 11 z slabs x 6 y groups = 66 bins; the route takes Q >= 132
    track(compare_3b("q-133", main, 6, 3, (9, 9, 9), 133, seed=4))
    # the gather's and the scatter's lanes (ops/cuda/gather.py,
    # scatter.py): one cell (32 queries a warp), 3 and 6 cells (not
    # divisors of 32), 50 (more cells than lanes), each at C in {1, 3, 8,
    # 16}
    for n, c in itertools.product(SCATTER_CELLS, SCATTER_CHANNELS):
        track(compare_3b(f"lanes N={n} C={c}", main, n, c, (9, 9, 9), 4099,
                         seed=6))

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
    return {"fused3b_blend": worst[0], "fused3b_bwd": worst[1]}


def layout_phase():
    """The layout move (fused3b.cells_to_vol / vol_to_cells: the tiled
    transpose of csrc/fused3s.cu) against torch's permuted copies
    (plain_cells_to_vol / plain_vol_to_cells) on the card, bit for bit,
    and the round trip, at config 5's 16 x 4 x 128^3 and 16 x 16 x 128^3
    (2.1 GB) and at 6 x 3 x 9 x 10 x 11 in f32 and f64, and on 2D stacks
    (96 x 16 x 16^2, 6 x 3 x 10 x 11 in f64); the autograd
    Function's backward (the move the other way, exactly); the planned
    op's two moves a call, counted; each direction's time at config 5
    against torch's copy and the bound (the tensor read once and written
    once)."""
    for shape, dtype in (((N5, C, S5, S5, S5), torch.float32),
                         ((N5, C_WIDE, S5, S5, S5), torch.float32),
                         ((6, 3, 9, 10, 11), torch.float32),
                         ((6, 3, 9, 10, 11), torch.float64),
                         ((N, C_WIDE, H, W), torch.float32),
                         ((6, 3, 10, 11), torch.float64)):
        x = torch.rand(shape, generator=_cuda_gen(50), device="cuda",
                       dtype=dtype)
        vol = fused3b.cells_to_vol(x)
        if not (torch.equal(vol, fused3b.plain_cells_to_vol(x))
                and torch.equal(fused3b.vol_to_cells(vol), x)):
            raise RuntimeError(f"layout move {shape} {dtype}: differs from "
                               "torch's permuted copy")
        line = (f"layout move {'x'.join(map(str, shape))} {dtype}: "
                f"cells_to_vol == torch's copy, vol_to_cells(cells_to_vol("
                f"x)) == x, bit for bit")
        if shape[-1] == S5 and len(shape) == 5:
            bound_ms, _ = _bound(2 * x.numel() * x.element_size(), 0)
            to_ms, to_plain = _in_turns(
                lambda: fused3b.cells_to_vol(x),
                lambda: fused3b.plain_cells_to_vol(x), reps=5)
            from_ms, from_plain = _in_turns(
                lambda: fused3b.vol_to_cells(vol),
                lambda: fused3b.plain_vol_to_cells(vol), reps=5)
            line += (f"; cells_to_vol {to_ms:.4f} ms (torch's copy "
                     f"{to_plain:.4f}), vol_to_cells {from_ms:.4f} ms "
                     f"({from_plain:.4f}), bound {bound_ms:.4f} ms (bytes)")
        print(line, flush=True)
        del x, vol
        torch.cuda.empty_cache()
    x = torch.rand((3, 2, 4, 5, 6), generator=_cuda_gen(51), device="cuda",
                   dtype=torch.float64, requires_grad=True)
    w = torch.rand((4, 5, 6, 3, 2), generator=_cuda_gen(52), device="cuda",
                   dtype=torch.float64)
    (fused3b.cells_to_vol(x) * w).sum().backward()
    if not torch.equal(x.grad, fused3b.plain_vol_to_cells(w)):
        raise RuntimeError("cells_to_vol's backward is not vol_to_cells")
    # the planned op: the cells to the kernel layout in its forward, the
    # volume cotangent back in its backward, each one transpose launch
    cfg = SamplerConfig(dim=3)
    pts = _trainer_points(Q5, 3)
    cells = torch.rand((N5, C, *(S5,) * 3), generator=_cuda_gen(53),
                       device="cuda", requires_grad=True)
    plan = tfused.make_sample_plan(pts, cells.shape, cfg)
    _reset_counts()
    fused3b.transpose_layout.launches = 0
    out_p, _, _ = tfused.sample_features_padded(cells, pts, cfg, plan)
    out_p.square().sum().backward()
    launched = (fused3b.transpose_layout.launches,
                fused3b.fused3b_blend_vol.launches,
                fused3b.fused3b_bwd_vol.launches)
    print(f"layout move: the planned op at config 5 launched {launched[0]} "
          f"transposes, {launched[1]} fused3b_blend and {launched[2]} "
          f"fused3b_bwd (want 2, 1, 1); cells_to_vol's backward == "
          f"vol_to_cells, exactly", flush=True)
    if launched != (2, 1, 1):
        raise RuntimeError("the planned op did not move the layout through "
                           "the transpose kernel")
    _reset_counts()


# --- percell / slab -----------------------------------------------------------

def _nested_vol_inputs(seed):
    """Config 5's volume (16 x 4 x 128^3, 537 MB), the nested trainer's
    first batch of 100 000 points as its shared grid, and a cotangent."""
    gen = _cuda_gen(seed)
    x = torch.rand((N5, C, *(S5,) * 3), generator=gen, device="cuda")
    grid = _trainer_points(QN, 3).reshape(1, 1, 1, QN, 3)
    gout = torch.randn((N5, C, 1, 1, QN), generator=gen, device="cuda")
    return x, grid, gout


def _per_cell_inputs(dim, n, spatial, grid_out, seed, lo=-0.95, hi=0.95):
    """Cells, per-cell grids (N, *grid_out, dim) in [lo, hi] (the range of
    scripts/smoke_slab.py) and a cotangent, made on the card."""
    gen = _cuda_gen(seed)
    x = torch.rand((n, C, *spatial), generator=gen, device="cuda")
    grid = (torch.rand((n, *grid_out, dim), generator=gen, device="cuda")
            * (hi - lo) + lo)
    gout = torch.randn((n, C, *grid_out), generator=gen, device="cuda")
    return x, grid, gout


def _route_ops(name, x, grid, cfg, orders, plan=None):
    """(kernel blend, kernel splat, plain blend, plain splat) of route
    ``name`` ("percell", "slab") as zero-argument-but-gout callables."""
    spatial = tuple(x.shape[2:])
    if name == "percell":
        return (lambda: percell.blend(x, grid, cfg, orders, plan),
                lambda g: percell.splat(g, grid, spatial, cfg, orders, plan),
                lambda: percell.plain_blend_percell(x, grid, cfg, orders,
                                                    plan),
                lambda g: percell.plain_splat_percell(g, grid, spatial, cfg,
                                                      orders, plan))
    dzb, ccb = slab.geometry(x.shape[1], spatial, 1)
    dzs, ccs = slab.geometry(x.shape[1], spatial, 0)
    return (lambda: slab.blend(x, grid, cfg, orders),
            lambda g: slab.splat(g, grid, spatial, cfg, orders),
            lambda: slab.plain_blend_slab(x, grid, cfg, orders, dzb, ccb),
            lambda g: slab.plain_splat_slab(g, grid, spatial, cfg, orders,
                                            dzs, ccs))


def compare_route(what, name, cfg, x, grid, gout, orders_list):
    """Route ``name``'s blend and splat against their plain versions on
    the card at each order (one launch is one row, within REL_TOL), and
    the blend equal bit for bit to blend_o's (the same corner walk and
    FMA order).  Returns the largest abs errors."""
    plan = (percell.make_plan(grid, tuple(x.shape), cfg)
            if name == "percell" else None)
    worst = [0.0, 0.0]
    for orders in orders_list:
        blend_k, splat_k, blend_p, splat_p = _route_ops(name, x, grid, cfg,
                                                        orders, plan)
        out, ref = blend_k(), blend_p()
        dx = splat_k(gout)
        dref = splat_p(gout)
        other = blend_splat.blend(x, grid, cfg, orders)
        torch.cuda.synchronize()
        if out.shape != ref.shape or dx.shape != dref.shape:
            raise RuntimeError(f"{name} {what} {orders}: shape mismatch")
        if not (torch.isfinite(out).all() and torch.isfinite(dx).all()):
            raise RuntimeError(f"{name} {what} {orders}: non-finite output")
        abs_b, rel_b = _rel_err(out.reshape(1, -1), ref.reshape(1, -1))
        abs_s, rel_s = _rel_err(dx.reshape(1, -1), dref.reshape(1, -1))
        same = torch.equal(out, other)
        print(f"compare {name} {what} ({'x'.join(map(str, x.shape))}, grid "
              f"{tuple(grid.shape)}) orders {orders}: blend abs {abs_b:.3e} "
              f"rel {rel_b:.3e}; splat abs {abs_s:.3e} rel {rel_s:.3e}; "
              f"blend == blend_o bit for bit: {same}", flush=True)
        if not (rel_b <= REL_TOL and rel_s <= REL_TOL):
            raise RuntimeError(f"{name} {what} {orders}: kernel disagrees "
                               "with the plain version")
        if not same:
            raise RuntimeError(f"{name} {what} {orders}: blend differs from "
                               "blend_o's")
        worst = [max(worst[0], abs_b), max(worst[1], abs_s)]
        del out, ref, dx, dref, other
    return worst


def compare_bins(what, cfg, cells_shape, grid, align=None):
    """slab_bins against plain_bins on the card: the same first slot of
    every (cell, row) and, slot by slot, a pair of the same key (the
    kernel orders a bin by its atomics, the plain version by query); perm
    a permutation."""
    align = cfg.align_corners if align is None else align
    got = slab.make_bins(grid, cells_shape, cfg, align)
    want = slab.plain_bins(grid, cells_shape, cfg, align)
    key = torch.empty_like(want.perm, dtype=torch.int64)
    key[want.perm.long()] = torch.repeat_interleave(
        torch.arange(want.starts.numel() - 1, device=grid.device),
        (want.starts[1:] - want.starts[:-1]).long())
    slots = torch.arange(got.perm.numel(), device=grid.device)
    ok = (torch.equal(got.starts, want.starts)
          and torch.equal(key[got.perm.long()], key[want.perm.long()])
          and torch.equal(torch.sort(got.perm).values.long(), slots))
    empty = int((want.starts[1:] == want.starts[:-1]).sum())
    print(f"compare slab_bins {what} ({'x'.join(map(str, cells_shape))}, "
          f"grid {tuple(grid.shape)}): {got.perm.numel()} pairs, {empty} of "
          f"{want.starts.numel() - 1} (cell, row) bins empty; equal to the "
          f"plain bins: {ok}", flush=True)
    if not ok:
        raise RuntimeError(f"slab_bins {what}: differs from plain_bins")


def _band_points(q, s, rows, seed, y_rows=None):
    """(1, 1, 1, q, 3) shared points over an s^3 cell (multicell,
    align_corners) whose z source coordinates lie in [rows[0] + 0.05,
    rows[1] - 1) before the cell shift (< 1): every pair's floor row in
    [rows[0], rows[1]), x and y over the whole cell (y, where ``y_rows``
    is given, in those rows likewise)."""
    gen = _cuda_gen(seed)
    pts = torch.rand((q, 3), generator=gen, device="cuda") * 2.0 - 1.0
    scale = 0.5 * (s - 2)
    for axis, band in ((2, rows), (1, y_rows)):
        if band is None:
            continue
        lo, hi = band[0] + 0.05, band[1] - 1.0
        pts[:, axis] = (torch.rand((q,), generator=gen, device="cuda")
                        * (hi - lo) + lo) / scale - 1.0
    return pts.reshape(1, 1, 1, q, 3)


def compare_plan(what, cfg, cells_shape, grid):
    """percell_plan against plain_plan on the card: the same first slot of
    every (cell, tile) and, slot by slot, a pair of the same key (the
    kernel orders a bin by its atomics, the plain version by query); perm
    a permutation."""
    got = percell.make_plan(grid, cells_shape, cfg)
    want = percell.plain_plan(grid, cells_shape, cfg)
    key = torch.empty_like(want.perm, dtype=torch.int64)
    key[want.perm.long()] = torch.repeat_interleave(
        torch.arange(want.starts.numel() - 1, device=grid.device),
        (want.starts[1:] - want.starts[:-1]).long())
    slots = torch.arange(got.perm.numel(), device=grid.device)
    ok = ((got.dz, got.ty) == (want.dz, want.ty)
          and torch.equal(got.starts, want.starts)
          and torch.equal(key[got.perm.long()], key[want.perm.long()])
          and torch.equal(torch.sort(got.perm).values.long(), slots))
    sizes = want.starts[1:] - want.starts[:-1]
    print(f"compare percell_plan {what} ({'x'.join(map(str, cells_shape))}, "
          f"grid {tuple(grid.shape)}): {got.perm.numel()} pairs in tiles of "
          f"({got.dz}, {got.ty}) rows, {int((sizes == 0).sum())} of "
          f"{sizes.numel()} (cell, tile) bins empty, the fullest "
          f"{int(sizes.max())}; equal to the plain plan: {ok}", flush=True)
    if not ok:
        raise RuntimeError(f"percell_plan {what}: differs from plain_plan")


def pc_slab_kernel_phase():
    """percell and slab against their plain versions at the slice's shapes
    (the nested trainer's volume and points, a skewed and a sparse cloud
    there, the per-cell surface, its sparse case, the 2D volume) and in
    variants, rows whose bytes are not a multiple of 16 among them; the
    slab bins against their plain version."""
    errs = {}
    cfg3 = SamplerConfig(dim=3)
    x, grid, gout = _nested_vol_inputs(20)
    compare_bins("nested-volume", cfg3, tuple(x.shape), grid)
    compare_plan("nested-volume", cfg3, tuple(x.shape), grid)
    e = compare_route("nested-volume", "percell", cfg3, x, grid, gout,
                      [(0, 0, 0), (0, 0, 1), (2, 0, 0), (1, 1, 1), (3, 0, 0)])
    errs["percell_blend"], errs["percell_splat"] = e
    e = compare_route("nested-volume", "slab", cfg3, x, grid, gout,
                      [(0, 0, 0), (0, 2, 0)])
    errs["slab_blend"], errs["slab_splat"] = e
    # skewed: every pair's floor row in 40..41, one blend slab (dz = 2) of
    # 64; sparse: 20 points a cell, most of the 64 x 16 blend bins empty
    for what, pts in (("skewed", _band_points(QN, S5, (40, 42), 40)),
                      ("sparse-volume", _band_points(20, S5, (0, S5 - 1),
                                                     41))):
        g = torch.randn((N5, C, 1, 1, pts.shape[3]), generator=_cuda_gen(42),
                        device="cuda")
        compare_bins(what, cfg3, tuple(x.shape), pts)
        e = compare_route(what, "slab", cfg3, x, pts, g,
                          [(0, 0, 0), (1, 0, 2)])
        errs["slab_blend"] = max(errs["slab_blend"], e[0])
        errs["slab_splat"] = max(errs["slab_splat"], e[1])
    # skewed for percell: every pair in z rows 40..41 and y rows 15..16,
    # one (z tile, y band) a cell
    pts = _band_points(QN, S5, (40, 42), 45, y_rows=(15, 17))
    compare_plan("skewed-band", cfg3, tuple(x.shape), pts)
    e = compare_route("skewed-band", "percell", cfg3, x, pts, gout,
                      [(0, 0, 0), (0, 1, 2)])
    errs["percell_blend"] = max(errs["percell_blend"], e[0])
    errs["percell_splat"] = max(errs["percell_splat"], e[1])
    del x, grid, gout, g, pts
    torch.cuda.empty_cache()
    # the routed cells whose rows slab cannot stage: 8 x 4 x 32 x 256^2 at
    # 2^20 pairs, per-cell and shared grids
    for what, gb in (("wide-rows per-cell", NW), ("wide-rows shared", 1)):
        x, grid, gout = _per_cell_inputs(3, NW, SW, (1, 1, QW // NW), 46,
                                         -1.0, 1.0)
        grid = grid[:gb].contiguous()
        compare_plan(what, cfg3, tuple(x.shape), grid)
        e = compare_route(what, "percell", cfg3, x, grid, gout,
                          [(0, 0, 0), (1, 0, 2)])
        errs["percell_blend"] = max(errs["percell_blend"], e[0])
        errs["percell_splat"] = max(errs["percell_splat"], e[1])
        del x, grid, gout
        torch.cuda.empty_cache()
    for what, g in (("per-cell", GP), ("sparse", GP_SPARSE)):
        x, grid, gout = _per_cell_inputs(3, NP, (SP,) * 3, (g,) * 3, 21)
        for name in ("percell", "slab"):
            compare_route(what, name, cfg3, x, grid, gout,
                          [(0, 0, 0), (1, 0, 0), (0, 0, 2)])
    x, grid, gout = _per_cell_inputs(2, NP, (S2D,) * 2, (G2D,) * 2, 22)
    compare_route("2d", "slab", SamplerConfig(dim=2), x, grid, gout,
                  [(0, 0), (1, 0), (0, 2)])
    x, grid, gout = _per_cell_inputs(3, NS, (SS,) * 3, (1, 1, GS), 29)
    compare_route("small-cells", "slab", cfg3, x, grid, gout,
                  [(0, 0, 0), (1, 0, 0), (0, 2, 1)])
    del x, grid, gout
    torch.cuda.empty_cache()

    # variants: volumes of several slabs (a 3 x 40 x 48 x 56 cell takes
    # 7-row slabs, a 3 x 300 x 200 one 95-row slabs), points to +-1.4
    wide = dict(lo=-1.4, hi=1.4)
    small3 = (3, (40, 48, 56), (1, 1, 4099))
    small2 = (3, (300, 200), (1, 4099))
    for tag, kw in [
            ("border", dict(padding_mode="border")),
            ("reflection", dict(padding_mode="reflection")),
            ("linear", dict(kernel="linear")),
            ("smoothstep", dict(kernel="smoothstep")),
            ("no-multicell", dict(multicell=False)),
            ("align-false", dict(align_corners=False)),
            ("reflection-strict-align-false",
             dict(padding_mode="reflection", strict_reference=True,
                  align_corners=False))]:
        x, grid, gout = _per_cell_inputs(3, small3[0], small3[1], small3[2],
                                         23, **wide)
        for name in ("percell", "slab"):
            compare_route(tag, name, SamplerConfig(dim=3, **kw), x, grid,
                          gout, [(0, 0, 0), (1, 0, 2)])
        x, grid, gout = _per_cell_inputs(2, small2[0], small2[1], small2[2],
                                         24, **wide)
        compare_route(tag + "-2d", "slab", SamplerConfig(dim=2, **kw), x,
                      grid, gout, [(0, 0), (2, 1)])
    # shared grids, orders to 3
    x, grid, gout = _per_cell_inputs(3, small3[0], small3[1], small3[2], 25,
                                     **wide)
    shared = grid[:1].contiguous()
    for name in ("percell", "slab"):
        compare_route("shared-grid", name, cfg3, x, shared, gout,
                      [(3, 0, 0), (0, 2, 1), (1, 1, 1)])
    x, grid, gout = _per_cell_inputs(2, small2[0], small2[1], small2[2], 26,
                                     **wide)
    compare_route("shared-grid-2d", "slab", SamplerConfig(dim=2), x,
                  grid[:1].contiguous(), gout, [(0, 3), (1, 2)])
    # rows of 13 x 15 and 201 floats: copied and stored by the threads,
    # not by bulk copies; strict 2D with align off bins the order-0 blend
    # with align on
    x, grid, gout = _per_cell_inputs(3, 3, (40, 13, 15), (1, 1, 4099), 43,
                                     **wide)
    for name in ("percell", "slab"):
        compare_route("odd-rows", name, cfg3, x, grid, gout,
                      [(0, 0, 0), (1, 2, 0)])
    # rows of 8192 floats: two rows of one channel of two planes exceed a
    # percell tile, so its blend gathers from the volume
    x, grid, gout = _per_cell_inputs(3, 2, (4, 4, 8192), (1, 1, 4099), 48,
                                     **wide)
    if percell.channels(C, (4, 4, 8192), *percell.geometry(
            C, (4, 4, 8192))) != 0:
        raise RuntimeError("percell: the wide-row variant is staged")
    compare_route("unstaged", "percell", cfg3, x, grid, gout,
                  [(0, 0, 0), (0, 1, 1)])
    x, grid, gout = _per_cell_inputs(2, 3, (300, 201), (1, 4099), 44, **wide)
    cfg2s = SamplerConfig(dim=2, strict_reference=True, align_corners=False)
    compare_bins("odd-rows-2d strict, blend", cfg2s, tuple(x.shape), grid,
                 True)
    compare_route("odd-rows-2d-strict-align-false", "slab", cfg2s, x, grid,
                  gout, [(0, 0), (1, 1)])
    return errs


def _kernel_bytes(x, grid, out_elems, plan_bytes, touched=None):
    """Bytes a blend-family kernel must move: the cell values it reads
    (``touched`` of them; all if None), the grid and plan once, and its
    output once."""
    cells = x.numel() if touched is None else touched
    return 4 * (cells + grid.numel() + out_elems) + plan_bytes


def _touched_values(x, grid, cfg):
    """The distinct cell values an order-0 blend of ``grid`` reads: the
    in-bounds corners of every pair, times the channels (a data-dependent
    count, from the plain corner math)."""
    n, c, *spatial = x.shape
    d = cfg.dim
    q = math.prod(grid.shape[1:-1])
    tables = generic.per_axis_tables(grid.reshape(grid.shape[0], q, d),
                                     spatial, cfg, (0,) * d, n)
    total = math.prod(spatial)
    keys = []
    for corner in itertools.product((0, 1), repeat=d):
        idx, _, ok = generic.corner_index_weight(tables, corner, spatial, d)
        cell = torch.arange(n, device=x.device)[:, None].expand(n, q)
        keys.append((cell * total + idx.expand(n, q))[ok.expand(n, q)])
    return int(torch.unique(torch.cat(keys)).numel()) * c


def _time_plan(what, build_fn, pairs, where="the nested volume"):
    """A plan's (or bins') first build on the host clock, then its ms by
    CUDA events over 3 builds, printed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    ms = _time_ms(build_fn, 3)
    print(f"{what} at {where} ({pairs} pairs): first build "
          f"{first_ms:.2f} ms (host clock), then {ms:.3f} ms (CUDA events, "
          f"3 builds)", flush=True)
    return ms


def _library_ops(x, grid, gout):
    """grid_sample and its cells backward at their one setting (linear,
    order 0, zeros, no multicell, align_corners) on per-cell grids."""
    full = grid.expand(x.shape[0], *grid.shape[1:])
    return {
        "blend": lambda: F.grid_sample(x, full, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=True),
        "splat": lambda: torch.ops.aten.grid_sampler_3d_backward(
            gout, x, full, 0, 0, True, [True, False])[0],
    }


def _against_library(what, kernels, library):
    """Each kernel against the library call of its kind, in turns, after
    checking that the two compute one function: {name: (ms, lib ms)}."""
    out = {}
    for name, kernel in kernels.items():
        lib = library["blend" if "blend" in name else "splat"]
        _, err = _rel_err(kernel().reshape(1, -1), lib().reshape(1, -1))
        if not err <= REL_TOL:
            raise RuntimeError(f"{name}: the library call computes another "
                               f"function ({err:.3e})")
        ms, lib_ms = _in_turns(kernel, lib, reps=5)
        out[name] = (ms, lib_ms)
        print(f"time {name} at linear, order 0, no multicell ({what}): "
              f"kernel {ms:.4f} ms, library "
              f"{'grid_sample' if 'blend' in name else 'grid_sampler_3d_backward'}"
              f" {lib_ms:.4f} ms (rel diff {err:.2e})", flush=True)
    return out


def pc_slab_time_phase():
    """At the nested trainer's volume and points: each route's kernels
    against blend_o / splat_o on the same inputs and against their plain
    versions (in turns), the percell plan's and the slab bins' builds
    (the kernels take them built), and the 3D grid_sample and its
    backward at their one setting (linear, order 0, zeros, no multicell,
    align_corners) beside the kernels at that setting, there and on the
    routed stack of 1024 x 4 x 16^3 cells at 2^18 and 2^20 pairs and (the
    percell pair) on 8 x 4 x 32 x 256^2 cells at 2^20 pairs with its plan's
    build.  Then the route rule's measurement:
    one blend and one splat on each route, with and without its plan's
    build, across cell sizes and pair counts."""
    cfg = SamplerConfig(dim=3)
    o = (0, 0, 0)
    x, grid, gout = _nested_vol_inputs(27)
    spatial = (S5,) * 3
    shape = tuple(x.shape)
    pairs = N5 * QN
    plan = percell.make_plan(grid, shape, cfg)
    bins = slab.make_bins(grid, shape, cfg, cfg.align_corners)
    plan_ms = _time_plan("pair plan", lambda: percell.make_plan(
        grid, shape, cfg), pairs)
    bins_ms = _time_plan("slab bins", lambda: slab.make_bins(
        grid, shape, cfg, cfg.align_corners), pairs)
    bins_device_ms = _device_ms(lambda: slab.make_bins(
        grid, shape, cfg, cfg.align_corners), reps=10)
    print(f"slab bins at the nested volume: {bins_device_ms:.4f} ms of "
          f"device time a build (torch.profiler, its memset and three "
          f"kernels)", flush=True)
    touched = _touched_values(x, grid, cfg)
    flops = 2 * 8 * C * pairs
    out_elems = N5 * C * QN
    bounds = {
        "percell_blend": _bound(_kernel_bytes(x, grid, out_elems, 4 * pairs,
                                              touched), flops),
        "percell_splat": _bound(_kernel_bytes(gout, grid, x.numel(),
                                              4 * pairs), flops),
        # the bins are the slab route's own design, not the function's
        # bytes: their build is timed apart (plan_ms)
        "slab_blend": _bound(_kernel_bytes(x, grid, out_elems, 0, touched),
                             flops),
        "slab_splat": _bound(_kernel_bytes(gout, grid, x.numel(), 0), flops),
    }
    print(f"bounds at the nested volume: the blend reads {touched} distinct "
          f"cell values of {x.numel()}; percell's pair plan is read once",
          flush=True)
    dzb, ccb = slab.geometry(C, spatial, 1)
    dzs, ccs = slab.geometry(C, spatial, 0)
    ops = {
        "percell_blend": (
            lambda: percell.blend(x, grid, cfg, o, plan),
            lambda: percell.plain_blend_percell(x, grid, cfg, o, plan),
            lambda: blend_splat.blend(x, grid, cfg, o)),
        "percell_splat": (
            lambda: percell.splat(gout, grid, spatial, cfg, o, plan),
            lambda: percell.plain_splat_percell(gout, grid, spatial, cfg, o,
                                                plan),
            lambda: blend_splat.splat(gout, grid, spatial, cfg, o)),
        "slab_blend": (
            lambda: slab.blend(x, grid, cfg, o, bins),
            lambda: slab.plain_blend_slab(x, grid, cfg, o, dzb, ccb, bins),
            lambda: blend_splat.blend(x, grid, cfg, o)),
        "slab_splat": (
            lambda: slab.splat(gout, grid, spatial, cfg, o, bins),
            lambda: slab.plain_splat_slab(gout, grid, spatial, cfg, o, dzs,
                                          ccs, bins),
            lambda: blend_splat.splat(gout, grid, spatial, cfg, o)),
    }
    times = {}
    for name, (kernel, plain, other) in ops.items():
        ms, plain_ms = _in_turns(kernel, plain, reps=1)
        ms, other_ms = _in_turns(kernel, other, reps=5)
        bound_ms, bound_by = bounds[name]
        build_ms = plan_ms if name.startswith("percell") else bins_ms
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, v1_ms_same_work=other_ms,
                           plan_ms=build_ms)
        if name.startswith("slab"):
            times[name]["plan_device_ms"] = bins_device_ms
        print(f"time {name} at the nested volume ({N5}x{C}x{S5}^3, shared "
              f"Q={QN}, order 0): kernel {ms:.4f} ms ({ms + build_ms:.4f} "
              f"with its {'plan' if 'percell' in name else 'bins'}), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of it; "
              f"{'blend_o' if 'blend' in name else 'splat_o'} on the same "
              f"inputs {other_ms:.4f} ms", flush=True)

    lib_cfg = SamplerConfig(dim=3, kernel="linear", multicell=False)
    plan_l = percell.make_plan(grid, shape, lib_cfg)
    bins_l = slab.make_bins(grid, shape, lib_cfg, True)
    lib = _against_library("nested volume", {
        "percell_blend": lambda: percell.blend(x, grid, lib_cfg, o, plan_l),
        "percell_splat": lambda: percell.splat(gout, grid, spatial, lib_cfg,
                                               o, plan_l),
        "slab_blend": lambda: slab.blend(x, grid, lib_cfg, o, bins_l),
        "slab_splat": lambda: slab.splat(gout, grid, spatial, lib_cfg, o,
                                         bins_l)}, _library_ops(x, grid, gout))
    for name, (ms, lib_ms) in lib.items():
        times[name].update(library_ms=lib_ms, ms_at_library_setting=ms)
    del x, grid, gout, plan, plan_l, bins, bins_l
    torch.cuda.empty_cache()
    # the routed stack of small cells: one slab a cell, no bins
    for q in (GS // 4, GS):
        x, grid, gout = _per_cell_inputs(3, NS, (SS,) * 3, (1, 1, q), 28)
        lib = _against_library(f"{NS}x{C}x{SS}^3, per-cell Q={q}", {
            "slab_blend": lambda: slab.blend(x, grid, lib_cfg, o),
            "slab_splat": lambda: slab.splat(gout, grid, (SS,) * 3, lib_cfg,
                                             o)}, _library_ops(x, grid, gout))
        for name, (ms, lib_ms) in lib.items():
            times[name].update({f"ms_small_cells_{NS * q}_pairs": ms,
                                f"library_ms_small_cells_{NS * q}_pairs":
                                    lib_ms})
        del x, grid, gout
        torch.cuda.empty_cache()
    # percell's routed cells (rows slab cannot stage), per-cell points
    x, grid, gout = _per_cell_inputs(3, NW, SW, (1, 1, QW // NW), 49, -1.0,
                                     1.0)
    shape = tuple(x.shape)
    plan_ms = _time_plan("pair plan", lambda: percell.make_plan(
        grid, shape, cfg), QW, f"{NW}x{C}x{'x'.join(map(str, SW))}")
    plan_l = percell.make_plan(grid, shape, lib_cfg)
    lib = _against_library(f"{NW}x{C}x{'x'.join(map(str, SW))}, per-cell "
                           f"Q={QW // NW}", {
        "percell_blend": lambda: percell.blend(x, grid, lib_cfg, o, plan_l),
        "percell_splat": lambda: percell.splat(gout, grid, SW, lib_cfg, o,
                                               plan_l)},
        _library_ops(x, grid, gout))
    for name, (ms, lib_ms) in lib.items():
        times[name].update(ms_wide_rows=ms, library_ms_wide_rows=lib_ms,
                           plan_ms_wide_rows=plan_ms)
    del x, grid, gout, plan_l
    torch.cuda.empty_cache()
    percell_tile_sweep()
    route_sweep_phase()
    return times


# the shared memory a percell tile may take in percell_tile_sweep: two,
# three and four blocks an SM, and one
TILE_SWEEP_BYTES = (113 * 1024, 75 * 1024, 55 * 1024, 227 * 1024)


def percell_tile_sweep():
    """The measurement behind percell.geometry: percell_blend (order 0)
    at the nested volume and on 8 x 4 x 32 x 256^2 cells (2^20 per-cell
    pairs) with the tiles of each budget in TILE_SWEEP_BYTES, and tiles of
    one z row (bins by (cell, z row, y band)) at each, blend and plan
    timed in turns, each blend equal to blend_o's bit for bit."""
    cfg = SamplerConfig(dim=3)
    o = (0, 0, 0)
    budget = percell.TILE_BYTES
    cases = (("nested volume", _nested_vol_inputs(50)[:2]),
             ("8x4x32x256^2", _per_cell_inputs(3, NW, SW, (1, 1, QW // NW),
                                               51, -1.0, 1.0)[:2]))
    try:
        for what, (x, grid) in cases:
            spatial = tuple(x.shape[2:])
            shape = tuple(x.shape)
            want = blend_splat.blend(x, grid, cfg, o)
            runs = {}
            for tile_bytes in TILE_SWEEP_BYTES:
                percell.TILE_BYTES = tile_bytes
                dz, ty = percell.geometry(C, spatial)
                one_row = (tile_bytes - percell.BARRIER_BYTES) // (
                    4 * C * 2 * spatial[2]) - 1
                for tile in ((dz, ty), (1, min(one_row, spatial[1]))):
                    plan = percell.make_plan(grid, shape, cfg, tile)
                    if not torch.equal(percell.blend(x, grid, cfg, o, plan),
                                       want):
                        raise RuntimeError(f"percell_blend {what} tile "
                                           f"{tile}: differs from blend_o's")
                    runs[f"{tile_bytes // 1024} KB tile {tile}"] = (
                        functools.partial(percell.blend, x, grid, cfg, o,
                                          plan),
                        functools.partial(percell.make_plan, grid, shape,
                                          cfg, tile))
            ms = {k: [] for k in runs}
            for k in list(runs) + list(runs)[::-1]:
                ms[k].append((_time_ms(runs[k][0], 5),
                              _time_ms(runs[k][1], 5)))
            print(f"percell tile sweep {what} ({'x'.join(map(str, shape))}, "
                  f"grid {tuple(grid.shape)}), blend / plan ms: " + "; ".join(
                      f"{k} {sum(b for b, _ in v) / 2:.4f} / "
                      f"{sum(p for _, p in v) / 2:.4f}"
                      for k, v in ms.items()), flush=True)
            del x, grid, want, runs
            torch.cuda.empty_cache()
    finally:
        percell.TILE_BYTES = budget


def _route_ms(x, grid, gout, cfg):
    """ms of one blend and one splat (order 0) on each route, in turns:
    blend_o / splat_o; percell and slab with their plan or bins built in
    the call ("percell+plan", "slab+plan": a chain of one call) and
    reused (a longer chain: the nested trainer's or a backward pass).
    Also each op alone on blend_o and on percell with its plan reused."""
    spatial = tuple(x.shape[2:])
    shape = tuple(x.shape)
    o = (0,) * cfg.dim

    def slab_bins():
        # one set for both, as route.GridPlans gives them
        needed = slab.needs_bins(shape, True) or slab.needs_bins(shape, False)
        return (slab.make_bins(grid, shape, cfg, cfg.align_corners)
                if needed else None)

    def slab_pair(bins):
        return (slab.blend(x, grid, cfg, o, bins),
                slab.splat(gout, grid, spatial, cfg, o, bins))

    runs = {
        "blend_o": lambda: (blend_splat.blend(x, grid, cfg, o),
                            blend_splat.splat(gout, grid, spatial, cfg, o)),
        "blend_o blend": lambda: blend_splat.blend(x, grid, cfg, o),
        "blend_o splat": lambda: blend_splat.splat(gout, grid, spatial, cfg,
                                                   o),
    }
    if slab.supports(cfg, shape):
        bins = slab_bins()
        runs.update({"slab+plan": lambda: slab_pair(slab_bins()),
                     "slab": lambda: slab_pair(bins)})
    if percell.supports(cfg, tuple(x.shape)):
        plan = percell.make_plan(grid, tuple(x.shape), cfg)

        def with_plan():
            p = percell.make_plan(grid, tuple(x.shape), cfg)
            percell.blend(x, grid, cfg, o, p)
            percell.splat(gout, grid, spatial, cfg, o, p)

        runs.update({
            "percell+plan": with_plan,
            "percell": lambda: (percell.blend(x, grid, cfg, o, plan),
                                percell.splat(gout, grid, spatial, cfg, o,
                                              plan)),
            "percell blend": lambda: percell.blend(x, grid, cfg, o, plan),
            "percell splat": lambda: percell.splat(gout, grid, spatial, cfg,
                                                   o, plan)})
    ms = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        ms[k].append(_time_ms(runs[k], 3))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def route_sweep_phase():
    """The measurement behind route.rule: one blend + one splat on each
    route, in turns (_route_ms), across cells below and above a block's
    shared memory and pair counts from the sparse per-cell case to the
    nested trainer's, and what route.rule picks."""
    cases = []
    for n, s, q in ((16, 16, 100_000), (16, 32, 100_000), (4, 64, 4096),
                    (16, 64, 100_000), (4, 128, 8), (4, 128, 512),
                    (4, 128, 4096), (4, 128, 32_768), (16, 128, 1024),
                    (16, 128, 4096), (16, 128, 8192), (16, 128, 16_384),
                    (16, 128, 65_536), (16, 128, 100_000)):
        cases.append((3, n, (s,) * 3, (1, 1, q)))
    # stacks over L2 of cells under a block's shared memory (66 and 221
    # KB) and of 524 KB cells; cells whose 256 KB planes the slab kernels
    # do not take (two rows of one channel over a block's shared memory)
    cases += [(3, 1024, (16,) * 3, (1, 1, 256)),
              (3, 1024, (16,) * 3, (1, 1, 1024)),
              (3, 512, (24,) * 3, (1, 1, 2048)),
              (3, 128, (32,) * 3, (1, 1, 8192)),
              (3, 8, (32, 256, 256), (1, 1, 8192)),
              (3, 8, (32, 256, 256), (1, 1, 32_768)),
              (3, 8, (32, 256, 256), (1, 1, 131_072))]
    for n, s, q in ((4, 1024, 16), (4, 1024, 1024), (4, 1024, 16_384),
                    (4, 1024, 65_536), (4, 1024, 262_144)):
        cases.append((2, n, (s,) * 2, (1, q)))
    for dim, n, spatial, grid_out in cases:
        for shared in (False, True):
            cfg = SamplerConfig(dim=dim)
            x, grid, gout = _per_cell_inputs(dim, n, spatial, grid_out, 28)
            if shared:
                grid = grid[:1].contiguous()
            q = math.prod(grid_out)
            ms = _route_ms(x, grid, gout, cfg)
            picked = route.rule(cfg, tuple(x.shape), n * q)
            print(f"route sweep {dim}D {n}x{C}x{'x'.join(map(str, spatial))} "
                  f"({4 * x[0].numel() / 1e3:.0f} KB a cell), "
                  f"{'shared' if shared else 'per-cell'} Q={q} ({n * q} "
                  f"pairs): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; rule picks {picked}", flush=True)
            del x, grid, gout
            torch.cuda.empty_cache()


# --- fused v1 (C > 8) and fused2d (small clouds) ------------------------------

# path (a): the wide-feature fused trainers, C = 16 on the reference stacks
# and point counts; path (b): the small clouds of the JAX fused2d route
C_WIDE, STEPS_WIDE_3D, STEPS_WIDE_MEGA = 16, 5, 5
SMALL_CLOUDS = [(N, 200), (N, 1024), (N, 2047), (8, 512)]
# path (b)'s trainer: the 2D main stack with this many fresh points a step
Q_SMALL2, STEPS_SMALL2 = 1024, 3
# the variants of both new kernel pairs: (name, config flags, channels)
FUSED_VARIANTS = [
    ("zeros", {}, 12), ("border", dict(padding_mode="border"), 12),
    ("reflection", dict(padding_mode="reflection"), 9),
    ("linear", dict(kernel="linear"), 9),
    ("smoothstep", dict(kernel="smoothstep"), 12),
    ("no-multicell-align-false", dict(multicell=False, align_corners=False),
     12),
    ("strict-reflection-align", dict(padding_mode="reflection",
                                     strict_reference=True), 9)]


def compare_fused_v1(name, cfg, n, c, spatial, q, seed=0, lo=-1.2,
                     hi=1.2):
    """compare_fused of the v1 pair (the wrappers, the rule's layouts),
    then every layout of v1.blend_alternatives / v1.bwd_alternatives (the
    v1 layout sweep's) against the same plain versions, within REL_TOL."""
    errs = compare_fused("fused", name, cfg, n, c, spatial, q, seed, lo, hi)
    cells, pts, g = _fused_inputs(n, c, spatial, q, seed, lo, hi)
    ref = fused_v1.plain_fused_blend(cells, pts, cfg)
    dref = fused_v1.plain_fused_bwd(g, pts, spatial, cfg, n)
    worst = [0.0, 0.0]
    for geom in v1.blend_alternatives(len(spatial), n, c, q,
                                      spatial).values():
        out = fused_v1.launch_blend(cells, pts, cfg, geom)
        worst[0] = max(worst[0], _rel_err(out, ref)[1])
        if not worst[0] <= REL_TOL:
            raise RuntimeError(f"v1 {name}: blend layout {geom} disagrees "
                               "with the plain version")
    for geom in v1.bwd_alternatives(len(spatial), n, c).values():
        out = fused_v1.launch_bwd(g, pts, spatial, cfg, n, geom)
        worst[1] = max(worst[1], _rel_err(out.reshape(1, -1),
                                          dref.reshape(1, -1))[1])
        if not worst[1] <= REL_TOL:
            raise RuntimeError(f"v1 {name}: bwd layout {geom} disagrees "
                               "with the plain version")
    print(f"compare v1 {name}: every swept layout, blend rel {worst[0]:.3e},"
          f" bwd rel {worst[1]:.3e} (tolerance rel {REL_TOL:g})", flush=True)
    return errs


def fused_v1_kernel_phase():
    """B6 against its plain version at path (a)'s full-width 2D and 3D
    inputs, at C in {9, 12, 32, 64}, in each variant (points to +-1.4, Q
    off every block size) and on large cells, each in the rule's layout
    and in every layout the v1 sweep times (compare_fused_v1); and at
    config 5's C = 16 volume in query order (16 x 16 x 128^3, 1 000 000
    points, 2.1 GB of cells) in the rule's."""
    errs = compare_fused_v1("2D path (a)", SamplerConfig(dim=2), N, C_WIDE,
                            (H, W), Q, lo=-1.0, hi=1.0)
    errs3 = compare_fused_v1("3D path (a)", SamplerConfig(dim=3), N3,
                             C_WIDE, (S3,) * 3, Q, seed=1, lo=-1.0, hi=1.0)
    for c in (9, 12, 32, 64):
        compare_fused_v1(f"channels-{c}", SamplerConfig(dim=2), 8, c,
                         (12, 10), 4099, seed=2, **WIDE)
    for c in (9, 32):
        compare_fused_v1(f"3D channels-{c}", SamplerConfig(dim=3), 6, c,
                         (7, 8, 9), 4099, seed=3, **WIDE)
    for dim, spatial in ((2, (12, 10)), (3, (7, 8, 9))):
        for name, kw, c in FUSED_VARIANTS:
            compare_fused_v1(f"{dim}D {name}", SamplerConfig(dim=dim, **kw),
                             6, c, spatial, 2053, seed=4, **WIDE)
    # large cells: 2 x 16 x 32^3 and 2 x 16 x 128^2
    compare_fused_v1("3D large-cell", SamplerConfig(dim=3), 2, 16,
                     (32, 32, 32), 4096, seed=5, **WIDE)
    compare_fused_v1("2D large-cell", SamplerConfig(dim=2), 2, 16,
                     (128, 128), 4096, seed=5, **WIDE)
    err5 = compare_fused("fused", f"config-5 C={C_WIDE}",
                         SamplerConfig(dim=3), N5, C_WIDE, (S5,) * 3, Q5,
                         seed=6)
    torch.cuda.empty_cache()
    return {"fused_blend": max(errs[0], errs3[0], err5[0]),
            "fused_bwd": max(errs[1], errs3[1], err5[1])}


# (N, C, S, Q) at which fused2d's blend and bwd are held to their plain
# versions in every layout of fused2d.blend_alternatives /
# bwd_alternatives: path (b)'s clouds, the large cells the staged design
# refused (2 x 4 x 256^2) and N in {1, 3, 6, 96} at C in {1, 3, 4, 8, 12}
FUSED2D_LAYOUT_CASES = ([(n, C, (H, W), q) for n, q in SMALL_CLOUDS]
                        + [(3, C, (64, 64), 1500), (2, C, (256, 256), 4096)]
                        + [(n, c, (12, 10), 2053) for n in (1, 3, 6, N)
                           for c in (1, 3, C, 8, 12)])


def fused2d_kernel_phase():
    """B7 against its plain version at path (b)'s shapes, in the same
    variants (2D), at 100 000 points and on large cells, and in every
    layout its sweep times at FUSED2D_LAYOUT_CASES (compare_small_layouts:
    the blend bit-identical across calls)."""
    main = SamplerConfig(dim=2)
    worst = [0.0, 0.0]

    def track(errs):
        worst[:] = [max(a, b) for a, b in zip(worst, errs)]

    for n, q in SMALL_CLOUDS:
        track(compare_fused("fused2d", "path (b)", main, n, C, (H, W), q,
                            seed=6, lo=-1.0, hi=1.0))
    for name, kw, c in FUSED_VARIANTS:
        compare_fused("fused2d", name, SamplerConfig(dim=2, **kw), 8, c,
                      (12, 10), 1037, seed=7, **WIDE)
    compare_fused("fused2d", "channels-4-q-100000", main, N, C, (H, W), Q,
                  seed=8, **WIDE)
    # large cells: 3 x 4 x 64^2 (64 KB a channel group, which the staged
    # design opted in to) and 2 x 4 x 256^2 (1 MB, which it refused)
    compare_fused("fused2d", "large-cell", main, 3, 4, (64, 64), 1500,
                  seed=9, **WIDE)
    compare_fused("fused2d", "larger-cell", main, 2, 4, (256, 256), 4096,
                  seed=9, **WIDE)
    for n, c, spatial, q in FUSED2D_LAYOUT_CASES:
        track(compare_small_layouts("fused2d", main, n, c, spatial, q,
                                    seed=35))
    return {"fused2d_blend": worst[0], "fused2d_bwd": worst[1]}


def _device_ms(fn, reps=20, windows=1):
    """Device ms of one call of ``fn``: the device time of every kernel,
    fill and copy of ``reps`` calls (torch.profiler) over ``reps``, the
    largest of ``windows`` such readings (a window that loses events reads
    low, never high).  Host overhead, which hides kernels of a few
    microseconds from CUDA events around a loop, is left out."""
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(windows):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        readings.append(sum(e.self_device_time_total for e in events) / 1e3
                        / reps)
    return max(readings)


def _pair(mod, cells, pts, g, cfg):
    """A blend and its transpose as the fused op runs them (fused3s: one
    z sort for both)."""
    n, _, *spatial = cells.shape

    def run():
        extra = ((fused3s.zsort(pts, spatial[0], cfg),) if mod is fused3s
                 else ())
        mod.fused_blend(cells, pts, cfg, *extra)
        mod.fused_bwd(g, pts, tuple(spatial), cfg, n, *extra)
    return run


# (N, S, Q) of the 2D small-cloud sweep at C = 4: path (b)'s clouds on
# 16^2 cells and past them to 100 000 points, 8 to 64 cells at 512 to
# 49 152 points, where fused2w's blocks of 128 queries fill few SMs, and
# larger cells (2 x 256^2, 16 x 64^2, 16 x 1024^2 over the L2)
SMALL_CLOUD_SWEEP = (
    [(N, H, q) for q in (200, 1024, 2047, 2731, 3072, 3584, 4096, 6144,
                         8192, 12288, 16384, 24576, 32768, 49152, Q)]
    + [(64, H, q) for q in (2731, 3072, 4096, 8192, 16384, 24576, 32768)]
    + [(48, H, q) for q in (2048, 2731, 4096, 8192, 16384, 24576, 32768)]
    + [(32, H, q) for q in (512, 1024, 2048, 4096, 6144, 8192, 12288,
                            16384, 32768)]
    + [(24, H, q) for q in (2048, 8192, 12288, 16384)]
    + [(16, H, q) for q in (512, 1024, 2048, 4096, 8192, 12288, 16384,
                            32768)]
    + [(8, H, q) for q in (512, 1024, 2048, 4096, 8192, 12288, 16384,
                           24576, 32768, Q)]
    + [(2, 256, q) for q in (100, 4096, 16384)]
    + [(16, 64, q) for q in (1024, 8192, 16384)]
    + [(16, 1024, q) for q in (1024, 8192, 16384)])


def small_cloud_sweep_phase():
    """fused2d against fused2w, blend + bwd device ms in turns (fused2w,
    fused2d, fused2d, fused2w) over SMALL_CLOUD_SWEEP: the measurement
    behind route.FUSED2D_MAX_Q / FUSED2D_MAX_Q_PER_CELL (prints the points
    the rule sends to the slower kernel).  Then the fused op at path (b)'s
    shapes, forward and backward, through the route the rule gives,
    against the plain versions."""
    cfg = SamplerConfig(dim=2)
    rows = []
    for n, s, q in SMALL_CLOUD_SWEEP:
        cells, pts, g = _fused_inputs(n, C, (s, s), q, seed=10, lo=-1.0,
                                     hi=1.0)
        w1, d1, d2, w2 = (_device_ms(_pair(mod, cells, pts, g, cfg))
                          for mod in (fused2w, fused2d, fused2d, fused2w))
        wide, small = (w1 + w2) / 2, (d1 + d2) / 2
        routed = route.fused_rule(cfg, (n, C, s, s), q)
        rows.append((n, s, q, wide, small, routed))
        del cells, pts, g
        print(f"sweep fused2d vs fused2w ({n}x{C}x{s}x{s}, Q={q}): blend + "
              f"bwd device ms fused2d {small:.4f} (turns {d1:.4f} {d2:.4f}),"
              f" fused2w {wide:.4f} (turns {w1:.4f} {w2:.4f}); faster: "
              f"{'fused2d' if small < wide else 'fused2w'}; the rule routes "
              f"{routed}", flush=True)
    slower = [(n, s, q) for n, s, q, wide, small, routed in rows
              if routed != ("fused2d" if small < wide else "fused2w")]
    print(f"sweep: the rule routes {len(slower)} of {len(rows)} points to "
          f"the slower kernel {slower}", flush=True)
    _reset_counts()
    for n, q in SMALL_CLOUDS:
        cells, pts, g = _fused_inputs(n, C, (H, W), q, seed=11, lo=-1.0,
                                     hi=1.0)
        leaf = cells.clone().requires_grad_(True)
        out = tfused.sample_features_with_derivs(leaf, pts, cfg)
        (out * g).sum().backward()
        ref = fused2w.plain_fused_blend(cells, pts, cfg)
        dref = fused2w.plain_fused_bwd(g, pts, (H, W), cfg, n)
        abs_b, rel_b = _rel_err(out.detach(), ref)
        abs_d, rel_d = _rel_err(leaf.grad.reshape(1, -1), dref.reshape(1, -1))
        print(f"path (b) fused op ({n}x{C}x{H}x{W}, Q={q}) through "
              f"{route.fused_rule(cfg, (n, C, H, W), q)}: blend rel "
              f"{rel_b:.3e}, cells grad rel {rel_d:.3e}", flush=True)
        if not (rel_b <= REL_TOL and rel_d <= REL_TOL):
            raise RuntimeError("path (b): the routed fused op disagrees with "
                               "the plain version")
    launches = _counts()
    print(f"path (b) launches: {_nonzero(launches)}", flush=True)
    expected = sum(route.fused_rule(cfg, (n, C, H, W), q) == "fused2d"
                   for n, q in SMALL_CLOUDS)
    if (launches["fused2d_blend"] != expected
            or launches["fused2d_bwd"] != expected
            or launches["fused2w_blend"] != len(SMALL_CLOUDS) - expected
            or launches["plain"] != 0):
        raise RuntimeError(f"path (b) did not follow the rule: {launches}")
    return launches, rows


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def wide_trainer_phase():
    """Path (a): the fused trainer at C = 16 in 2D (20 steps) and 3D (5),
    each through the kernels route.fused_rule gives it (the v1 pair at
    100 000 points) once a step, and --megakernel at C = 16 (5) through one
    mega2w launch a step, and no other kernel (no plain route); then card
    vs CPU at a small N."""
    runs = {}
    for name, model, steps, kw in [
            ("2D", pinn.PINNConfig(cell_dim=C_WIDE), STEPS, {}),
            ("3D", pinn.PINNConfig(dim=3, n_cells=N3, cell_dim=C_WIDE,
                                   pde="helmholtz"), STEPS_WIDE_3D, {}),
            ("megakernel", pinn.PINNConfig(cell_dim=C_WIDE), STEPS_WIDE_MEGA,
             dict(megakernel=True))]:
        shape = (model.n_cells, C_WIDE, *(model.cell_size,) * model.dim)
        kind = route.fused_rule(model.sampler, shape, Q)
        expected = (("mega2w",) if kw else (f"{kind}_blend", f"{kind}_bwd"))
        launches, _ = _train_checked(
            f"wide {name} C={C_WIDE} ({model.n_cells} cells, {Q} points)",
            TrainConfig(model=model, device="cuda", steps=steps, log_every=1,
                        seed=0, **kw), steps, expected)
        if any(launches[k] != steps for k in expected):
            raise RuntimeError(f"wide {name}: expected one launch of each of "
                               f"{expected} a step: {_nonzero(launches)}")
        runs[name] = launches
    for name, cfg in (("2D", pinn.PINNConfig(n_cells=8, cell_dim=C_WIDE)),
                      ("3D", pinn.PINNConfig(dim=3, n_cells=6,
                                             cell_dim=C_WIDE,
                                             pde="helmholtz"))):
        with PointGenerator(4096, cfg.dim, seed=12) as gen:
            pts = torch.from_numpy(gen.batch(0))
        _compare_losses(f"reference wide {name} C={C_WIDE}: fused v1 on the "
                        "card vs plain CPU",
                        _loss_and_grads(pinn.loss_fused, cfg, "cuda", pts, 12),
                        _loss_and_grads(pinn.loss_fused, cfg, "cpu", pts, 12))
    return runs


# --- fused3d / fused3s (small and mid 3D clouds), fused3b at C > 8 ----------

# path (c): the 3D fused trainer at the reference's width (50 x 4 x 16^3,
# hidden 16, Helmholtz) with a small fresh cloud, the mid volume of the
# JAX fused3s dispatch test's regime (16 x 4 x 32^3, 8.4 MB), and config
# 5's volume with the reference's 3D point count drawn fresh each step
Q_SMALL3, N_MID, S_MID, Q_MID, STEPS_SMALL3 = 1024, 16, 32, 4096, 3
# the variants of both kernel pairs: (name, config flags, channels);
# fused3s takes zeros and border only
FUSED3_VARIANTS = [
    ("zeros", {}, 4), ("border", dict(padding_mode="border"), 3),
    ("reflection", dict(padding_mode="reflection"), 4),
    ("linear", dict(kernel="linear"), 3),
    ("smoothstep", dict(kernel="smoothstep"), 4),
    ("no-multicell", dict(multicell=False), 4),
    ("align-false", dict(align_corners=False), 3),
    ("border-no-multicell-align-false",
     dict(padding_mode="border", multicell=False, align_corners=False), 4),
    ("strict-reflection-align-false",
     dict(padding_mode="reflection", strict_reference=True,
          align_corners=False), 3)]


def _tick_points(q, s, seed):
    """(Q, 3) points on the texel ticks of an S^3 cell (align_corners and
    multicell: texel k sits at -1 + 2k / (S - 2)): queries exactly on slab
    boundaries."""
    gen = torch.Generator().manual_seed(seed)
    ticks = torch.linspace(-1.0, 1.0, s - 1)
    return ticks[torch.randint(0, s - 1, (q, 3), generator=gen)]


def compare_planar(name, cfg, n, c, spatial, q, seed, lo=-1.4, hi=1.4):
    """fused3s_blend reading the cells in place (planar) against
    plain_fused_blend on the card; returns the max abs error."""
    cells, pts, _ = _fused_inputs(n, c, spatial, q, seed, lo, hi)
    order = fused3s.zsort(pts, spatial[0], cfg)
    got = fused3s.launch_blend(cells, pts, cfg, order,
                               gather.gather_geometry(n, c), True)
    abs_b, rel_b = _rel_err(got, fused3s.plain_fused_blend(cells, pts, cfg))
    print(f"compare fused3s planar {name} ({n}x{c}x"
          f"{'x'.join(map(str, spatial))}, Q={q}): blend max abs err "
          f"{abs_b:.3e}, rel {rel_b:.3e} (tolerance rel {REL_TOL:g})",
          flush=True)
    if not rel_b <= REL_TOL:
        raise RuntimeError(f"fused3s planar {name}: kernel disagrees with "
                           "the plain version")
    return abs_b


# (N, C, S, Q) at which fused3d's blend and bwd are held to their plain
# versions in every layout of fused3d.blend_alternatives /
# bwd_alternatives: path (c), the 8-cell stack, the shapes the unstaged
# kernels admit (16 x 4 x 32^3 at 4096, 16 x 4 x 128^3 at 1536) and N in
# {1, 3, 6, 50} at C in {1, 3, 4, 8, 12}
FUSED3D_LAYOUT_CASES = ([(N3, C, S3, Q_SMALL3), (8, C, S3, 512),
                         (N_MID, C, S_MID, Q_MID), (N5, C, S5, 1536)]
                        + [(n, c, (7, 8, 9), 2053) for n in (1, 3, 6, 50)
                           for c in (1, 3, C, 8, 12)])


def compare_small_layouts(kind, cfg, n, c, spatial, q, seed, lo=-1.4,
                          hi=1.4):
    """The small-cloud pair ``kind`` ("fused2d" or "fused3d") in every
    layout of its blend_alternatives / bwd_alternatives (the rule's, the
    cells in place and the texel-major copy, the cotangent in place and
    the scratch, other cell lanes, queries a block and block sizes)
    against their plain versions on the card, and the rule's blend
    bit-identical across two calls (no atomics: each row is one lane's
    store); returns the max abs errors (blend, bwd)."""
    mod = FUSED_MODS[kind]
    cells, pts, g = _fused_inputs(n, c, spatial, q, seed, lo, hi)
    ref = mod.plain_fused_blend(cells, pts, cfg)
    dref = mod.plain_fused_bwd(g, pts, spatial, cfg, n)
    blends = mod.blend_alternatives(n, c, q, spatial)
    bwds = mod.bwd_alternatives(n, c, q, spatial)
    errs = {}
    for name, lay in blends.items():
        errs["blend", name] = _rel_err(mod.launch_blend(cells, pts, cfg, lay),
                                       ref)
    for name, lay in bwds.items():
        got = mod.launch_bwd(g, pts, spatial, cfg, n, lay)
        errs["bwd", name] = _rel_err(got.reshape(1, -1), dref.reshape(1, -1))
    first = mod.launch_blend(cells, pts, cfg, blends["rule"])
    same = torch.equal(first, mod.launch_blend(cells, pts, cfg,
                                               blends["rule"]))
    torch.cuda.synchronize()
    worst = {part: max((v for (k, _), v in errs.items() if k == part),
                       key=lambda e: e[1]) for part in ("blend", "bwd")}
    print(f"compare {kind} layouts ({n}x{c}x{'x'.join(map(str, spatial))}, "
          f"Q={q}): {len(blends)} blend layouts, worst rel "
          f"{worst['blend'][1]:.3e}; {len(bwds)} bwd layouts, worst rel "
          f"{worst['bwd'][1]:.3e} (tolerance rel {REL_TOL:g}); the rule's "
          f"blend bit-identical across two calls: {same}", flush=True)
    bad = [k for k, (_, rel) in errs.items() if not rel <= REL_TOL]
    if bad or not same:
        raise RuntimeError(f"{kind} layouts at {n}x{c}x{spatial}, Q={q}: "
                           f"disagree with plain {bad}, bit-identical "
                           f"{same}")
    return worst["blend"][0], worst["bwd"][0]


def fused3ds_kernel_phase():
    """B8 and B9 against their plain versions: fused3d at path (c)'s stack
    (50 x 4 x 16^3, Q = 200, 1024, 2047) and an opted-in 8 x 16^3 channel
    group, and in every layout its sweep times at FUSED3D_LAYOUT_CASES
    (compare_small_layouts: the blend bit-identical across calls);
    fused3s at path (c)'s large volume (16 x 4 x 128^3, Q =
    100 000), where its launches come from, the mid volume (16 x 4 x
    32^3, Q = 4096), JAX's 2 x 2 x 32^3 at 2048 and 16 x 4 x 64^3 at
    16384, and the unplanned config-5 step's 1 000 000 points; both in
    each variant each takes, at C in {1, 3, 8, 12} (two channel groups),
    points to +-1.4 and on the texel ticks; fused3s's gather and scatter
    at N in {1, 3, 6, 50} x C in {1, 3, 8, 16}."""
    main = SamplerConfig(dim=3)
    worst = {}

    def track(kind, errs):
        for part, err in zip(("blend", "bwd"), errs):
            key = f"{kind}_{part}"
            worst[key] = max(worst.get(key, 0.0), err)

    for q in (200, Q_SMALL3, 2047):
        track("fused3d", compare_fused("fused3d", "path (c)", main, N3, C,
                                       (S3,) * 3, q, seed=20, lo=-1.0,
                                       hi=1.0))
    for n, c, s, q in ((N5, C, S5, Q), (N_MID, C, S_MID, Q_MID),
                       (2, 2, 32, 2048), (16, C, 64, 16384)):
        track("fused3s", compare_fused("fused3s", "path (c)", main, n, c,
                                       (s,) * 3, q, seed=21, lo=-1.0,
                                       hi=1.0))
    # the unplanned config-5 step's own points (the trainer's first batch
    # of 1 000 000): every table block full, the dense 256-thread layout
    track("fused3s", compare_fused("fused3s", "config-5 unplanned", main, N5,
                                   C, (S5,) * 3, Q5, seed=27,
                                   pts=_trainer_points(Q5, 3)))
    track("fused3d", compare_fused("fused3d", "opt-in 8x16^3 group", main,
                                   8, 8, (S3,) * 3, 1500, seed=22, **WIDE))
    for n, c, s, q in FUSED3D_LAYOUT_CASES:
        spatial = s if isinstance(s, tuple) else (s,) * 3
        track("fused3d", compare_small_layouts("fused3d", main, n, c,
                                               spatial, q, seed=34))
    for kind in ("fused3d", "fused3s"):
        for name, kw, c in FUSED3_VARIANTS:
            cfg = SamplerConfig(dim=3, **kw)
            if FUSED_MODS[kind].supports(cfg, (6, c, 7, 8, 9)):
                track(kind, compare_fused(kind, name, cfg, 6, c, (7, 8, 9),
                                          2053, seed=23, **WIDE))
        for c in (1, 3, 8, 12):
            track(kind, compare_fused(kind, f"channels-{c}", main, 6, c,
                                      (7, 8, 9), 2053, seed=24, **WIDE))
        track(kind, compare_fused(kind, "texel-ticks", main, 5, 3, (6,) * 3,
                                  1000, seed=25,
                                  pts=_tick_points(1000, 6, 25)))
    for n, c in itertools.product(SCATTER_CELLS, SCATTER_CHANNELS):
        track("fused3s", compare_fused("fused3s", f"lanes N={n} C={c}", main,
                                       n, c, (7, 8, 9), 2053, seed=26,
                                       **WIDE))
    # the planar blend (the rule's below fused3s.PLANAR_POINTS_PER_TEXEL)
    # in every variant and at the lanes' channel counts
    for name, kw, c in FUSED3_VARIANTS:
        cfg = SamplerConfig(dim=3, **kw)
        if fused3s.supports(cfg, (6, c, 7, 8, 9)):
            track("fused3s", (compare_planar(name, cfg, 6, c, (7, 8, 9), 2053,
                                             seed=28), 0.0))
    for n, c in itertools.product(SCATTER_CELLS, SCATTER_CHANNELS):
        track("fused3s", (compare_planar(f"lanes N={n} C={c}", main, n, c,
                                         (7, 8, 9), 2053, seed=29), 0.0))
    return worst


def fused3b_wide_kernel_phase():
    """fused3b's channel groups against the plain vol versions: config 5's
    volume and points at C = 16 (16 x 16 x 128^3, 2.1 GB; two groups of
    8), and C in {9, 12, 16} in variants."""
    main = SamplerConfig(dim=3)
    compare_3b(f"config-5 C={C_WIDE}", main, N5, C_WIDE, (S5,) * 3, Q5,
               pts=_trainer_points(Q5, 3))
    torch.cuda.empty_cache()
    for c in (9, 12, 16):
        compare_3b(f"channels-{c}", main, 6, c, (9, 9, 9), 4099, seed=2,
                   lo=-1.4, hi=1.4)
    compare_3b("reflection channels-12",
               SamplerConfig(dim=3, padding_mode="reflection"), 6, 12,
               (9, 9, 9), 4099, seed=3)
    compare_3b("border align-false channels-9",
               SamplerConfig(dim=3, padding_mode="border",
                             align_corners=False), 6, 9, (9, 9, 9), 4099,
               seed=4)


MODEL_5W = pinn.PINNConfig(dim=3, n_cells=N5, cell_dim=C_WIDE, cell_size=S5,
                           pde="helmholtz")
STEPS_VOL_WIDE = 3


def vol_wide_trainer_phase():
    """The vol-resident trainer at C = 16 on config 5's volume and points
    (16 x 16 x 128^3, 1 000 000 points), 3 steps: one fused3b_blend and one
    fused3b_bwd launch a step and nothing else; its losses against the
    query-ordered fused trainer's (the v1 pair at C = 16) on the same
    fixed points, the first at LOSS_RTOL and each within GRAD_TOL; the
    loss and leaves of one step against loss_fused's on the card; card vs
    CPU at 5 x 12 x 6^3, Q = 120."""
    launches, losses = _train_checked(
        f"vol-resident C={C_WIDE} {N5}x{C_WIDE}x{S5}^3, {Q5} points",
        TrainConfig(model=MODEL_5W, device="cuda", batch_points=Q5,
                    steps=STEPS_VOL_WIDE, log_every=1, seed=0,
                    vol_resident=True),
        STEPS_VOL_WIDE, ("fused3b_blend", "fused3b_bwd"))
    if (launches["fused3b_blend"] != STEPS_VOL_WIDE
            or launches["fused3b_bwd"] != STEPS_VOL_WIDE):
        raise RuntimeError(f"expected {STEPS_VOL_WIDE} launches of each "
                           "fused3b kernel")
    _reset_counts()
    ref = _fixed_point_losses(MODEL_5W, Q5, STEPS_VOL_WIDE)
    ref_launches = _counts()
    if (ref_launches["fused_blend"] != STEPS_VOL_WIDE
            or ref_launches["fused3b_blend"] != 0):
        raise RuntimeError(f"the query-ordered C={C_WIDE} trainer took "
                           f"another route: {_nonzero(ref_launches)}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"vol-resident C={C_WIDE} vs query-ordered (v1) trainer losses on "
          f"the same fixed points: {' '.join(f'{v:.8g}' for v in ref)} (v1);"
          f" worst rel diff {max(rel):.3e}, first {rel[0]:.3e}", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError(f"vol-resident and v1 trainers disagree at "
                           f"C={C_WIDE}")
    torch.cuda.empty_cache()
    pts = _trainer_points(Q5, 3)
    _compare_losses(f"vol-resident C={C_WIDE} vs loss_fused (v1) on the card "
                    f"({N5}x{C_WIDE}x{S5}^3, Q={Q5})",
                    _vol_loss_and_grads(MODEL_5W, "cuda", pts, 0),
                    _loss_and_grads(pinn.loss_fused, MODEL_5W, "cuda", pts,
                                    0))
    torch.cuda.empty_cache()
    cfg = pinn.PINNConfig(dim=3, n_cells=5, cell_dim=12, cell_size=6,
                          pde="helmholtz")
    with PointGenerator(120, 3, seed=7) as gen:
        small = torch.from_numpy(gen.batch(0))
    _compare_losses("reference vol-resident C=12: fused3b on the card vs "
                    "plain CPU (5x12x6^3, Q=120)",
                    _vol_loss_and_grads(cfg, "cuda", small, 7),
                    _vol_loss_and_grads(cfg, "cpu", small, 7))
    return launches


def planned_wide_phase():
    """The planned op's route at C = 16, measured: fused3b over the plan
    (the cells relaid on every call, as the planned op does) against the
    v1 pair in query order, blend + bwd in turns, at 50 x 16 x 16^3 with
    100 000 fixed points and at 16 x 16 x 128^3 with 1 000 000 (2.1 GB of
    cells); then the fixed-point steps in turns at the first."""
    cfg = SamplerConfig(dim=3)
    for n, s, q in ((N3, S3, Q), (N5, S5, Q5)):
        spatial = (s,) * 3
        pts = _trainer_points(q, 3, seed=26)
        cells = torch.rand((n, C_WIDE, *spatial), generator=_cuda_gen(26),
                           device="cuda")
        plan = tfused.make_vol_plan(pts, cells.shape, cfg)
        g_q = torch.randn((7, C_WIDE, q), generator=_cuda_gen(27),
                          device="cuda")
        g_p = g_q.new_zeros((7, C_WIDE, plan[1].shape[0]))
        g_p[:, :, plan[0]] = g_q

        def planned():
            vol = fused3b.cells_to_vol(cells)
            fused3b.fused3b_blend_vol(vol, plan, cfg)
            fused3b.vol_to_cells(fused3b.fused3b_bwd_vol(g_p, plan, spatial,
                                                         cfg, n))

        def v1():
            fused_v1.fused_blend(cells, pts, cfg)
            fused_v1.fused_bwd(g_q, pts, spatial, cfg, n)

        p_ms, v_ms = _in_turns(planned, v1, reps=3)
        routed = tfused.make_sample_plan(pts, cells.shape, cfg) is not None
        print(f"planned route at C={C_WIDE} ({n}x{C_WIDE}x{s}^3, "
              f"{4 * cells.numel() / 1e6:.1f} MB, Q={q}): fused3b with the "
              f"relayout, blend + bwd {p_ms:.4f} ms; v1 blend + bwd "
              f"{v_ms:.4f} ms; make_sample_plan routes it to "
              f"{'fused3b' if routed else 'v1'}", flush=True)
        if not routed:
            raise RuntimeError("make_sample_plan gave no plan at C > 8")
        del cells, plan, g_q, g_p
        torch.cuda.empty_cache()
    model = pinn.PINNConfig(dim=3, n_cells=N3, cell_dim=C_WIDE,
                            pde="helmholtz")
    _fixed_step_turns(f"fixed points {N3}x{C_WIDE}x{S3}^3, Q={Q},", model,
                      _trainer_points(Q, 3, seed=26),
                      ("planned", "unplanned"))


def _fused3b_with_plan(cells, pts, g, cfg):
    """fused3b blend + bwd with its plan and the relayouts built inside
    the call, as a caller without a fixed point set would pay them."""
    n, c, *spatial = cells.shape

    def run():
        plan = tfused.make_vol_plan(pts, cells.shape, cfg)
        fused3b.fused3b_blend_vol(fused3b.cells_to_vol(cells), plan, cfg)
        g_p = g.new_zeros((7, c, plan[1].shape[0]))
        g_p[:, :, plan[0]] = g
        fused3b.vol_to_cells(fused3b.fused3b_bwd_vol(g_p, plan,
                                                     tuple(spatial), cfg, n))
    return run


# (cells, channels, cell size, points) of the 3D small-cloud sweep: the
# stacks and clouds of path (c) and of the JAX dispatch tests, the two
# sides of fused3d's bounds (points, and points a cell: at 8 cells from
# 256 points, at 16, 24, 32 and 50 cells), small clouds on the large
# cells fused3d takes since it stages nothing (16 x 4 x 32^3 at 1024 to
# 4096 points, 16 x 4 x 128^3 at 1536 to 8192), and fresh points on
# stacks over the L2 on the two sides of each of fused3s's bounds
# (points, stack bytes, channels, (cell, channel) planes)
SWEEP_3D = ([(N3, C, S3, q) for q in (200, 2048, 3072, 4096, 6144, 8192,
                                      12288, 16384, 24576, 32768, Q)]
            + [(8, C, S3, q) for q in (256, 512, 768, 1024, 2048, 4096,
                                       6144, 8192, 12288, 16384)]
            + [(16, C, S3, q) for q in (1024, 2048, 4096, 6144, 8192,
                                        12288)]
            + [(n, C, S3, q) for n in (24, 32)
               for q in (1024, 2048, 3072, 4096, 6144, 8192, 12288)]
            + [(2, 2, 32, 2048)]
            + [(16, C, 24, Q)]
            + [(16, C, 32, q) for q in (1024, 1536, 2048, 3072, 4096, 6144,
                                        9000, 32768, 65536, Q)]
            + [(16, C, 64, q)
               for q in (16384, 32768, 49152, 65536, 81920, Q, 131072)]
            + [(8, C, 80, Q)]
            + [(16, c, 96, Q) for c in (2, 3, C)]
            + [(16, C, 64, 262144)]
            + [(N5, C, S5, q)
               for q in (1536, 2048, 4096, 5120, 6144, 8192, 32768, 40960,
                         49152,
                         65536, 81920, Q, 131072, 262144, 393216, 524288,
                         Q5)]
            + [(n, C, S5, Q) for n in (4, 6, 12)])


def small_cloud_3d_sweep_phase(points=SWEEP_3D):
    """fused3d, fused3s and fused3w (the routes of the fused op at C <= 8
    in 3D) and fused3b with its plan built in the call, blend + bwd device
    ms (torch.profiler, 6 calls a window) at each (N, C, S, Q) of
    ``points``, the paths in turns (each, then the same reversed), the
    larger turn kept (a window that loses events reads low), inputs drawn
    on the card: the measurement behind route.FUSED3D_MAX_Q and the
    FUSED3S_* bounds."""
    cfg = SamplerConfig(dim=3)
    rows = []
    for n, c, s, q in points:
        shape = (n, c, s, s, s)
        gen = _cuda_gen(28)
        cells = torch.rand(shape, generator=gen, device="cuda")
        pts = torch.rand((q, 3), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((7, c, q), generator=gen, device="cuda")
        paths = {"fused3d": fused3d.supports(cfg, shape),
                 "fused3s": fused3s.supports(cfg, shape),
                 "fused3w": True,
                 "fused3b+plan": fused3b.supports(cfg, shape, q)}
        runs = {k: (_fused3b_with_plan(cells, pts, g, cfg)
                    if k == "fused3b+plan"
                    else _pair(FUSED_MODS[k], cells, pts, g, cfg))
                for k, ok in paths.items() if ok}
        turns = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            turns[k].append(_device_ms(runs[k], reps=6))
        ms = {k: max(v) for k, v in turns.items()}
        routed = route.fused_rule(cfg, shape, q)
        fastest = min((k for k in ms if k != "fused3b+plan"), key=ms.get)
        rows.append((n, c, s, q, ms, routed, fastest))
        print(f"sweep 3D ({n}x{c}x{s}^3, {4 * cells.numel() / 1e6:.1f} MB, "
              f"Q={q}): blend + bwd device ms "
              + ", ".join(f"{k} {v:.4f} (turns {turns[k][0]:.4f} "
                          f"{turns[k][1]:.4f})" for k, v in ms.items())
              + f"; fastest routable {fastest}; the rule routes {routed}",
              flush=True)
        del cells, pts, g, runs
        torch.cuda.empty_cache()
    slower = [(n, c, s, q) for n, c, s, q, _, routed, fastest in rows
              if routed != fastest]
    print(f"sweep 3D: the rule routes {len(slower)} of {len(rows)} points to "
          f"a slower kernel {slower}", flush=True)
    return rows


@contextlib.contextmanager
def _fused_routed(name):
    """Every fused op call routed to ``name`` while the block runs
    (route.pick_fused replaced, then restored)."""
    pick = route.pick_fused
    route.pick_fused = lambda *args: name
    try:
        yield
    finally:
        route.pick_fused = pick


def small_cloud_3d_trainer_phase():
    """Path (c): the 3D fused trainer at 50 x 4 x 16^3 with 1024 fresh
    points a step, at the mid volume 16 x 4 x 32^3 with 4096 and on config
    5's 16 x 4 x 128^3 with route.FUSED3S_MIN_Q (393 216), each through
    the kernels the rule
    gives (one blend and one bwd a step, no other kernel, no plain
    route).  For the first two, the losses against the same run on the
    CPU (the first at LOSS_RTOL, each within GRAD_TOL) and one step's loss
    and leaves card vs CPU; for the large volume, whose kernels are held
    to their plain versions at this shape in fused3ds_kernel_phase, one
    step's loss and leaves against the same step through fused3w on the
    card."""
    total = {}
    for name, model, q in [
            ("small cloud", MODEL_3D, Q_SMALL3),
            ("mid volume", pinn.PINNConfig(dim=3, n_cells=N_MID,
                                           cell_size=S_MID, pde="helmholtz"),
             Q_MID),
            ("large volume", MODEL_5, route.FUSED3S_MIN_Q)]:
        shape = (model.n_cells, model.cell_dim, *(model.cell_size,) * 3)
        kind = route.fused_rule(model.sampler, shape, q)
        launched = (f"{kind}_blend", f"{kind}_bwd")
        what = (f"3D {name} {'x'.join(map(str, shape[:2]))}x"
                f"{model.cell_size}^3, {q} points, through {kind}")
        train_cfg = dict(model=model, batch_points=q, steps=STEPS_SMALL3,
                         log_every=1, seed=0)
        launches, losses = _train_checked(
            what, TrainConfig(device="cuda", **train_cfg), STEPS_SMALL3,
            launched, decrease=False)
        if any(launches[k] != STEPS_SMALL3 for k in launched):
            raise RuntimeError(f"{what}: expected one launch of each kernel "
                               f"a step: {_nonzero(launches)}")
        if model is not MODEL_5:
            _, cpu = train(TrainConfig(device="cpu", **train_cfg))
            rel = [abs(a - m["loss"]) / abs(m["loss"])
                   for a, m in zip(losses, cpu)]
            print(f"{what}: card vs CPU trainer losses, worst rel diff "
                  f"{max(rel):.3e}, first {rel[0]:.3e}", flush=True)
            if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
                raise RuntimeError(f"{what}: card and CPU trainers disagree")
        with PointGenerator(q, 3, seed=29) as gen:
            pts = torch.from_numpy(gen.batch(0))
        got = _loss_and_grads(pinn.loss_fused, model, "cuda", pts, 29)
        if model is MODEL_5:
            with _fused_routed("fused3w"):
                _compare_losses(f"{what}: vs fused3w on the card", got,
                                _loss_and_grads(pinn.loss_fused, model,
                                                "cuda", pts, 29))
        else:
            _compare_losses(f"{what}: card vs plain CPU", got,
                            _loss_and_grads(pinn.loss_fused, model, "cpu",
                                            pts, 29))
        for k in launched:
            total[k] = total.get(k, 0) + launches[k]
    if not any(total.get(k, 0) for k in ("fused3d_blend", "fused3s_blend")):
        raise RuntimeError(f"path (c) launched neither fused3d nor fused3s: "
                           f"{total}")
    return total


def small_cloud_2d_trainer_phase():
    """Path (b)'s trainer: the 2D fused trainer at 96 x 4 x 16^2 with
    Q_SMALL2 fresh points a step (STEPS_SMALL2 steps) through the kernels
    the rule gives, fused2d's (one blend and one bwd a step, no other
    kernel, no plain route); its losses against the same run on the CPU
    (the first at LOSS_RTOL, each within GRAD_TOL) and one step's loss and
    leaves card vs CPU; returns the launch counts."""
    model = pinn.PINNConfig()
    shape = (model.n_cells, model.cell_dim, model.cell_size, model.cell_size)
    kind = route.fused_rule(model.sampler, shape, Q_SMALL2)
    if kind != "fused2d":
        raise RuntimeError(f"path (b)'s trainer routes to {kind}")
    launched = ("fused2d_blend", "fused2d_bwd")
    what = (f"2D small cloud {'x'.join(map(str, shape))}, {Q_SMALL2} points,"
            f" through {kind}")
    train_cfg = dict(model=model, batch_points=Q_SMALL2, steps=STEPS_SMALL2,
                     log_every=1, seed=0)
    launches, losses = _train_checked(
        what, TrainConfig(device="cuda", **train_cfg), STEPS_SMALL2,
        launched, decrease=False)
    if any(launches[k] != STEPS_SMALL2 for k in launched):
        raise RuntimeError(f"{what}: expected one launch of each kernel a "
                           f"step: {_nonzero(launches)}")
    _, cpu = train(TrainConfig(device="cpu", **train_cfg))
    rel = [abs(a - m["loss"]) / abs(m["loss"]) for a, m in zip(losses, cpu)]
    print(f"{what}: card vs CPU trainer losses, worst rel diff "
          f"{max(rel):.3e}, first {rel[0]:.3e}", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError(f"{what}: card and CPU trainers disagree")
    with PointGenerator(Q_SMALL2, 2, seed=31) as gen:
        pts = torch.from_numpy(gen.batch(0))
    _compare_losses(f"{what}: card vs plain CPU",
                    _loss_and_grads(pinn.loss_fused, model, "cuda", pts, 31),
                    _loss_and_grads(pinn.loss_fused, model, "cpu", pts, 31))
    return launches


def _parent_turns(parent, args):
    """scripts/profile_port_step.py ``args`` under the package of
    ``parent`` (a checkout of another commit, which builds its own
    kernels) and this checkout's in turns (parent, this, this, parent),
    each in a process of its own; prints each run's last line."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "scripts", "profile_port_step.py")
    for where in (parent, here, here, parent):
        run = subprocess.run([sys.executable, script, *args],
                             env={**os.environ, "PYTHONPATH": where},
                             capture_output=True, text=True, timeout=900,
                             check=True)
        print(f"in turns, {'parent' if where == parent else 'this checkout'}"
              f" ({' '.join(args)}): {run.stdout.strip().splitlines()[-1]}",
              flush=True)


def fused3ds_time_phase(parent=None):
    """fused3d at path (c)'s small cloud (50 x 4 x 16^3, Q = 1024) and
    fused3s at its large volume (16 x 4 x 128^3, Q = 100 000): kernel and
    plain ms in turns (CUDA events; fused3s's each include a z sort),
    device ms (torch.profiler), bounds, and the z sort alone; fused3s_bwd
    at 1 000 000 points beside its bound; fused3b at C = 16 on config 5
    beside its bound.  With ``parent`` (a checkout of the parent commit,
    ``--parent``) fused3d's pair is also timed alone in turns against the
    parent's (profile_port_step.py --fused3d)."""
    if parent:
        _parent_turns(parent, ["--fused3d"])
    times = {}
    cfg = SamplerConfig(dim=3)
    for kind, n, s, q in (("fused3d", N3, S3, Q_SMALL3),
                          ("fused3s", N5, S5, Q)):
        mod = FUSED_MODS[kind]
        spatial = (s,) * 3
        cells, pts, g = _fused_inputs(n, C, spatial, q, seed=30, lo=-1.0,
                                     hi=1.0)
        # 7 rows x 8 corners x C FMAs per (cell, query); the blend reads
        # the distinct cell values its corners touch and the points and
        # writes (7, C, Q); the bwd reads the cotangent and the points and
        # writes the whole cells cotangent
        flops = 2 * 7 * 8 * n * C * q
        touched = _touched_values(cells, pts.reshape(1, 1, 1, q, 3), cfg)
        ops = {
            f"{kind}_blend": (lambda: mod.fused_blend(cells, pts, cfg),
                              lambda: mod.plain_fused_blend(cells, pts, cfg),
                              4 * (touched + 3 * q + 7 * C * q)),
            f"{kind}_bwd": (lambda: mod.fused_bwd(g, pts, spatial, cfg, n),
                            lambda: mod.plain_fused_bwd(g, pts, spatial, cfg,
                                                        n),
                            4 * (7 * C * q + 3 * q + n * C * s ** 3)),
        }
        for name, (kernel, plain, nbytes) in ops.items():
            bound_ms, bound_by = _bound(nbytes, flops)
            ms, plain_ms = _in_turns(kernel, plain, reps=5)
            # the largest of three windows: a window that loses events
            # reads low (0.0000 for fused3d_blend in one run)
            dev_ms = _device_ms(kernel, windows=3)
            times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=None,
                               device_ms=dev_ms)
            print(f"time {name} ({n}x{C}x{s}^3, Q={q}): kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of "
                  f"it; no library call computes it", flush=True)
        if kind == "fused3s":
            sort_ms = _device_ms(lambda: fused3s.zsort(pts, s, cfg))
            print(f"time fused3s's z sort alone (Q={q}): device {sort_ms:.4f}"
                  f" ms", flush=True)
        del cells, pts, g
        torch.cuda.empty_cache()
    # fused3s_blend and fused3s_bwd at the unplanned config-5 step's
    # 1 000 000 fresh points
    spatial = (S5,) * 3
    gen = _cuda_gen(33)
    cells = torch.rand((N5, C, *spatial), generator=gen, device="cuda")
    pts = torch.rand((Q5, 3), generator=gen, device="cuda") * 2 - 1
    g = torch.randn((7, C, Q5), generator=gen, device="cuda")
    flops = 2 * 7 * 8 * N5 * C * Q5
    touched = _touched_values(cells, pts.reshape(1, 1, 1, Q5, 3), cfg)
    for name, fn, nbytes in [
            ("fused3s_blend", functools.partial(fused3s.fused_blend, cells,
                                                pts, cfg),
             4 * (touched + 3 * Q5 + 7 * C * Q5)),
            ("fused3s_bwd", functools.partial(fused3s.fused_bwd, g, pts,
                                              spatial, cfg, N5),
             4 * (7 * C * Q5 + 3 * Q5 + N5 * C * S5 ** 3))]:
        bound_ms, bound_by = _bound(nbytes, flops)
        ms = _time_ms(fn, 5)
        dev_ms = _device_ms(fn, reps=5)
        print(f"time {name} ({N5}x{C}x{S5}^3, Q={Q5}): kernel {ms:.4f} ms "
              f"(device {dev_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}),"
              f" {bound_ms / ms:.1%} of it", flush=True)
    sort_ms = _device_ms(lambda: fused3s.zsort(pts, S5, cfg), reps=5)
    print(f"time fused3s's z sort alone (Q={Q5}): device {sort_ms:.4f} ms",
          flush=True)
    del cells, pts, g
    torch.cuda.empty_cache()
    spatial = (S5,) * 3
    pts = _trainer_points(Q5, 3)
    cells = torch.rand((N5, C_WIDE, *spatial), generator=_cuda_gen(31),
                       device="cuda")
    vol = fused3b.cells_to_vol(cells)
    del cells
    plan = tfused.make_vol_plan(pts, (N5, C_WIDE, *spatial), cfg)
    qp = plan[1].shape[0]
    g_p = torch.randn((7, C_WIDE, qp), generator=_cuda_gen(32),
                      device="cuda")
    flops = 2 * 7 * 8 * C_WIDE * N5 * Q5
    vol_bytes = 4 * N5 * C_WIDE * S5 ** 3
    plan_bytes = 4 * (3 * Q5 + qp + plan[4].numel())
    for name, fn, nbytes in [
            ("fused3b_blend", lambda: fused3b.fused3b_blend_vol(vol, plan,
                                                                 cfg),
             vol_bytes + plan_bytes + 4 * 7 * C_WIDE * qp),
            ("fused3b_bwd", lambda: fused3b.fused3b_bwd_vol(
                g_p, plan, spatial, cfg, N5),
             4 * 7 * C_WIDE * Q5 + plan_bytes + vol_bytes)]:
        ms = _time_ms(fn, 5)
        bound_ms, bound_by = _bound(nbytes, flops)
        print(f"time {name} at config 5, C={C_WIDE} ({N5}x{C_WIDE}x{S5}^3, "
              f"Q={Q5}): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.1%} of it", flush=True)
    del vol, g_p
    torch.cuda.empty_cache()
    _fixed_step_turns(f"config 5 C={C_WIDE}", MODEL_5W, pts, ("vol",), plan)
    return times


def plain_route_phase():
    """The calls no kernel takes compute on the card through the counted
    plain route, as the JAX package sends them to XLA, and match the CPU:
    f64 cosine_sampler_2d / _3d (and gradcheck), the f64 fused op, the fused
    op in strict 2D with align_corners off, and an order-0 blend over a
    stack of 2^31 elements."""
    def checked(what, fn, expect_plain=True):
        """fn() with every launch count read around it: the plain route
        only, or where not expect_plain, no plain launch."""
        _reset_counts()
        result = fn()
        torch.cuda.synchronize()
        launches = _nonzero(_counts())
        print(f"plain route: {what}: launches {launches}", flush=True)
        if expect_plain and (not launches.get("plain")
                             or set(launches) != {"plain"}):
            raise RuntimeError(f"{what}: expected the plain route only")
        if not expect_plain and (launches.get("plain") or not launches):
            raise RuntimeError(f"{what}: expected kernels and no plain "
                               "launch")
        return result

    gen = torch.Generator().manual_seed(13)
    for dim, sampler in ((2, cosine_sampler_2d), (3, cosine_sampler_3d)):
        spatial = (4, 5) if dim == 2 else (3, 4, 5)
        x = torch.rand((2, 2, *spatial), generator=gen, dtype=torch.float64)
        grid = (torch.rand((1, *(1,) * (dim - 1), 5, dim), generator=gen,
                           dtype=torch.float64) * 1.6 - 0.8)
        want = sampler(x, grid)
        got = checked(f"f64 cosine_sampler_{dim}d",
                      lambda: sampler(x.cuda(), grid.cuda()))
        err = float((got.cpu() - want).abs().max())
        print(f"plain route: f64 cosine_sampler_{dim}d card vs CPU max abs "
              f"err {err:.3e}", flush=True)
        if err > 1e-12:
            raise RuntimeError(f"f64 cosine_sampler_{dim}d: card and CPU "
                               "disagree")
        xc = x.cuda().requires_grad_(True)
        gc = grid.cuda().requires_grad_(True)
        ok = checked(f"gradcheck of f64 cosine_sampler_{dim}d",
                     lambda: torch.autograd.gradcheck(
                         lambda a, b: sampler(a, b), (xc, gc)))
        if not ok:
            raise RuntimeError(f"gradcheck of cosine_sampler_{dim}d failed")

    for what, cfg, dtype in [
            ("f64 fused op", SamplerConfig(dim=2), torch.float64),
            ("f64 fused op 3D", SamplerConfig(dim=3), torch.float64),
            ("strict 2D fused op with align_corners off",
             SamplerConfig(dim=2, strict_reference=True, align_corners=False,
                           padding_mode="reflection"), torch.float32)]:
        spatial = (12, 10) if cfg.dim == 2 else (7, 8, 9)
        cells, pts, g = (t.cpu().to(dtype) for t in _fused_inputs(
            6, 3, spatial, 1000, seed=14))

        def run(device):
            leaf = cells.to(device, copy=True).requires_grad_(True)
            out = tfused.sample_features_with_derivs(leaf, pts.to(device),
                                                     cfg)
            (out * g.to(device)).sum().backward()
            return out.detach().cpu(), leaf.grad.cpu()

        want = run("cpu")
        got = checked(what, lambda: run("cuda"))
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        tol = 1e-12 if dtype == torch.float64 else REL_TOL
        print(f"plain route: {what} card vs CPU rel err rows {errs[0]:.3e}, "
              f"cells grad {errs[1]:.3e} (tolerance {tol:g})", flush=True)
        if max(errs) > tol:
            raise RuntimeError(f"{what}: card and CPU disagree")

    _bf16_phase(checked)

    # 2 x 4 x 16384^2 = 2^31 elements (8.6 GB): over the kernels' 32-bit
    # indexing
    x = torch.rand((2, 4, 16384, 16384), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(15))
    grid = torch.rand((1, 1, 4096, 2), generator=gen) * 2 - 1
    got = checked(f"order-0 blend over {x.numel()} elements",
                  lambda: sample(x, grid.cuda(), SamplerConfig(dim=2)))
    xh = x.cpu()
    del x
    torch.cuda.empty_cache()
    want = sample(xh, grid, SamplerConfig(dim=2))
    err = float((got.cpu() - want).abs().max())
    print(f"plain route: blend over 2^31 elements card vs CPU max abs err "
          f"{err:.3e}", flush=True)
    if err > 1e-5:
        raise RuntimeError("the 2^31-element blend: card and CPU disagree")


def tf32_phase():
    """Exact mode whatever the global matmul flag: under
    torch.set_float32_matmul_precision("high") (TF32 matmuls, shown on a
    matmul) the 2D fused loss and the config-5 vol-resident loss and their
    gradients match the "highest" ones at f32 tolerance.  The control runs
    "high" with pinn._tf32 forced off, so that the ladder's contractions
    take TF32 as the unrepaired ladder did: it must disagree, or the
    comparison would prove nothing.  Then the steps' medians under each
    setting."""
    a = torch.randn((512, 512), device="cuda")
    exact = a @ a
    with PointGenerator(Q, 2, seed=16) as gen:
        pts2 = torch.from_numpy(gen.batch(0))
    pts5 = _trainer_points(Q5, 3)
    results = {}
    tf32 = pinn._tf32
    for run, precision in (("highest", "highest"), ("high", "high"),
                           ("control", "high")):
        torch.set_float32_matmul_precision(precision)
        if run == "control":
            pinn._tf32 = lambda t: False
        try:
            err = float((a @ a - exact).abs().max() / exact.abs().max())
            results[run] = (
                err,
                _loss_and_grads(pinn.loss_fused, pinn.PINNConfig(), "cuda",
                                pts2, 16),
                _vol_loss_and_grads(MODEL_5, "cuda", pts5, 17))
        finally:
            pinn._tf32 = tf32
            torch.set_float32_matmul_precision("highest")
    print(f"TF32: a 512 x 512 matmul under 'high' is off the 'highest' one "
          f"by {results['high'][0]:.3e} of its largest magnitude", flush=True)
    if not results["high"][0] > 1e-5:
        raise RuntimeError("'high' did not switch the matmuls to TF32: the "
                           "check would prove nothing")
    for i, what in ((1, "2D fused"), (2, "config-5 vol-resident")):
        _compare_losses(f"exact mode under 'high' vs 'highest': {what}",
                        results["high"][i], results["highest"][i])
        if _losses_agree(f"control, TF32 ladder under 'high' vs 'highest': "
                         f"{what}", results["control"][i],
                         results["highest"][i]):
            raise RuntimeError(f"the TF32 ladder agrees with 'highest' on "
                               f"the {what} step: the check proves nothing")
    with PointGenerator(Q, 2, seed=7) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda() for i in range(13)]
    plan = tfused.make_vol_plan(pts5, (N5, C, S5, S5, S5), MODEL_5.sampler)
    for precision in ("highest", "high", "high", "highest"):
        torch.set_float32_matmul_precision(precision)
        try:
            fused_ms = _median_step_ms(pinn.PINNConfig(), batches, fused=True)
            vol_ms, peak = _fixed_step_median(_fixed_step(MODEL_5, pts5,
                                                          "vol", plan))
        finally:
            torch.set_float32_matmul_precision("highest")
        torch.cuda.empty_cache()
        print(f"step under '{precision}': 2D fused {fused_ms:.4f} ms, "
              f"config-5 vol-resident {vol_ms:.4f} ms (peak {peak:.3f} GiB)",
              flush=True)


def _step_loss_and_grads(cfg, pts, seed, **step_kw):
    """The loss of one train step (pinn.make_train_step with ``step_kw``)
    on the card from the weights of ``seed`` and the gradient it applied,
    the cells in the (N, C, *S) layout; vol-resident steps take the
    kernel layout and a plan of make_vol_plan."""
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              "cuda")
    pts = pts.cuda()
    args = ()
    if step_kw.get("vol_resident"):
        params = pinn.params_to_vol(params, cfg, pts.shape[0])
        args = (tfused.make_vol_plan(pts, (cfg.n_cells, cfg.cell_dim,
                                           *(cfg.cell_size,) * cfg.dim),
                                     cfg.sampler),)
    step = pinn.make_train_step(
        cfg, torch.optim.Adam(params.values(), lr=1e-3), **step_kw)
    loss = float(step(params, pts, *args))
    grads = {k: v.grad.detach().clone() for k, v in params.items()}
    if step_kw.get("vol_resident"):
        grads["cells"] = fused3b.vol_to_cells(grads["cells"])
    return loss, {k: v.cpu() for k, v in grads.items()}


def _bf16_phase(checked):
    """The fix of a fused op call at precision "bf16" raising on the card:
    such calls take the counted plain route, whose plain versions compute
    in f32, and agree with the same call at "exact" (loss rtol LOSS_RTOL,
    leaves GRAD_TOL): one fused op call (96 x 4 x 16^2, 100 000 points,
    the rows and the cells cotangent), one step of the 2D and 3D fused
    trainers (main paths), of the megakernel trainer (mega2w refuses
    bf16: autograd of the fused loss) and of the vol-resident trainer
    (16 x 4 x 32^3, 100 000 fixed points); each exact reading is taken
    through its kernels, with no plain launch."""
    cells, pts, g = _fused_inputs(N, C, (H, W), Q, seed=16)

    def op(precision):
        def run():
            leaf = cells.clone().requires_grad_(True)
            out = tfused.sample_features_with_derivs(
                leaf, pts, SamplerConfig(dim=2, precision=precision))
            loss = (out * g).sum()
            loss.backward()
            return float(loss), {"rows": out.detach().cpu(),
                                 "cells": leaf.grad.cpu()}
        return run

    _compare_losses("bf16 fused op on the card (plain route) vs exact",
                    checked("bf16 fused op", op("bf16")),
                    checked("exact fused op", op("exact"),
                            expect_plain=False))
    vol_cfg = pinn.PINNConfig(dim=3, n_cells=16, cell_size=32,
                              pde="helmholtz")
    for what, cfg, q, kw in [
            ("2D fused", pinn.PINNConfig(), Q, dict(fused=True)),
            ("3D fused", MODEL_3D, Q, dict(fused=True)),
            ("2D megakernel", pinn.PINNConfig(), Q, dict(megakernel=True)),
            ("vol-resident 16x4x32^3", vol_cfg, Q,
             dict(vol_resident=True))]:
        pts_t = _trainer_points(q, cfg.dim, seed=17)
        bf16 = dataclasses.replace(cfg, precision="bf16")
        got = checked(f"bf16 {what} trainer step",
                      lambda: _step_loss_and_grads(bf16, pts_t, 17, **kw))
        want = checked(f"exact {what} trainer step",
                       lambda: _step_loss_and_grads(cfg, pts_t, 17, **kw),
                       expect_plain=False)
        _compare_losses(f"bf16 {what} trainer step on the card (plain "
                        "route) vs exact", got, want)


def wide_time_phase():
    """B6 at path (a) (2D: 96 x 16 x 16^2, Q = 100 000) and B7 at path (b)
    (96 x 4 x 16^2, Q = 1024): kernel and plain ms in turns (CUDA events),
    bounds; B6 in 3D (50 x 16 x 16^3) printed beside."""
    times = {}
    cases = [("fused", "2D", SamplerConfig(dim=2), N, C_WIDE, (H, W), Q),
             ("fused", "3D", SamplerConfig(dim=3), N3, C_WIDE, (S3,) * 3, Q),
             ("fused2d", "2D", SamplerConfig(dim=2), N, C, (H, W), 1024),
             ("fused2w", "2D", SamplerConfig(dim=2), N, C_WIDE, (H, W), Q),
             ("fused3w", "3D", SamplerConfig(dim=3), N3, C_WIDE, (S3,) * 3,
              Q)]
    for kind, what, cfg, n, c, spatial, q in cases:
        mod = FUSED_MODS[kind]
        cells, pts, g = _fused_inputs(n, c, spatial, q, seed=18, lo=-1.0,
                                     hi=1.0)
        dim = len(spatial)
        rows = 1 + 2 * dim
        # rows x 2^d corners FMAs per (cell, channel, query): 20 in 2D, 56
        # in 3D; the blend reads cells and points and writes (rows, C, Q),
        # the bwd the other way round
        flops = 2 * rows * 2**dim * n * c * q
        nbytes = 4 * (n * c * math.prod(spatial) + dim * q + rows * c * q)
        bound_ms, bound_by = _bound(nbytes, flops)
        ops = {
            f"{kind}_blend": (lambda: mod.fused_blend(cells, pts, cfg),
                              lambda: mod.plain_fused_blend(cells, pts, cfg)),
            f"{kind}_bwd": (lambda: mod.fused_bwd(g, pts, spatial, cfg, n),
                            lambda: mod.plain_fused_bwd(g, pts, spatial, cfg,
                                                        n)),
        }
        for name, (kernel, plain) in ops.items():
            ms, plain_ms = _in_turns(kernel, plain,
                                     reps=5 if kind in ("fused", "fused2d")
                                     else 2)
            dev_ms = _device_ms(kernel)
            print(f"time {name} {what} ({n}x{c}x{'x'.join(map(str, spatial))},"
                  f" Q={q}): kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / ms:.1%} of it; no library call computes it",
                  flush=True)
            if name not in times and kind in ("fused", "fused2d"):
                times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=None)
    # mega2w at C = 16, its work counted as mega_fused3w_time_phase counts
    # it at C = 4
    gen = torch.Generator().manual_seed(20)
    cells = torch.rand((N, C_WIDE, H, W), generator=gen).cuda()
    pts = (torch.rand((Q, 2), generator=gen) * 2.2 - 1.1).cuda()
    mlp = _mlp(C_WIDE, HIDDEN, gen)
    main = SamplerConfig(dim=2)
    def kernel():
        return mega2w.mega2w_step(cells, *mlp, pts, main, "allen_cahn")
    ms, plain_ms = _in_turns(
        kernel, lambda: mega2w.plain_mega2w_step(cells, *mlp, pts, main,
                                                 "allen_cahn"), reps=5)
    bound_ms, bound_by = _bound(
        4 * (2 * N * C_WIDE * H * W + 2 * Q + 2 * (C_WIDE + 2) * HIDDEN + 3),
        2 * (2 * 5 * 4 * C_WIDE * N * Q)
        + 2 * Q * HIDDEN * (20 * C_WIDE + 40))
    print(f"time mega2w 2D ({N}x{C_WIDE}x{H}x{W}, Q={Q}, hidden {HIDDEN}): "
          f"kernel {ms:.4f} ms (device {_device_ms(kernel):.4f}), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of it; no library call computes it",
          flush=True)
    return times


def wide_step_phase():
    """Median step ms (CUDA events, 3 warm-up, 10 timed) of path (a): the
    2D and 3D fused steps and the megakernel step (mega2w) at C = 16."""
    for what, cfg, kw in [
            ("2D fused", pinn.PINNConfig(cell_dim=C_WIDE), {}),
            ("2D megakernel", pinn.PINNConfig(cell_dim=C_WIDE),
             dict(megakernel=True)),
            ("3D fused", pinn.PINNConfig(dim=3, n_cells=N3, cell_dim=C_WIDE,
                                         pde="helmholtz"), {})]:
        with PointGenerator(Q, cfg.dim, seed=19) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(13)]
        step_kw = kw or dict(fused=True)
        ms = _median_step_ms(cfg, batches, **step_kw)
        print(f"step wide C={C_WIDE} {what}: {ms:.4f} ms", flush=True)


# --- channel groups above 8 channels, fused3b's ghost path --------------------

# the channel counts of the rule's sweep above 8 channels
WIDE_CHANNELS = (12, 16)
# (dim, N, S, Q): the sweep's stacks and point counts at each of them
WIDE_SWEEP = ([(2, N, H, q) for q in (1024, 16384, Q)]
              + [(3, N3, S3, q) for q in (1024, 2048, 4096, 8192, 16384, Q)]
              + [(3, N5, S5, q)
                 for q in (4096, 8192, 16384, 32768, 65536, Q)])


def wide_kernel_phase():
    """fused2w's and fused3w's channel groups and the wide mega2w against
    their plain versions: path (a)'s shapes at C = 12 and 16 (96 x C x
    16^2, 50 x C x 16^3, Q = 100 000), C in {9, 32} and the v1 variants at
    C = 12 at small shapes, a channel group over the opted-in shared
    memory (global atomics); mega2w at 96 x 16 x 16^2 and at C up to
    JAX's 124 and in variants."""
    m2, m3 = SamplerConfig(dim=2), SamplerConfig(dim=3)
    for c in WIDE_CHANNELS:
        compare_fused("fused2w", f"C={c} path (a)", m2, N, c, (H, W), Q)
        compare_fused("fused3w", f"C={c} 3D path (a)", m3, N3, c, (S3,) * 3,
                      Q, seed=1)
    for dim, spatial in ((2, (12, 10)), (3, (7, 8, 9))):
        for c in (9, 32):
            compare_fused(f"fused{dim}w", f"channels-{c}",
                          SamplerConfig(dim=dim), 6, c, spatial, 4099,
                          seed=2, **WIDE)
        for name, kw, _ in FUSED_VARIANTS:
            compare_fused(f"fused{dim}w", f"C=12 {name}",
                          SamplerConfig(dim=dim, **kw), 6, 12, spatial, 2053,
                          seed=4, **WIDE)
    compare_fused("fused2w", "C=16 large-cell", m2, 2, 16, (128, 128), 4096,
                  seed=5)
    compare_fused("fused3w", "C=16 large-cell", m3, 2, 16, (32,) * 3, 4096,
                  seed=5)
    compare_bwd_planar_sides(2, 2, (128, 128), c=16)
    compare_bwd_planar_sides(3, 2, (32,) * 3, c=16)
    compare_mega(f"C={C_WIDE} path (a)", m2, N, C_WIDE, H, W, Q)
    for c in (9, 12, 32, 124):
        compare_mega(f"channels-{c}", m2, 8, c, 12, 10, 4099, seed=2)
    for name, kw, extra in [
            ("helmholtz-hidden-32", {}, dict(pde="helmholtz", hidden=32)),
            ("reflection-hidden-8", dict(padding_mode="reflection"),
             dict(hidden=8)),
            ("align-false-q-1000", dict(align_corners=False), {})]:
        compare_mega(f"C=16 {name}", SamplerConfig(dim=2, **kw), 8, 16, 12,
                     10, 1000 if "q-1000" in name else 4099, seed=3, **extra)
    compare_mega("C=16 large-cell", m2, 2, 16, 128, 128, 4096, seed=5)


def wide_route_sweep_phase():
    """Above 8 channels, fused2w's / fused3w's channel groups against the
    v1 pair, blend + bwd device ms (torch.profiler, 10 calls a window,
    v1, groups, groups, v1, the larger turn kept) at C = 12 and 16 over
    WIDE_SWEEP, inputs drawn on the card: the measurement behind
    route.fused_rule above 8 channels (fused2w / fused3w where their bwd
    adds in place, the v1 pair elsewhere; the two blends are one kernel
    there).  Prints how many points the rule sends to the slower of the
    two."""
    rows = []
    for c in WIDE_CHANNELS:
        for dim, n, s, q in WIDE_SWEEP:
            cfg = SamplerConfig(dim=dim)
            shape = (n, c, *(s,) * dim)
            gen = _cuda_gen(29)
            cells = torch.rand(shape, generator=gen, device="cuda")
            pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
            g = torch.randn((1 + 2 * dim, c, q), generator=gen,
                            device="cuda")
            groups = f"fused{dim}w"
            runs = {"fused": _pair(fused_v1, cells, pts, g, cfg),
                    groups: _pair(FUSED_MODS[groups], cells, pts, g, cfg)}
            turns = {k: [] for k in runs}
            for k in ("fused", groups, groups, "fused"):
                turns[k].append(_device_ms(runs[k], reps=10))
            ms = {k: max(v) for k, v in turns.items()}
            routed = route.fused_rule(cfg, shape, q)
            fastest = min(ms, key=ms.get)
            rows.append((shape, q, routed, fastest))
            print(f"sweep C>8 {dim}D ({'x'.join(map(str, shape))}, Q={q}): "
                  f"blend + bwd device ms v1 {ms['fused']:.4f} (turns "
                  f"{turns['fused'][0]:.4f} {turns['fused'][1]:.4f}), "
                  f"{groups} groups {ms[groups]:.4f} (turns "
                  f"{turns[groups][0]:.4f} {turns[groups][1]:.4f}); "
                  f"fastest {fastest}; the rule routes {routed}", flush=True)
            del cells, pts, g, runs
            torch.cuda.empty_cache()
    slower = [(shape, q) for shape, q, routed, fastest in rows
              if routed != fastest]
    print(f"sweep C>8: the rule routes {len(slower)} of {len(rows)} points "
          f"to the slower kernel {slower}", flush=True)


@contextlib.contextmanager
def _ghost_setting(name, value):
    """fused3b's module setting ``name`` (GHOST_ROUTE, GHOST_BUDGET_BYTES)
    set to ``value`` while the block runs, then restored."""
    old = getattr(fused3b, name)
    setattr(fused3b, name, value)
    try:
        yield
    finally:
        setattr(fused3b, name, old)


def compare_ghost(name, cfg, n, c, spatial, q, seed=0, lo=-1.2, hi=1.2,
                  pts=None, rb=fused3b.GHOST_RB):
    """The ghost pair (kernel and fold) against plain_fused3b_bwd_vol and
    plain_fused3b_bwd_ghost_vol on the card, the volume as one row; two
    runs' max difference (not bit-deterministic: the bricks' shared
    atomics).  Returns (max abs error, run-to-run difference)."""
    _, _, pts, plan = _vol_case(n, c, spatial, q, seed, lo, hi, cfg, pts)
    g_p = torch.randn((7, c, plan[1].shape[0]), generator=_cuda_gen(seed + 1),
                      device="cuda")
    got = fused3b.fused3b_bwd_ghost_vol(g_p, plan, spatial, cfg, n, rb)
    again = fused3b.fused3b_bwd_ghost_vol(g_p, plan, spatial, cfg, n, rb)
    ref = fused3b.plain_fused3b_bwd_vol(g_p, plan, spatial, cfg, n)
    ref_ghost = fused3b.plain_fused3b_bwd_ghost_vol(g_p, plan, spatial, cfg,
                                                    n, rb)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"ghost {name}: wrong shape or non-finite output")
    abs_e, rel = _rel_err(got.reshape(1, -1), ref.reshape(1, -1))
    _, rel_g = _rel_err(got.reshape(1, -1), ref_ghost.reshape(1, -1))
    det = float((got - again).abs().max())
    print(f"compare fused3b_bwd_ghost {name} ({n}x{c}x"
          f"{'x'.join(map(str, spatial))}, Q={q}, rb={rb}): max abs err "
          f"{abs_e:.3e}, rel {rel:.3e} vs plain_fused3b_bwd_vol, rel "
          f"{rel_g:.3e} vs plain_fused3b_bwd_ghost_vol (tolerance rel "
          f"{REL_TOL:g}); two runs differ by at most {det:.3e}", flush=True)
    if not (rel <= REL_TOL and rel_g <= REL_TOL):
        raise RuntimeError(f"ghost {name}: kernel disagrees with the plain "
                           "versions")
    return abs_e, det


def fused3b_ghost_kernel_phase():
    """fused3b's ghost path at config 5 (the vol-resident trainer's
    1 000 000 points and plan) and in variants (the three padding modes at
    rb 1 and 8, 9 and 16 channels, a non-cubic volume); at C = 16 on
    config 5's volume the bricks are over GHOST_BUDGET_BYTES and
    fused3b_bwd_vol(ghost=True) takes fused3b_bwd (counted), as JAX's
    budget sends it to its serialized kernel."""
    main = SamplerConfig(dim=3)
    err, det = compare_ghost("config-5", main, N5, C, (S5,) * 3, Q5,
                             pts=_trainer_points(Q5, 3))
    for padding in ("zeros", "border", "reflection"):
        for rb in (1, 8):
            compare_ghost(padding, SamplerConfig(dim=3, padding_mode=padding),
                          6, 3, (9, 9, 9), 4099, seed=2, rb=rb, lo=-1.4,
                          hi=1.4)
    compare_ghost("channels-16", main, 6, 16, (9, 9, 9), 4099, seed=3)
    compare_ghost("non-cubic-channels-9", main, 6, 9, (20, 28, 36), 8192,
                  seed=4)
    shape = fused3b.vol_layout(N5, C_WIDE, (S5,) * 3)
    if fused3b.ghost_fits(main, shape):
        raise RuntimeError("config 5 at C = 16 should be over the ghost "
                           "budget")
    _, vol, pts, plan = _vol_case(N5, C_WIDE, (S5,) * 3, Q5, 6, cfg=main,
                                  pts=_trainer_points(Q5, 3))
    del vol
    g_p = torch.randn((7, C_WIDE, plan[1].shape[0]), generator=_cuda_gen(7),
                      device="cuda")
    _reset_counts()
    got = fused3b.fused3b_bwd_vol(g_p, plan, (S5,) * 3, main, N5, ghost=True)
    counts = _counts()
    print(f"ghost at config 5 with C = {C_WIDE}: "
          f"{fused3b.GHOST_RB}-bin bricks over the {fused3b.GHOST_BUDGET_BYTES}"
          f"-byte budget; fused3b_bwd_vol(ghost=True) launched "
          f"{_nonzero(counts)}", flush=True)
    if counts["fused3b_bwd"] != 1 or counts["fused3b_bwd_ghost"] != 0:
        raise RuntimeError("over the budget the ghost route must take "
                           "fused3b_bwd")
    del got, g_p, plan
    torch.cuda.empty_cache()
    return {"fused3b_bwd_ghost": err}, det


def ghost_time_phase():
    """The ghost pair at config 5 (1 000 000 points) against fused3b_bwd in
    turns (fused3b_bwd, ghost, ghost, fused3b_bwd) at rb 1, 2, 4 and 8 (the
    measurement behind fused3b.GHOST_RB), with its plan, bricks and fold
    timed apart; at 16 channels with the budget lifted for the
    measurement; the plain version's time; the bound of fused3b_bwd's
    work (the same function)."""
    cfg = SamplerConfig(dim=3)
    spatial = (S5,) * 3
    pts = _trainer_points(Q5, 3)
    times = {}
    for c in (C, C_WIDE):
        plan = tfused.make_vol_plan(pts, (N5, c, *spatial), cfg)
        qp = plan[1].shape[0]
        g_p = torch.randn((7, c, qp), generator=_cuda_gen(17), device="cuda")
        plan_bytes = 4 * (3 * Q5 + qp + plan[4].numel())
        bound_ms, bound_by = _bound(
            4 * 7 * c * Q5 + plan_bytes + 4 * N5 * c * S5 ** 3,
            2 * 7 * 8 * c * N5 * Q5)
        for rb in ((1, 2, 4, 8) if c == C else (fused3b.GHOST_RB,)):
            def serial():
                return fused3b.fused3b_bwd_vol(g_p, plan, spatial, cfg, N5,
                                               ghost=False)

            def ghost():
                return fused3b.fused3b_bwd_ghost_vol(g_p, plan, spatial, cfg,
                                                     N5, rb)
            with _ghost_setting("GHOST_BUDGET_BYTES", 1 << 40):
                gplan = fused3b.ghost_plan(plan, spatial, rb)
                bricks = fused3b.ghost_bricks(g_p, plan, gplan, spatial, cfg,
                                              N5, rb)
                s1, g1, g2, s2 = (_time_ms(f, 5) for f in (serial, ghost,
                                                           ghost, serial))
                plan_ms = _time_ms(
                    lambda: fused3b.ghost_plan(plan, spatial, rb), 5)
                bricks_ms = _time_ms(
                    lambda: fused3b.ghost_bricks(g_p, plan, gplan, spatial,
                                                 cfg, N5, rb), 5)
                fold_ms = _time_ms(
                    lambda: fused3b.fold_bricks(bricks, gplan[3], spatial,
                                                cfg, rb), 5)
            ms = (g1 + g2) / 2
            print(f"time fused3b_bwd_ghost at config 5 ({N5}x{c}x{S5}^3, "
                  f"Q={Q5}, rb={rb}, bricks "
                  f"{4 * bricks.numel() / 1e9:.3f} GB): {ms:.4f} ms (turns "
                  f"{g1:.4f} {g2:.4f}; ghost_plan {plan_ms:.4f}, bricks "
                  f"{bricks_ms:.4f}, fold {fold_ms:.4f}) vs fused3b_bwd "
                  f"{(s1 + s2) / 2:.4f} ms (turns {s1:.4f} {s2:.4f}); bound "
                  f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of "
                  "it", flush=True)
            del bricks
            torch.cuda.empty_cache()
            if c == C and rb == fused3b.GHOST_RB:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fused3b.plain_fused3b_bwd_ghost_vol(g_p, plan, spatial, cfg,
                                                    N5, rb)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                times["fused3b_bwd_ghost"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, bricks_ms=bricks_ms,
                    fold_ms=fold_ms, fused3b_bwd_ms=(s1 + s2) / 2)
        del g_p, plan
        torch.cuda.empty_cache()
    return times


def ghost_trainer_phase():
    """The vol-resident trainer at config 5 with the ghost route on
    (fused3b.GHOST_ROUTE), 3 steps: one fused3b_blend and one
    fused3b_bwd_ghost launch a step and no other kernel, its losses those
    of vol_trainer_phase's first steps (the first at rtol LOSS_RTOL, each
    within GRAD_TOL)."""
    steps = 3
    with _ghost_setting("GHOST_ROUTE", True):
        launches, losses = _train_checked(
            f"vol-resident {N5}x{C}x{S5}^3, {Q5} points, ghost route",
            TrainConfig(model=MODEL_5, device="cuda", batch_points=Q5,
                        steps=steps, log_every=1, seed=0, vol_resident=True),
            steps, ("fused3b_blend", "fused3b_bwd_ghost"), decrease=False)
    if launches["fused3b_bwd_ghost"] != steps:
        raise RuntimeError(f"expected {steps} ghost launches")
    ref = vol_trainer_phase.losses[:steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"ghost vs fused3b_bwd vol-resident trainer losses: worst rel diff "
          f"{max(rel):.3e}, first {rel[0]:.3e}", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError("the ghost and fused3b_bwd trainers disagree")
    return launches


def _profiled_steps(cfg, batches):
    """(median step ms, device ms a step, device operations a step) of the
    nested step over ``batches``: 1 warm-up step, the rest timed with CUDA
    events, then profiled (torch.profiler)."""
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    step = pinn.make_train_step(cfg, torch.optim.Adam(params.values(),
                                                      lr=1e-3))
    step(params, batches[0])
    times = []
    for pts in batches[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, pts)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for pts in batches[1:]:
            step(params, pts)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    n = len(batches) - 1
    return (statistics.median(times),
            sum(e.self_device_time_total for e in events) / 1e3 / n,
            sum(e.count for e in events) / n)


def nested_ops_phase():
    """The nested 2D step (96 x 4 x 16^2, 100 000 points) and the nested
    128^3 step (100 000 points, the rule's route): median ms and device
    operations a step."""
    for what, cfg, q, dim, count in [
            ("2D", pinn.PINNConfig(), Q, 2, 6),
            ("128^3", MODEL_NV, QN, 3, 3)]:
        with PointGenerator(q, dim, seed=33) as gen:
            batches = [torch.from_numpy(gen.batch(i)).cuda()
                       for i in range(count)]
        ms, dev_ms, ops = _profiled_steps(cfg, batches)
        print(f"step nested {what}: median {ms:.4f} ms, device "
              f"{dev_ms:.4f} ms and {ops:.0f} device operations a step",
              flush=True)
        del batches
        torch.cuda.empty_cache()


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


# blend_o / splat_o launches of one nested step, 2D and 3D (pinned on the
# CPU by tests/test_torch_port_cotangents.py), and before the unread
# cotangents were skipped
NESTED_LAUNCHES = {2: (9, 9), 3: (40, 40)}
NESTED_LAUNCHES_BEFORE = {2: (27, 13), 3: (160, 53)}


def _check_nested_launches(what, dim, blends, splats):
    want = NESTED_LAUNCHES[dim]
    print(f"{what}: {blends:g} blends and {splats:g} splats a step "
          f"(expected {want[0]} and {want[1]}; {NESTED_LAUNCHES_BEFORE[dim]} "
          f"when every cotangent was computed)", flush=True)
    if (blends, splats) != want:
        raise RuntimeError(f"{what}: a step launched {blends:g} blends and "
                           f"{splats:g} splats, not {want}")


def nested_trainer_phase():
    """The nested-autograd trainer (fused=False) at full width, with its
    blend_o / splat_o launches a step checked."""
    launches = _train_checked(
        f"nested {N}x{C}x{H}x{W}, {Q} points",
        TrainConfig(device="cuda", fused=False, steps=NESTED_STEPS,
                     log_every=1, seed=0), NESTED_STEPS,
        ("blend_o", "splat_o"))[0]
    _check_nested_launches("nested 2D trainer", 2,
                           launches["blend_o"] / NESTED_STEPS,
                           launches["splat_o"] / NESTED_STEPS)
    return launches


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
    step each (the rule's route at 100 000 points)."""
    if route.fused_rule(MODEL_3D.sampler, (N3, C, S3, S3, S3), Q) != "fused3w":
        raise RuntimeError("the 3D main path should route to fused3w")
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
    query-ordered fused trainer's on the same fixed points (through the
    rule's route there, fused3s), the first at rtol LOSS_RTOL and each
    within GRAD_TOL relative.  Then card vs CPU at 5 x 3 x 6^3, Q = 120."""
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
    kind = route.fused_rule(MODEL_5.sampler, (N5, C, S5, S5, S5), Q5)
    if (ref_launches[f"{kind}_blend"] != STEPS_VOL
            or ref_launches["fused3b_blend"] != 0):
        raise RuntimeError(f"the query-ordered trainer took another route "
                           f"than {kind}: {_nonzero(ref_launches)}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    print(f"vol-resident vs query-ordered ({kind}) trainer losses on the same "
          f"fixed points: {' '.join(f'{v:.8g}' for v in ref)} ({kind}); "
          f"worst rel diff {max(rel):.3e}, first {rel[0]:.3e}; the "
          f"(D, H, W, N, C) volume has no pad slots", flush=True)
    if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
        raise RuntimeError(f"vol-resident and {kind} trainers disagree")
    vol_trainer_phase.losses = losses
    cfg = pinn.PINNConfig(dim=3, n_cells=5, cell_dim=3, cell_size=6,
                          pde="helmholtz")
    with PointGenerator(120, 3, seed=7) as gen:
        pts = torch.from_numpy(gen.batch(0))
    _compare_losses("reference vol-resident: fused3b on the card vs plain "
                    "CPU (5x3x6^3, Q=120)",
                    _vol_loss_and_grads(cfg, "cuda", pts, 7),
                    _vol_loss_and_grads(cfg, "cpu", pts, 7))
    return launches


MODEL_NV = pinn.PINNConfig(dim=3, n_cells=N5, cell_size=S5, pde="helmholtz")
# the kernels of each route, blend then splat
ROUTE_KERNELS = {"blend_o": ("blend_o", "splat_o"),
                 "percell": ("percell_blend", "percell_splat"),
                 "slab": ("slab_blend", "slab_splat")}
SAMPLER_KERNELS = {k for pair in ROUTE_KERNELS.values() for k in pair}


def _expected(cfg, cells_shape, n_pairs):
    """The kernels route.rule sends a chain's blends and splats to."""
    return ROUTE_KERNELS[route.rule(cfg, cells_shape, n_pairs)]


def _check_route(what, launches, expected):
    """Each expected sampler kernel launched, no other sampler kernel."""
    got = {k for k, v in launches.items() if v and k in SAMPLER_KERNELS}
    if got != set(expected):
        raise RuntimeError(f"{what}: launched {sorted(got)}, the rule gives "
                           f"{sorted(expected)}")


@contextlib.contextmanager
def _routed(name):
    """Every blend_o / splat_o call of the sampler routed to ``name``
    while the block runs (route.pick replaced, then restored)."""
    pick = route.pick
    route.pick = lambda *args: name
    try:
        yield
    finally:
        route.pick = pick


def nested_vol_trainer_phase():
    """The nested 3D trainer on config 5's volume (16 x 4 x 128^3, 100 000
    fresh points a step), 3 steps through the routed kernels and no other
    (one slab bins or percell plan a step), then the same steps with
    every call routed to the other over-budget route and to blend_o /
    splat_o: the losses of each against blend_o's, the first at rtol
    LOSS_RTOL, each within GRAD_TOL.  Returns the launches of both
    over-budget routes' runs."""
    def cfg():
        return TrainConfig(model=MODEL_NV, device="cuda", fused=False,
                           batch_points=QN, steps=STEPS_NESTED_VOL,
                           log_every=1, seed=0)

    shape = (N5, C, *(S5,) * 3)
    routed = route.rule(MODEL_NV.sampler, shape, N5 * QN)
    other = "percell" if routed == "slab" else "slab"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    make_bins = slab.make_bins.launches
    launches, losses = _train_checked(
        f"nested 3D {N5}x{C}x{S5}^3, {QN} points", cfg(), STEPS_NESTED_VOL,
        ROUTE_KERNELS[routed], decrease=False)
    bins_built = slab.make_bins.launches - make_bins
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    blend, splat = ROUTE_KERNELS[routed]
    _check_nested_launches(f"nested 128^3 trainer ({routed})", 3,
                           launches[blend] / STEPS_NESTED_VOL,
                           launches[splat] / STEPS_NESTED_VOL)
    print(f"nested 128^3 trainer ({routed}): slab bins built {bins_built} "
          f"times in {STEPS_NESTED_VOL} steps", flush=True)
    if bins_built != (STEPS_NESTED_VOL if routed == "slab" else 0):
        raise RuntimeError("the nested trainer built other than one set of "
                           "slab bins a step")
    runs = {routed: losses}
    with _routed(other):
        more, runs[other] = _train_checked(
            f"nested 3D {N5}x{C}x{S5}^3, {QN} points, routed to {other}",
            cfg(), STEPS_NESTED_VOL, ROUTE_KERNELS[other], decrease=False)
    launches.update({k: more[k] for k in ROUTE_KERNELS[other]})
    with _routed("blend_o"):
        _, ref = _train_checked(
            f"nested 3D {N5}x{C}x{S5}^3, {QN} points, routed to blend_o",
            cfg(), STEPS_NESTED_VOL, ("blend_o", "splat_o"), decrease=False)
    for name, run in runs.items():
        rel = [abs(a - b) / abs(b) for a, b in zip(run, ref)]
        print(f"nested 128^3 trainer: {name} vs blend_o / splat_o losses "
              f"{' '.join(f'{v:.8g}' for v in ref)} (blend_o); worst rel "
              f"diff {max(rel):.3e}, first {rel[0]:.3e}", flush=True)
        if rel[0] > LOSS_RTOL or max(rel) > GRAD_TOL:
            raise RuntimeError(f"the {name} and blend_o nested trainers "
                               "disagree")
    print(f"nested 128^3 trainer ({routed}): peak device memory {peak:.3f} "
          f"GiB", flush=True)
    return launches


def _per_cell_chain(x, grid, w, axis):
    """u_ax, u_axax (per pair) and u_axax_cell of u = w . sample(cells,
    grid) by nested autograd, on the tensors' device."""
    cells = x.detach().requires_grad_(True)
    g = grid.detach().requires_grad_(True)
    out = sample(cells, g, SamplerConfig(dim=3))
    u = torch.einsum("ncq,c->nq", out.reshape(*out.shape[:2], -1), w)
    (g1,) = torch.autograd.grad(u.sum(), g, create_graph=True)
    (g2,) = torch.autograd.grad(g1[..., axis].sum(), g, create_graph=True)
    (g3,) = torch.autograd.grad(g2[..., axis].sum(), cells)
    return [t.detach().cpu() for t in (g1[..., axis], g2[..., axis], g3)]


def per_cell_chain_phase():
    """The per-cell surface's u_z -> u_zz -> u_zz_cell chain (4 x 4 x 128^3
    cells, per-cell 16^3 grids) on the card, through the routed kernels
    only, against the same chain on the CPU (plain versions): each
    output within GRAD_TOL of its largest magnitude."""
    x, grid, _ = _per_cell_inputs(3, NP, (SP,) * 3, (GP,) * 3, 29)
    w = torch.tensor([0.7, -0.3, 0.5, 1.1], device="cuda")
    _reset_counts()
    card = _per_cell_chain(x, grid, w, 2)
    launches = {k: v for k, v in _counts().items() if v}
    cpu = _per_cell_chain(x.cpu(), grid.cpu(), w.cpu(), 2)
    errs = [_rel_err(a.reshape(1, -1), b.reshape(1, -1))[1]
            for a, b in zip(card, cpu)]
    print(f"per-cell chain ({NP}x{C}x{SP}^3, per-cell {GP}^3 grids): card vs "
          f"CPU rel err u_z {errs[0]:.3e}, u_zz {errs[1]:.3e}, u_zz_cell "
          f"{errs[2]:.3e} (tolerance {GRAD_TOL:g}); launches {launches}",
          flush=True)
    if max(errs) > GRAD_TOL:
        raise RuntimeError("per-cell chain: card and CPU disagree")
    _check_route("per-cell chain", launches,
                 _expected(SamplerConfig(dim=3), tuple(x.shape),
                           NP * GP ** 3))
    return launches


def sparse_and_2d_phase():
    """The per-cell surface's sparse case (2^3 points a cell), the 2D
    volume (4 x 4 x 1024^2, per-cell 128^2 grids) and a stack over L2 of
    small cells (1024 x 4 x 16^3, per-cell 1024 points, 2^20 pairs):
    sample() and the cell gradient of a quadratic loss on the card,
    through the routes the rule gives them, against the plain versions on
    the card (backend='xla').  Returns the launches of each."""
    out = {}
    for what, dim, n, spatial, grid_out in (
            ("sparse", 3, NP, (SP,) * 3, (GP_SPARSE,) * 3),
            ("2d", 2, NP, (S2D,) * 2, (G2D,) * 2),
            ("small-cells", 3, NS, (SS,) * 3, (1, 1, GS))):
        x, grid, _ = _per_cell_inputs(dim, n, spatial, grid_out, 30)
        res = {}
        _reset_counts()
        for backend in ("auto", "xla"):
            cells = x.clone().requires_grad_(True)
            u = sample(cells, grid, SamplerConfig(dim=dim,
                                                       backend=backend))
            (u ** 2).sum().backward()
            res[backend] = (u.detach(), cells.grad)
            if backend == "auto":
                launches = {k: v for k, v in _counts().items() if v}
        errs = [_rel_err(a.reshape(1, -1), b.reshape(1, -1))[1]
                for a, b in zip(res["auto"], res["xla"])]
        print(f"{what} ({n}x{C}x{'x'.join(map(str, spatial))}, per-cell "
              f"{'x'.join(map(str, grid_out))}): sample and cell gradient "
              f"vs plain rel err {errs[0]:.3e}, {errs[1]:.3e}; launches "
              f"{launches}", flush=True)
        if max(errs) > REL_TOL:
            raise RuntimeError(f"{what}: kernels and plain versions disagree")
        _check_route(what, launches,
                     _expected(SamplerConfig(dim=dim), tuple(x.shape),
                               n * math.prod(grid_out)))
        out[what] = launches
    return out


def nested_vol_step_phase():
    """Median ms of the nested 128^3 train step (fresh points, CUDA events,
    1 warm-up and 3 timed steps) with every call routed to slab, to
    percell and to blend_o / splat_o, in turns."""
    with PointGenerator(QN, 3, seed=31) as gen:
        batches = [torch.from_numpy(gen.batch(i)).cuda() for i in range(4)]
    kinds = ("slab", "percell", "blend_o")
    runs = []
    for kind, steps in [(k, batches) for k in kinds + kinds[::-1]]:
        with _routed(kind):
            params = pinn.init_params(torch.Generator().manual_seed(0),
                                      MODEL_NV, "cuda")
            step = pinn.make_train_step(
                MODEL_NV, torch.optim.Adam(params.values(), lr=1e-3))
            step(params, steps[0])
            times = []
            for pts in steps[1:]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step(params, pts)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        runs.append((kind, statistics.median(times)))
        del params, step
        torch.cuda.empty_cache()
    for kind in kinds:
        ms = [m for k, m in runs if k == kind]
        print(f"step nested 128^3 routed to {kind}: "
              f"{sum(ms) / len(ms):.2f} ms (turns "
              f"{' '.join(f'{m:.2f}' for m in ms)})", flush=True)


def launch_breakdown_phase():
    """One nested step's launches, split at the backward to the params (as
    the train step runs it): the loss (u and the two autograd.grad calls
    to the points) launches blends only, no splat to the cells, whose
    cotangent those calls drop; the backward launches no blend for the
    points' cotangent, which nothing reads."""
    cfg = pinn.PINNConfig()
    params = pinn.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    with PointGenerator(Q, 2, seed=9) as gen:
        pts = torch.from_numpy(gen.batch(0)).cuda()
    _reset_counts()
    loss = pinn.loss(params, pts, cfg)
    fwd = _counts()
    _reset_counts()
    loss.backward(inputs=list(params.values()))
    bwd = _counts()
    print(f"launches of one nested step: loss (u and the two autograd.grad "
          f"calls) blend_o {fwd['blend_o']}, splat_o {fwd['splat_o']}; "
          f"backward to the params blend_o {bwd['blend_o']}, splat_o "
          f"{bwd['splat_o']}", flush=True)
    if (fwd["splat_o"], bwd["blend_o"]) != (0, 0):
        raise RuntimeError("a nested step launched a kernel for a cotangent "
                           "nothing reads")


def _loss_and_grads(loss_fn, cfg, device, pts, seed):
    params = pinn.init_params(torch.Generator().manual_seed(seed), cfg,
                              device)
    loss = loss_fn(params, pts.to(device), cfg)
    loss.backward()
    return float(loss.detach()), {k: v.grad.cpu() for k, v in params.items()}


def _losses_agree(what, a, b):
    """Print two (loss, grads) readings side by side; whether they agree
    to LOSS_RTOL and GRAD_TOL."""
    (l_a, g_a), (l_b, g_b) = a, b
    worst = max(float((g_a[k] - g_b[k]).abs().max()
                      / g_b[k].abs().max().clamp_min(1e-30)) for k in g_b)
    print(f"{what}: loss {l_a:.8g} vs {l_b:.8g} (rel "
          f"{abs(l_a - l_b) / max(abs(l_b), 1e-30):.3e}); worst gradient "
          f"leaf rel err {worst:.3e} (tolerances loss rtol {LOSS_RTOL:g}, "
          f"leaf {GRAD_TOL:g} of its largest magnitude)", flush=True)
    return abs(l_a - l_b) <= LOSS_RTOL * abs(l_b) and worst <= GRAD_TOL


def _compare_losses(what, a, b):
    if not _losses_agree(what, a, b):
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
    kind = route.fused_rule(cfg3.sampler, (8, C, S3, S3, S3), 4096)
    _compare_losses(f"reference fused 3D: {kind} on the card vs plain CPU",
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
    # blend_o at the 3D main shape (the nested 3D step's 40 launches)
    cfg3 = SamplerConfig(dim=3)
    x, grid, _ = _v1_inputs(3, N3, C, (S3,) * 3, Q, seed=11)
    ms3, plain3 = _in_turns(lambda: blend_splat.blend(x, grid, cfg3, (0,) * 3),
                            lambda: blend_splat.plain_blend(x, grid, cfg3,
                                                            (0,) * 3))
    bound3 = _bound(4 * (N3 * C * S3 ** 3 + 3 * Q + N3 * C * Q),
                    2 * 8 * C * N3 * Q)
    times["blend_o"].update(ms_3d=ms3, plain_ms_3d=plain3,
                            bound_ms_3d=bound3[0],
                            library_ms_3d=lib[("blend_o", 3)][1],
                            ms_3d_at_library_setting=lib[("blend_o", 3)][0])
    print(f"time blend_o at the 3D main shape ({N3}x{C}x{S3}^3, Q={Q}, "
          f"cosine, multicell, order 0): kernel {ms3:.4f} ms, plain "
          f"{plain3:.4f} ms, bound {bound3[0]:.4f} ms ({bound3[1]}), "
          f"{bound3[0] / ms3:.1%} of it", flush=True)
    for name, t in times.items():
        t["library_ms"] = lib[(name, 2)][1]
        t["ms_at_library_setting"] = lib[(name, 2)][0]
        print(f"time {name} at the main shape (cosine, multicell, order 0): "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), "
              f"{t['bound_ms'] / t['ms']:.1%} of it", flush=True)
    return times


def _with_q_blocks(geom, q_blocks, q):
    qpb = -(-q // q_blocks)
    return geom._replace(q_per_block=qpb, q_blocks=-(-q // qpb))


def splat_sweep_phase():
    """The measurement behind blend_splat.splat_geometry: splat_o at the 2D
    and 3D main paths' shapes (shared points, order 0) over launch
    geometries, each held to the rule's output and timed in turns: the
    rule's, half and twice its query blocks, half its lanes, and the first
    design's geometry (12 cells of lanes on queries in 66 query blocks; 3D
    one cell in 11)."""
    for dim, n, spatial, parent in ((2, N, (H, W), (12, 66)),
                                    (3, N3, (S3,) * 3, (1, 11))):
        cfg = SamplerConfig(dim=dim)
        _, grid, gout = _v1_inputs(dim, n, C, spatial, Q, seed=13)
        o = (0,) * dim
        rule = blend_splat.splat_geometry(n, C, spatial, Q)
        cell = C * math.prod(spatial)
        geoms = {
            "rule": rule,
            "half the query blocks": _with_q_blocks(
                rule, max(1, rule.q_blocks // 2), Q),
            "twice the query blocks": _with_q_blocks(
                rule, 2 * rule.q_blocks, Q),
            "first design's": _with_q_blocks(blend_splat.SplatGeometry(
                parent[0], 1, cell, Q, 1), parent[1], Q),
        }
        if rule.lanes > 1:
            half = rule.lanes // 2
            geoms["half the lanes"] = _with_q_blocks(
                rule._replace(cells=half, lanes=half), 2 * rule.q_blocks, Q)
        want = blend_splat.launch_splat(gout, grid, cfg, spatial, o, rule)
        runs = {}
        for name, geom in geoms.items():
            fn = functools.partial(blend_splat.launch_splat, gout, grid, cfg,
                                   spatial, o, geom)
            _, err = _rel_err(fn().reshape(1, -1), want.reshape(1, -1))
            if not err <= REL_TOL:
                raise RuntimeError(f"splat_o {dim}D {name} geometry: "
                                   f"disagrees with the rule's ({err:.3e})")
            runs[name] = fn
        ms = {k: [] for k in runs}
        for k in list(runs) + list(runs)[::-1]:
            ms[k].append(_time_ms(runs[k], 10))
        print(f"splat_o sweep {dim}D ({n}x{C}x{'x'.join(map(str, spatial))}, "
              f"Q={Q}): " + "; ".join(
                  f"{k} {tuple(geoms[k])} {sum(v) / 2:.4f} ms"
                  for k, v in ms.items()), flush=True)
        del grid, gout, want
        torch.cuda.empty_cache()


def _sweep(what, runs, geoms, want, reps=10, timer=None):
    """Each of ``runs`` held to ``want`` within REL_TOL, then timed in turns
    (the list, then reversed) by ``timer(fn, reps)`` (CUDA events around
    ``reps`` calls by default); prints and returns each geometry's ms."""
    timer = timer or _time_ms
    for name, fn in runs.items():
        _, err = _rel_err(fn().reshape(1, -1), want.reshape(1, -1))
        if not err <= REL_TOL:
            raise RuntimeError(f"{what} {name} geometry: disagrees with the "
                               f"rule's ({err:.3e})")
    ms = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        ms[k].append(timer(runs[k], reps))
    print(f"{what}: " + "; ".join(f"{k} {tuple(geoms[k])} {sum(v) / 2:.4f} ms"
                                  for k, v in ms.items()), flush=True)
    return {k: sum(v) / 2 for k, v in ms.items()}


def blend_sweep_phase():
    """The measurement behind blend_splat.blend_geometry: blend_o at the 2D
    and 3D main paths' shapes (shared points, order 0) over launch
    geometries, each held to the rule's output and timed in turns: the
    rule's, channel planes instead of interleaved channels, half and twice
    its query blocks, twice and half the cells a block (2D), and the
    unstaged kernel (the design before staging); and staged against
    unstaged on the stack
    of 1024 x 4 x 16^3 cells at 256, 1024 and 4096 per-cell queries."""
    for dim, n, spatial in ((2, N, (H, W)), (3, N3, (S3,) * 3)):
        cfg = SamplerConfig(dim=dim)
        x, grid, _ = _v1_inputs(dim, n, C, spatial, Q, seed=13)
        o = (0,) * dim
        rule = blend_splat.blend_geometry(n, C, spatial, Q)
        geoms = {
            "rule": rule,
            "channel planes": rule._replace(interleave=False),
            "half the query blocks": rule._replace(
                q_blocks=max(1, rule.q_blocks // 2)),
            "twice the query blocks": rule._replace(
                q_blocks=2 * rule.q_blocks),
            "unstaged": blend_splat.BlendGeometry(
                0, False, C * math.prod(spatial), 1),
        }
        if rule.cells > 1:
            geoms["twice the cells"] = rule._replace(
                cells=2 * rule.cells, q_blocks=max(1, rule.q_blocks // 2))
            geoms["half the cells"] = rule._replace(
                cells=rule.cells // 2, q_blocks=2 * rule.q_blocks)
        runs = {k: functools.partial(blend_splat.launch_blend, x, grid, cfg,
                                     o, g) for k, g in geoms.items()}
        _sweep(f"blend_o sweep {dim}D ({n}x{C}x"
               f"{'x'.join(map(str, spatial))}, Q={Q})", runs, geoms,
               runs["rule"]())
        del x, grid
        torch.cuda.empty_cache()
    # the staging bound (STAGE_QUERIES_PER_TEXEL) on the route sweep's
    # stack of small cells over L2, 256, 1024 and 4096 per-cell queries
    # (2^18, 2^20 and 2^22 pairs): staged and unstaged
    cfg = SamplerConfig(dim=3)
    for q in (256, 1024, 4096):
        x, grid, _ = _per_cell_inputs(3, NS, (SS,) * 3, (1, 1, q), 28)
        geoms = {"rule": blend_splat.blend_geometry(NS, C, (SS,) * 3, q),
                 "staged": blend_splat.BlendGeometry(1, True, C * SS ** 3, 1),
                 "unstaged": blend_splat.BlendGeometry(0, False, C * SS ** 3,
                                                       1)}
        runs = {k: functools.partial(blend_splat.launch_blend, x, grid, cfg,
                                     (0, 0, 0), g) for k, g in geoms.items()}
        _sweep(f"blend_o sweep 3D per-cell ({NS}x{C}x{SS}^3, Q={q} a cell)",
               runs, geoms, runs["rule"]())
        del x, grid
        torch.cuda.empty_cache()


def scatter_sweep_phase():
    """The measurement behind scatter.scatter_geometry: fused3b_bwd at
    config 5 (the trainer's 1 000 000 points and plan) at C = 4, 8, 12
    and 16 (the two sides of scatter.FULL_BLOCKS_PER_SM), and fused3s_bwd
    on config 5's volume at 100 000 and 1 000 000 fresh points, each over
    the layouts of scatter.scatter_alternatives, each held to the rule's
    result and timed in turns; the wrapper's zero fill (and fused3s's
    transpose) included, the z sort made once outside."""
    cfg = SamplerConfig(dim=3)
    spatial = (S5,) * 3
    pts5 = _trainer_points(Q5, 3)
    for c in (C, 8, 12, C_WIDE):
        plan = tfused.make_vol_plan(pts5, (N5, c, *spatial), cfg)
        g_p = torch.randn((7, c, plan[1].shape[0]), generator=_cuda_gen(40),
                          device="cuda")
        geoms = scatter.scatter_alternatives(N5, c)
        runs = {k: functools.partial(fused3b.launch_bwd, g_p, plan, spatial,
                                     cfg, N5, v) for k, v in geoms.items()}
        _sweep(f"fused3b_bwd scatter sweep (config 5, {N5}x{c}x{S5}^3, "
               f"Q={Q5})", runs, geoms, runs["rule"](), reps=5)
        del plan, g_p, runs
        torch.cuda.empty_cache()
    for q in (Q, Q5):
        gen = _cuda_gen(41)
        pts = torch.rand((q, 3), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((7, C, q), generator=gen, device="cuda")
        order = fused3s.zsort(pts, S5, cfg)
        geoms = scatter.scatter_alternatives(N5, C, dense=True)
        runs = {k: functools.partial(fused3s.launch_bwd, g, pts, spatial,
                                     cfg, N5, order, v)
                for k, v in geoms.items()}
        _sweep(f"fused3s_bwd scatter sweep ({N5}x{C}x{S5}^3, Q={q})", runs,
               geoms, runs["rule"](), reps=5)
        del pts, g, order, runs
        torch.cuda.empty_cache()


def v1_layout_sweep_phase():
    """The measurement behind v1.blend_geometry / v1.bwd_geometry: the v1
    blend and bwd at path (a)'s shapes (96 x 16 x 16^2 and 50 x 16 x 16^3,
    100 000 points) over every layout of v1.blend_alternatives /
    v1.bwd_alternatives, and at config 5's volume at C = 16 in query
    order (16 x 16 x 128^3, 1 000 000 points; the blend's texel-major
    copy against the cells read in place, the bwd's 128 threads a block
    against 256), each held to the rule's result and timed in
    turns (the transposes, zero fills and the wrappers' allocations
    included); then the blend reading the cells in place against the
    copy over V1_PLANAR_SWEEP (the measurement behind
    v1.PLANAR_POINTS_PER_TEXEL), with the count of points where the rule
    picks the slower read."""
    for dim, n, s, q in ((2, N, H, Q), (3, N3, S3, Q), (3, N5, S5, Q5)):
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        gen = _cuda_gen(45)
        cells = torch.rand((n, C_WIDE, *spatial), generator=gen,
                           device="cuda")
        pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
        g = torch.randn((1 + 2 * dim, C_WIDE, q), generator=gen,
                        device="cuda")
        what = f"{n}x{C_WIDE}x{s}^{dim}, Q={q}"
        geoms = v1.blend_alternatives(dim, n, C_WIDE, q, spatial)
        bgeoms = v1.bwd_alternatives(dim, n, C_WIDE)
        if n == N5:
            geoms = {k: geoms[k] for k in ("rule", "planar")}
            bgeoms = {k: bgeoms[k] for k in ("rule", "256 threads")}
        runs = {k: functools.partial(fused_v1.launch_blend, cells, pts, cfg,
                                     v) for k, v in geoms.items()}
        _sweep(f"v1 blend layout sweep ({what})", runs, geoms,
               runs["rule"](), reps=5)
        runs = {k: functools.partial(fused_v1.launch_bwd, g, pts, spatial,
                                     cfg, n, v) for k, v in bgeoms.items()}
        _sweep(f"v1 bwd layout sweep ({what})", runs, bgeoms,
               runs["rule"](), reps=5)
        del cells, pts, g, runs
        torch.cuda.empty_cache()
    _v1_planar_sweep()


def _v1_planar_sweep():
    """The v1 blend's planar bound (v1.PLANAR_POINTS_PER_TEXEL): the
    rule's lanes reading the cells in place against the texel-major copy
    at C = 16 over V1_PLANAR_SWEEP, held to each other and timed in
    turns; prints the points where the rule picks the slower read."""
    wrong = []
    for dim, n, s, qs in V1_PLANAR_SWEEP:
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        gen = _cuda_gen(46)
        cells = torch.rand((n, C_WIDE, *spatial), generator=gen,
                           device="cuda")
        for q in qs:
            pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
            rule = v1.blend_geometry(dim, n, C_WIDE, q, spatial)
            geoms = {"rule": rule, ("copy" if rule.planar else "planar"):
                     rule._replace(planar=not rule.planar)}
            runs = {k: functools.partial(fused_v1.launch_blend, cells, pts,
                                         cfg, v) for k, v in geoms.items()}
            ms = _sweep(f"v1 blend planar sweep ({n}x{C_WIDE}x{s}^{dim}, "
                        f"Q={q}, {q / s ** dim:.4f} a texel)", runs, geoms,
                        runs["rule"](), reps=5)
            if min(ms, key=ms.get) != "rule":
                wrong.append((dim, n, s, q))
            del pts, runs
        del cells
        torch.cuda.empty_cache()
    print(f"v1 blend planar sweep: the rule picks the slower read at "
          f"{len(wrong)} of {sum(len(p[3]) for p in V1_PLANAR_SWEEP)} points "
          f"{wrong}", flush=True)


def w_bwd_layout_sweep_phase():
    """The measurement behind fused2w.bwd_geometry: fused2w_bwd and
    fused3w_bwd at the main paths' shapes (96 x C x 16^2 and 50 x C x
    16^3, 100 000 points) at C = 4, 8 and 16 over every layout of
    fused2w.bwd_alternatives, each held to the rule's result and timed in
    turns (the zero fill, the transpose and the wrapper's allocations
    included); then the planar sweep (_w_bwd_planar_sweep)."""
    for dim, n, s in ((2, N, H), (3, N3, S3)):
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        for c in (C, 8, C_WIDE):
            gen = _cuda_gen(47)
            pts = torch.rand((Q, dim), generator=gen, device="cuda") * 2 - 1
            g = torch.randn((1 + 2 * dim, c, Q), generator=gen,
                            device="cuda")
            geoms = fused2w.bwd_alternatives(dim, n, c, Q, spatial)
            runs = {k: functools.partial(fused2w.launch_bwd, g, pts,
                                         spatial, cfg, n, v)
                    for k, v in geoms.items()}
            _sweep(f"fused{dim}w_bwd layout sweep ({n}x{c}x{s}^{dim}, "
                   f"Q={Q})", runs, geoms, runs["rule"](), reps=5)
            del pts, g, runs
    torch.cuda.empty_cache()
    _w_bwd_planar_sweep()


def _w_bwd_planar_sweep():
    """fused2w_bwd's / fused3w_bwd's planar bound
    (fused2w.PLANAR_POINTS_PER_TEXEL): the rule's lanes adding into the
    cotangent in place against the texel-major scratch at C = 4 over
    W_PLANAR_SWEEP, held to each other and timed in turns; prints the
    points where the rule picks the slower destination."""
    wrong = []
    for dim, n, s, qs in W_PLANAR_SWEEP:
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        gen = _cuda_gen(48)
        for q in qs:
            pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
            g = torch.randn((1 + 2 * dim, C, q), generator=gen,
                            device="cuda")
            rule = fused2w.bwd_geometry(dim, n, C, q, spatial)
            geoms = {"rule": rule, ("scratch" if rule.planar else "planar"):
                     rule._replace(planar=not rule.planar)}
            runs = {k: functools.partial(fused2w.launch_bwd, g, pts,
                                         spatial, cfg, n, v)
                    for k, v in geoms.items()}
            ms = _sweep(f"w bwd planar sweep ({n}x{C}x{s}^{dim}, Q={q}, "
                        f"{q / s ** dim:.4f} a texel)", runs, geoms,
                        runs["rule"](), reps=5)
            if min(ms, key=ms.get) != "rule":
                wrong.append((dim, n, s, q))
            del pts, g, runs
        torch.cuda.empty_cache()
    print(f"w bwd planar sweep: the rule picks the slower destination at "
          f"{len(wrong)} of {sum(len(p[3]) for p in W_PLANAR_SWEEP)} "
          f"points {wrong}", flush=True)


def w_blend_layout_sweep_phase():
    """The measurement behind v1.narrow_lanes (fused2w_blend's and
    fused3w_blend's layout up to 8 channels): the two blends at the main
    paths' shapes (96 x C x 16^2 and 50 x C x 16^3, 100 000 points) at
    C = 1, 3, 4 and 8 over every layout of v1.blend_alternatives (cell
    lanes, threads, the read), each held to the rule's result
    and timed in turns, by CUDA events around 20 calls and by device ms
    (torch.profiler, which leaves out the host's share); then the planar
    sweep (_w_blend_planar_sweep)."""
    for dim, n, s in ((2, N, H), (3, N3, S3)):
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        for c in (1, 3, C, 8):
            gen = _cuda_gen(49)
            cells = torch.rand((n, c, *spatial), generator=gen,
                               device="cuda")
            pts = torch.rand((Q, dim), generator=gen, device="cuda") * 2 - 1
            geoms = v1.blend_alternatives(dim, n, c, Q, spatial)
            runs = {k: functools.partial(fused2w.launch_blend, cells, pts,
                                         cfg, v) for k, v in geoms.items()}
            _sweep(f"fused{dim}w_blend layout sweep ({n}x{c}x{s}^{dim}, "
                   f"Q={Q})", runs, geoms, runs["rule"](), reps=20)
            _sweep(f"fused{dim}w_blend layout sweep ({n}x{c}x{s}^{dim}, "
                   f"Q={Q}), device", runs, geoms, runs["rule"](), reps=20,
                   timer=lambda fn, reps: _device_ms(fn, reps=reps))
            del cells, pts, runs
    torch.cuda.empty_cache()
    _w_blend_planar_sweep()


def _w_blend_planar_sweep():
    """fused2w_blend's / fused3w_blend's planar bound
    (v1.NARROW_PLANAR_POINTS_PER_TEXEL): the rule's lanes reading the
    cells in place against the texel-major copy at C = 4 over
    W_BLEND_PLANAR_SWEEP, held to each other and timed in turns (CUDA
    events); prints the points where the rule picks the slower read."""
    wrong = []
    for dim, n, s, qs in W_BLEND_PLANAR_SWEEP:
        cfg = SamplerConfig(dim=dim)
        spatial = (s,) * dim
        gen = _cuda_gen(50)
        cells = torch.rand((n, C, *spatial), generator=gen, device="cuda")
        for q in qs:
            pts = torch.rand((q, dim), generator=gen, device="cuda") * 2 - 1
            rule = v1.blend_geometry(dim, n, C, q, spatial)
            geoms = {"rule": rule, ("copy" if rule.planar else "planar"):
                     rule._replace(planar=not rule.planar)}
            runs = {k: functools.partial(fused2w.launch_blend, cells, pts,
                                         cfg, v) for k, v in geoms.items()}
            ms = _sweep(f"w blend planar sweep ({n}x{C}x{s}^{dim}, Q={q}, "
                        f"{q / s ** dim:.4f} a texel)", runs, geoms,
                        runs["rule"](), reps=5)
            if min(ms, key=ms.get) != "rule":
                wrong.append((dim, n, s, q))
            del pts, runs
        del cells
        torch.cuda.empty_cache()
    print(f"w blend planar sweep: the rule picks the slower read at "
          f"{len(wrong)} of {sum(len(p[3]) for p in W_BLEND_PLANAR_SWEEP)} "
          f"points {wrong}", flush=True)


# (N, C, S, Q) of fused3d's layout sweep: path (c) and its clouds, the
# 8-cell stack, the large cells the unstaged kernels admit, and C = 8
FUSED3D_SWEEP = ([(N3, C, S3, q) for q in (200, Q_SMALL3, 2047, 4096)]
                 + [(8, C, S3, 512), (N_MID, C, S_MID, Q_SMALL3),
                    (N_MID, C, S_MID, Q_MID), (N5, C, S5, 1536),
                    (N3, 8, S3, Q_SMALL3)])
# (N, S, point counts) of fused3d's planar sweep at C = 4: the blend's
# read and the bwd's destination on both sides of their bounds
FUSED3D_PLANAR_SWEEP = ((N3, S3, (200, 512, 1024, 1536, 2048, 4096,
                                   16384)),
                        (8, S3, (64, 512, 2048, 8192)),
                        (N_MID, S_MID, (256, 1024, 2048, 4096, 16384)),
                        (N5, S5, (1536, 8192, 16384, 32768, 65536)))
# (N, C, S, Q) of fused2d's layout sweep: path (b)'s clouds and past
# them, the 8- and 32-cell stacks, 64^2 cells, and C = 8
FUSED2D_SWEEP = ([(N, C, H, q) for q in (200, 1024, 2047, 4096)]
                 + [(8, C, H, 512), (32, C, H, 4096), (16, C, 64, 4096),
                    (N, 8, H, 1024)])
# (N, S, point counts) of fused2d's planar sweep at C = 4: path (b)'s
# stack, 8 cells, 64^2 cells in the L2 and 1024^2 cells over it
FUSED2D_PLANAR_SWEEP = ((N, H, (200, 512, 1024, 2047, 4096, 16384)),
                        (8, H, (64, 512, 2048, 8192)),
                        (16, 64, (256, 1024, 4096, 16384)),
                        (16, 1024, (1024, 4096, 16384, 65536)))


def fused3d_layout_sweep_phase():
    """The measurement behind fused3d.geometry: _small_layout_sweep over
    FUSED3D_SWEEP, then _small_planar_sweep over FUSED3D_PLANAR_SWEEP."""
    _small_layout_sweep("fused3d", FUSED3D_SWEEP)
    _small_planar_sweep("fused3d", FUSED3D_PLANAR_SWEEP)


def fused2d_layout_sweep_phase():
    """The measurement behind fused2d.geometry: _small_layout_sweep over
    FUSED2D_SWEEP, then _small_planar_sweep over FUSED2D_PLANAR_SWEEP."""
    _small_layout_sweep("fused2d", FUSED2D_SWEEP)
    _small_planar_sweep("fused2d", FUSED2D_PLANAR_SWEEP)


def _small_layout_sweep(kind, cases):
    """The small-cloud pair ``kind`` ("fused2d" or "fused3d") over
    ``cases`` ((N, C, S, Q), cells of S per axis) in every layout of its
    blend_alternatives / bwd_alternatives (cell lanes, queries a block,
    threads, the read or destination, fused2w's and fused3w's blocks of
    128 queries), each held to the rule's result and timed in turns by
    CUDA events around 20 calls and by device ms (torch.profiler)."""
    mod = FUSED_MODS[kind]
    dim = int(kind[5])
    cfg = SamplerConfig(dim=dim)
    for n, c, s, q in cases:
        spatial = (s,) * dim
        cells, pts, g = _fused_inputs(n, c, spatial, q, seed=51, lo=-1.0,
                                     hi=1.0)
        what = f"{n}x{c}x{s}^{dim}, Q={q}"
        for part, geoms, launch, args in (
                ("blend", mod.blend_alternatives(n, c, q, spatial),
                 mod.launch_blend, (cells, pts, cfg)),
                ("bwd", mod.bwd_alternatives(n, c, q, spatial),
                 mod.launch_bwd, (g, pts, spatial, cfg, n))):
            runs = {k: functools.partial(launch, *args, v)
                    for k, v in geoms.items()}
            want = runs["rule"]()
            _sweep(f"{kind}_{part} layout sweep ({what})", runs, geoms,
                   want, reps=20)
            _sweep(f"{kind}_{part} layout sweep ({what}), device", runs,
                   geoms, want, reps=20,
                   timer=lambda fn, reps: _device_ms(fn, reps=reps))
            del runs, want
        del cells, pts, g
        torch.cuda.empty_cache()


def _small_planar_sweep(kind, cases):
    """The planar bounds of the small-cloud pair ``kind`` (its
    PLANAR_POINTS_PER_TEXEL / PLANAR_VALUES for the blend's read,
    BWD_PLANAR_* for the bwd's destination): the rule's layout against
    itself with the other read or destination at C = 4 over ``cases``
    ((N, S, point counts)), held to each other and timed in turns by
    device ms (torch.profiler; CUDA events around these calls read the
    host's enqueue); prints the points where the rule picks the slower
    one."""
    mod = FUSED_MODS[kind]
    dim = int(kind[5])
    cfg = SamplerConfig(dim=dim)
    wrong = {"blend": [], "bwd": []}
    for n, s, qs in cases:
        spatial = (s,) * dim
        for q in qs:
            cells, pts, g = _fused_inputs(n, C, spatial, q, seed=52,
                                         lo=-1.0, hi=1.0)
            lays = mod.geometry(n, C, q, spatial)
            for part, rule, launch, args in (
                    ("blend", lays.blend, mod.launch_blend,
                     (cells, pts, cfg)),
                    ("bwd", lays.bwd, mod.launch_bwd,
                     (g, pts, spatial, cfg, n))):
                geoms = {"rule": rule, ("planar" if not rule.planar else
                                        "texel-major"):
                         rule._replace(planar=not rule.planar)}
                runs = {k: functools.partial(launch, *args, v)
                        for k, v in geoms.items()}
                ms = _sweep(f"{kind} {part} planar sweep ({n}x{C}x{s}^{dim},"
                            f" Q={q}, {q / s ** dim:.4f} a texel, rule planar "
                            f"{rule.planar}), device", runs, geoms,
                            runs["rule"](), reps=5,
                            timer=lambda fn, reps: _device_ms(fn, reps=reps))
                if min(ms, key=ms.get) != "rule":
                    wrong[part].append((n, s, q))
                del runs
            del cells, pts, g
        torch.cuda.empty_cache()
    total = sum(len(p[2]) for p in cases)
    for part, points in wrong.items():
        print(f"{kind} {part} planar sweep: the rule picks the slower "
              f"{'read' if part == 'blend' else 'destination'} at "
              f"{len(points)} of {total} points {points}", flush=True)


# (dim, N, S, point counts) of fused2w_bwd's / fused3w_bwd's planar sweep
# at C = 4: config 5's volume and a 2D stack of the same bytes (over the
# L2), the large cells and the main paths' stacks (in the L2)
W_PLANAR_SWEEP = (
    (3, N5, S5, (4096, 8192, 16384, 20480, 24576, 32768, 65536, 131072)),
    (2, N5, 1024, (4096, 8192, 16384, 20480, 24576, 28672, 32768, 65536,
                   131072)),
    (3, 2, 32, (64, 256, 1024, 4096, 16384, 65536)),
    (2, 2, 128, (64, 256, 1024, 4096, 16384, 65536)),
    (3, N3, S3, (64, 256, 1024, 4096, 16384)),
    (2, N, H, (64, 256, 1024, 4096, 16384)))


# (dim, N, S, point counts) of fused2w_blend's / fused3w_blend's planar
# sweep at C = 4: the bwd's stacks, the main paths' up to their 100 000
# points
W_BLEND_PLANAR_SWEEP = W_PLANAR_SWEEP[:4] + (
    (3, N3, S3, (256, 1024, 4096, 16384, 32768, 65536, Q)),
    (2, N, H, (256, 1024, 4096, 16384, 32768, 65536, Q)))


# (dim, N, S, point counts) of the v1 blend's planar sweep at C = 16:
# config 5's volume and a 2D stack of the same bytes (both over the L2),
# the large cells and path (a)'s stacks (in the L2)
V1_PLANAR_SWEEP = (
    (3, N5, S5, (4096, 8192, 16384, 24576, 32768, 49152, 100_000)),
    (2, N5, 1024, (2048, 4096, 8192, 16384, 32768)),
    (3, 2, 32, (256, 1024, 4096, 16384, 65536)),
    (2, 2, 128, (256, 1024, 4096, 16384, 65536)),
    (3, N3, S3, (256, 1024, 4096, 16384)),
    (2, N, H, (256, 1024, 4096, 16384, 65536)))


# the cells and channels of the gather sweep (gather.gather_geometry)
GATHER_CELLS, GATHER_CHANNELS = (1, 3, N5, 50), (C, 8, 12, C_WIDE)


def gather_sweep_phase():
    """The measurement behind gather.gather_geometry: fused3b_blend over
    config 5's 128^3 volume at the trainer's 1 000 000 points and plan, at
    N in {1, 3, 16, 50} x C in {4, 8, 12, 16} (N = 1 and odd N leave
    lanes idle), and fused3s_blend on config 5's volume at 100 000 and
    1 000 000 fresh points over the layouts of gather.gather_alternatives
    and planar (the cells read in place: the measurement behind
    fused3s.PLANAR_POINTS_PER_TEXEL, also at 200 000 and 400 000 points
    and on 16 x 4 x 64^3 at 49 152, 100 000 and 200 000), each held to
    the rule's result and timed in turns (fused3s's transposes included,
    its z sort made once outside)."""
    cfg = SamplerConfig(dim=3)
    spatial = (S5,) * 3
    # the plan depends on the points and the cell size alone
    plan = tfused.make_vol_plan(_trainer_points(Q5, 3), (N5, C, *spatial),
                                cfg)
    for c, n in itertools.product(GATHER_CHANNELS, GATHER_CELLS):
        vol = torch.rand((*spatial, n, c), generator=_cuda_gen(42),
                         device="cuda")
        geoms = gather.gather_alternatives(n, c, bricked=True)
        runs = {k: functools.partial(fused3b.launch_blend, vol, plan, cfg, v)
                for k, v in geoms.items()}
        _sweep(f"fused3b_blend gather sweep (config 5, {n}x{c}x{S5}^3, "
               f"Q={Q5})", runs, geoms, runs["rule"](), reps=5)
        del vol, runs
        torch.cuda.empty_cache()
    del plan
    for s, points in ((S5, (Q, 200_000, 400_000, Q5)),
                      (64, (49_152, Q, 200_000))):
        cells = torch.rand((N5, C, *(s,) * 3), generator=_cuda_gen(43),
                           device="cuda")
        for q in points:
            pts = torch.rand((q, 3), generator=_cuda_gen(44),
                             device="cuda") * 2 - 1
            order = fused3s.zsort(pts, s, cfg)
            geoms = gather.gather_alternatives(N5, C)
            if q not in (Q, Q5):
                geoms = {"rule": geoms["rule"]}
            runs = {k: functools.partial(fused3s.launch_blend, cells, pts,
                                         cfg, order, v)
                    for k, v in geoms.items()}
            # the cells read in place, a channel a load
            for k, v in (("planar", geoms["rule"]),
                         ("planar, a thread a query",
                          gather.GatherGeometry(C, 1, 1, gather.QUERIES)),
                         ("planar, four cell lanes",
                          geoms["rule"]._replace(cell_lanes=4))):
                geoms[k] = v
                runs[k] = functools.partial(fused3s.launch_blend, cells, pts,
                                            cfg, order, v, True)
            picks = "planar" if fused3s.planar(q, (s,) * 3) else "texel-major"
            _sweep(f"fused3s_blend gather sweep ({N5}x{C}x{s}^3, Q={q}; the "
                   f"rule reads {picks})", runs, geoms, runs["rule"](),
                   reps=5)
            del pts, order, runs
            torch.cuda.empty_cache()
        del cells


def mega_sweep_phase():
    """The measurement behind mega2w.geometry at the 2D main path: its
    work units against lanes over 4 cells, twice the chunks, half the
    slices, and the global path that takes cells too large to stage, each
    held to the rule's cells gradient and timed in turns."""
    main = SamplerConfig(dim=2)
    gen = torch.Generator().manual_seed(13)
    cells = torch.rand((N, C, H, W), generator=gen).cuda()
    pts = (torch.rand((Q, 2), generator=gen) * 2 - 1).cuda()
    mlp = _mlp(C, HIDDEN, gen)
    rule = mega2w.geometry(N, C, H, W, Q, HIDDEN)
    half = max(1, rule.slices // 2)
    geoms = {
        "rule": rule,
        "lanes over 4 cells": rule._replace(lanes=4),
        "twice the chunks": rule._replace(
            chunks=2 * rule.chunks, cells=-(-N // (2 * rule.chunks)),
            slices=half, q_per_slice=-(-Q // half)),
        "half the slices": rule._replace(slices=half,
                                         q_per_slice=-(-Q // half)),
        "global path (cells too large to stage)": mega2w.GLOBAL_PATH,
    }
    runs = {k: (lambda g=g: mega2w.launch_step(
        cells, *mlp, pts, main, "allen_cahn", g)[1]["cells"])
        for k, g in geoms.items()}
    _sweep(f"mega2w sweep ({N}x{C}x{H}x{W}, Q={Q}, hidden {HIDDEN})", runs,
           geoms, runs["rule"]())


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

    _fixed_step_turns("config 5", MODEL_5, pts,
                      ("vol", "planned", "unplanned"), plan)
    return times


def _fixed_step(model, pts, kind, plan=None):
    """One fixed-point train step of ``kind``: "vol" (vol-resident, on
    ``plan``), "planned" (make_sample_plan's plan, per-call relayout) or
    "unplanned" (query order, no plan: the fused op's route)."""
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
    shape = (model.n_cells, model.cell_dim, *(model.cell_size,) * model.dim)
    for kind in kinds:
        ms = [m for k, m, _ in runs if k == kind]
        peak = max(p for k, _, p in runs if k == kind)
        label = (kind if kind in ("vol", "planned") else f"{kind} "
                 f"({route.fused_rule(model.sampler, shape, pts.shape[0])})")
        print(f"step {what} {label}: {sum(ms) / 2:.4f} ms (turns "
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
                                pde="helmholtz"), pts,
                ("planned", "unplanned"))


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


def _timed(fn, *args):
    """``fn(*args)``, its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the parent commit, "
                    "whose fused3d pair fused3ds_time_phase times in turns "
                    "with this one's")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    card = device_phase()
    _timed(build_phase)
    errs, times = _timed(kernel_phase)
    errs.update(_timed(v1_kernel_phase))
    _timed(points_cotangent_phase)
    errs["mega2w"] = _timed(mega_kernel_phase)
    errs.update(_timed(fused3w_kernel_phase))
    _timed(w_blend_kernel_phase)
    errs.update(_timed(fused3b_kernel_phase))
    _timed(layout_phase)
    ghost_errs, ghost_det = _timed(fused3b_ghost_kernel_phase)
    errs.update(ghost_errs)
    errs.update(_timed(pc_slab_kernel_phase))
    launches, fused_losses = _timed(fused_trainer_phase)
    mega = _timed(mega_trainer_phase, fused_losses)
    nested = _timed(nested_trainer_phase)
    _timed(launch_breakdown_phase)
    _timed(nested_3d_phase)
    fused3 = _timed(fused_3d_phase)
    vol = _timed(vol_trainer_phase)
    ghost = _timed(ghost_trainer_phase)
    nested_vol = _timed(nested_vol_trainer_phase)
    _timed(per_cell_chain_phase)
    _timed(sparse_and_2d_phase)
    launches.update({k: nested_vol[k] for k in (
        "percell_blend", "percell_splat", "slab_blend", "slab_splat")})
    launches.update(blend_o=nested["blend_o"], splat_o=nested["splat_o"],
                    mega2w=mega["mega2w"],
                    fused3w_blend=fused3["fused3w_blend"],
                    fused3w_bwd=fused3["fused3w_bwd"],
                    fused3b_blend=vol["fused3b_blend"],
                    fused3b_bwd=vol["fused3b_bwd"],
                    fused3b_bwd_ghost=ghost["fused3b_bwd_ghost"])
    errs.update(_timed(fused_v1_kernel_phase))
    errs.update(_timed(fused2d_kernel_phase))
    _timed(wide_kernel_phase)
    wide = _timed(wide_trainer_phase)
    launches.update(fused_blend=wide["2D"]["fused_blend"],
                    fused_bwd=wide["2D"]["fused_bwd"])
    _timed(small_cloud_sweep_phase)
    path_b = _timed(small_cloud_2d_trainer_phase)
    launches.update(fused2d_blend=path_b["fused2d_blend"],
                    fused2d_bwd=path_b["fused2d_bwd"])
    errs.update(_timed(fused3ds_kernel_phase))
    _timed(fused3b_wide_kernel_phase)
    _timed(vol_wide_trainer_phase)
    _timed(planned_wide_phase)
    _timed(small_cloud_3d_sweep_phase)
    _timed(wide_route_sweep_phase)
    path_c = _timed(small_cloud_3d_trainer_phase)
    launches.update({k: path_c.get(k, 0) for k in (
        "fused3d_blend", "fused3d_bwd", "fused3s_blend", "fused3s_bwd")})
    _timed(plain_route_phase)
    _timed(nested_vs_fused_phase)
    _timed(reference_phase)
    times.update(_timed(v1_time_phase))
    _timed(splat_sweep_phase)
    _timed(blend_sweep_phase)
    _timed(scatter_sweep_phase)
    _timed(gather_sweep_phase)
    _timed(v1_layout_sweep_phase)
    _timed(w_bwd_layout_sweep_phase)
    _timed(w_blend_layout_sweep_phase)
    _timed(fused3d_layout_sweep_phase)
    _timed(fused2d_layout_sweep_phase)
    _timed(mega_sweep_phase)
    times.update(_timed(mega_fused3w_time_phase))
    times.update(_timed(fused3b_time_phase))
    times.update(_timed(ghost_time_phase))
    times.update(_timed(pc_slab_time_phase))
    _timed(route_phase)
    _timed(step_phase)
    _timed(nested_vol_step_phase)
    _timed(nested_ops_phase)
    times.update(_timed(wide_time_phase))
    times.update(_timed(fused3ds_time_phase, args.parent))
    _timed(wide_step_phase)
    _timed(tf32_phase)
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], **times[name]}
               for name in REPLACES]
    print(f"fused3b_bwd_ghost: two runs on the same inputs at config 5 "
          f"differ by at most {ghost_det:.3e} (the fold sums in a fixed "
          f"order; the bricks' shared-memory atomics do not)", flush=True)
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise RuntimeError(f"a kernel of the main paths never launched: "
                           f"{idle}")
    print(f"chip_smoke.py: all phases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
