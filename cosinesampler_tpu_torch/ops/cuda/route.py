"""The route of each blend_o / splat_o call of the public sampler.

Counterpart of the JAX package's ops/pallas/__init__.py ``_blend`` /
``_splat``, which send a volume over the TPU's VMEM budget to the binned
per-cell kernels (percell.py) when the cloud has enough (cell, query)
pairs and to the slab kernels (slab.py) otherwise.  That budget means
nothing on the card.  What does is whether the stack fits the 50 MB L2
(splat_o's atomics then stay in L2) and how many pairs share the bytes
a route must move: the slab kernels stage and write the whole stack once
(a slab of rows a block, its pairs binned by row), blend_o / splat_o
gather and add where each pair lands.  ``rule`` is the card's rule,
measured (PERF.md section 4); ``pick`` applies it to one call.  Over a
stack larger than L2 with many pairs the slab kernels take every cell
whose two rows fit a block's shared memory (and whose rows the bins'
histogram holds), percell the 3D cells whose rows do not fit;
everything else goes to blend_o / splat_o.

A call that no kernel takes goes to the ``"plain"`` route, the plain
PyTorch version on the call's own CUDA device, as the JAX package sends it
to XLA: f64 tensors, tensors whose element counts pass the kernels'
32-bit indexing, and fused op calls at a precision the kernels do not
compute ("bf16", "fast"; ``vol_rule`` for the planned and vol-resident
ops).  ``sampler_rule`` makes that decision for the public
sampler and ``fused_rule`` for the fused op (ops/fused.py), after the JAX
package's ``_fused_blend`` / ``_fused_bwd`` order: plain; fused2d
or fused2w in 2D and fused3d, fused3s or fused3w in 3D up to
``FUSED_MAX_CHANNELS`` channels; above it fused2w's / fused3w's channel
groups or the channel-looped v1 kernels (B6, ops/cuda/fused.py), by
measurement.  Both are pure functions of facts known before
any launch (device type, dtypes, element counts, channels, config), and
``pick`` / ``pick_fused`` apply them to a call's tensors: no route
switches after a failed build or launch.
``run_plain`` runs the plain route and counts its calls in
``run_plain.launches``.

``GridPlans`` carries percell's pair plan and slab's bins along one
autograd chain: the nested 3D trainer makes 40 blends and 40 splats on
one grid a step, and all of them take the bins built at the chain's
first slab launch (0.031 ms of device time a build at 1.6 M pairs,
PERF.md section 6).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import SamplerConfig, effective_align
from . import blend_splat, fused2d, fused2w, fused3d, fused3s, percell, slab

__all__ = ["GridPlans", "blend", "fused_rule", "pick", "pick_fused", "rule",
           "run_plain", "sampler_rule", "splat", "vol_rule"]

# a stack up to this many bytes keeps splat_o's global atomics in L2 (the
# H100's 50 MB): blend_o / splat_o won there (16 x 4 x 16^3 and 32^3 at
# 1.6 M pairs; the slab kernels lost 6x and by 5-25%)
STACK_L2_BYTES = 50 * 10**6
# fewest (cell, query) pairs at which the slab kernels, their bins reused
# along the chain, beat blend_o / splat_o over a stack larger than L2: on
# 16 x 4 x 128^3 2^18 won and 131 072 lost, on 1024 x 4 x 16^3 and 4 x 4
# x 1024^2 2^18 won (the 2D volume lost at 65 536).  percell, its plan
# reused, lost to slab at every point at 2^18 pairs or more, and beat
# blend_o / splat_o where slab cannot stage two rows at 2^20 pairs (8 x 4
# x 32 x 256^2: 0.855 vs 1.40 ms); at 2^18 there it lost by 6% (0.507 vs
# 0.478) and at 65 536 by 24%, so the crossover lies between 2^18 and
# 2^20 and the rule sends 2^18 to the slower route (PERF.md section 4)
MIN_PAIRS = 1 << 18
# the kernels index with 32-bit ints: a tensor of this many elements or
# more takes the plain route
INDEX_LIMIT = 2**31
# the precisions the fused op's kernels compute (all in f32); a CUDA call
# at another ("bf16", "fast") takes the plain route, whose plain versions
# compute in f32 at every precision, as on the CPU
KERNEL_PRECISIONS = ("exact", "highest")
# up to this many channels the fused op takes fused2d / fused2w in 2D
# and fused3d / fused3s / fused3w in 3D by the bounds below.  Above it
# fused2w's and fused3w's blends are the v1 blend (one gather, one
# layout rule: ops/cuda/v1.py blend_geometry) and their bwds the v1 bwd's
# scatter but for one mode: below fused2w.PLANAR_POINTS_PER_TEXEL points
# a texel they add into the cotangent in place.  So the rule takes
# fused2w / fused3w there and the v1 pair elsewhere: chip_smoke.py's
# wide_route_sweep_phase (PERF.md section 4) read the two within 1% of
# each other at every point where fused3w's bwd takes the scratch, and
# fused3w 1.1-1.8x faster where it adds in place (16 x C x 128^3 at up
# to 16 384 points, C = 12 and 16).
FUSED_MAX_CHANNELS = 8
# in 2D up to 8 channels, fused2d up to FUSED2D_MAX_Q queries or up to
# FUSED2D_MAX_Q_PER_CELL queries a cell, whichever allows more; fused2w
# otherwise: each the last point where fused2d won in chip_smoke.py's
# sweep in two calls (blend + bwd device ms, H100 80GB HBM3 at 700 W;
# PERF.md section 4).  Against the texel-major fused2w blend and bwd,
# fused2d (fused2w's bodies in blocks of a few queries, a warp over a
# query's cells) won on 16^2 cells at every cell count from 8 to 96 up
# to 12 288 points (1.1-6x: fused2w's 128-query blocks fill few SMs; at 8
# to 32 cells by 10-12% at 12 288) and lost at 16 to 32 cells from 16 384
# (by 1-5%); from 32 cells it won up to 384 points a cell (48 x 16 384,
# 64 x 24 576, 96 x 32 768 by 0.4%) and lost from 512 (48 x 24 576,
# 64 x 32 768, 96 x 49 152, by 3-10%).  At 8 cells the faster flipped
# between the calls at 16 384 and 24 576 (by 1-3%); fused2d won on
# 2 x 4 x 256^2 up to 4 096 points and on 16 x 4 x 64^2 at 16 384 (by
# 18%, past the bound), and lost on 16 x 4 x 1024^2 (over the L2) at
# 8 192 (by 11%, within it).
FUSED2D_MAX_Q = 12288
FUSED2D_MAX_Q_PER_CELL = 384
# in 3D up to 8 channels, fused3d up to FUSED3D_MAX_Q_PER_CELL queries a
# cell and FUSED3D_MAX_Q queries; fused3s, in zeros and border padding, at
# FUSED3S_MIN_Q queries or more over a stack of FUSED3S_MIN_STACK_BYTES
# or more with FUSED3S_MIN_CHANNELS channels and FUSED3S_MIN_PLANES
# (cell, channel) planes or more; fused3w otherwise, by chip_smoke.py's
# sweep (blend + bwd device ms, H100 80GB HBM3 at 700 W; PERF.md section
# 4).  Against the texel-major fused3w blend and bwd, fused3d (fused3w's
# bodies in blocks of a few queries, a warp over a query's cells) won on
# 16^3 cells at every cell count from 8 to 50 up to 12 288 points (at 8
# cells 0.0274 against 0.0322 ms; 1.5-2.2x faster at 8 to 32 cells and
# 1 024-4 096 points, where its staged design lost), at 50 cells up to
# 24 576 (by 2%) and lost from 32 768; at 8 cells it lost at 16 384 (2%);
# on 16 x 4 x 32^3 it won at every count to 65 536 points and lost at
# 100 000, on 16 x 4 x 128^3 it won up to 5 120 (0.3718 against 0.3785)
# and lost from 6 144 (by 3-7%; a 537 MB fill in each).  fused3s lost on 8 x 4 x 80^3
# (65.5 MB) and below the stack bound; on 16 x 4 x 128^3 it won from
# 393 216 points in both calls (2.52 against 2.60-2.83 ms), flipped at
# 262 144 (by 4%) and lost up to 131 072 (1.70 against 1.46); it won on
# 64 planes (16 x 4 x 96^3 and 128^3) and lost on 48 (16 x 3 x 96^3) and
# 24 (6 x 4 x 128^3).
FUSED3D_MAX_Q_PER_CELL = 1536
FUSED3D_MAX_Q = 12288
FUSED3S_MIN_Q = 393_216
FUSED3S_MIN_STACK_BYTES = 16 * 4 * 64**3 * 4
FUSED3S_MIN_CHANNELS = 3
FUSED3S_MIN_PLANES = 64

def rule(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
         n_pairs: int) -> str:
    """The route of a CUDA f32 blend or splat over (N, C, *S) cells and
    ``n_pairs`` (cell, query) pairs.  A stack over the L2 at MIN_PAIRS
    pairs or more: slab where slab.supports the cells (two rows of one
    channel fit a block's shared memory, and the bins' histogram of a
    cell's rows), percell for 3D cells whose rows do not fit; blend_o /
    splat_o otherwise.  Both ops of a chain take one
    route, so they share one plan."""
    if (n_pairs < MIN_PAIRS
            or 4 * math.prod(cells_shape) <= STACK_L2_BYTES):
        return "blend_o"
    if slab.geometry(cells_shape[1], cells_shape[2:], 1) is not None:
        return "slab" if slab.supports(cfg, cells_shape) else "blend_o"
    return "percell" if percell.supports(cfg, cells_shape) else "blend_o"


def sampler_rule(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
                 grid_shape: Tuple[int, ...], device_type: str = "cuda",
                 dtype: torch.dtype = torch.float32) -> str:
    """The route of one blend or splat over (N, C, *S) cells at a grid of
    ``grid_shape``, where ``dtype`` is the promoted dtype of its tensors:
    ``"plain"`` for CUDA calls the kernels do not take (a dtype other than
    f32, or too many elements for their 32-bit indexing), ``rule`` for the
    other CUDA calls, and "blend_o" off the card, whose wrapper takes the
    plain version on the CPU and raises for other devices or a mix of
    devices."""
    if device_type != "cuda":
        return "blend_o"
    n, c, *spatial = cells_shape
    q = math.prod(grid_shape[1:-1])
    if (dtype != torch.float32
            or max(n * c * max(q, math.prod(spatial)),
                   math.prod(grid_shape)) >= INDEX_LIMIT):
        return "plain"
    return rule(cfg, cells_shape, n * q)


def _device_type(a: torch.Tensor, b: torch.Tensor) -> str:
    """The device type of two tensors, "mixed" where they differ."""
    return a.device.type if a.device == b.device else "mixed"


def _dtype(*tensors: torch.Tensor) -> torch.dtype:
    """float32, or the first other dtype among ``tensors``."""
    return next((t.dtype for t in tensors if t.dtype != torch.float32),
                torch.float32)


def pick(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
         first: torch.Tensor, grid: torch.Tensor) -> str:
    """``sampler_rule`` for one call on ``first`` (input or cotangent) and
    ``grid``."""
    return sampler_rule(cfg, cells_shape, tuple(grid.shape),
                        _device_type(first, grid), _dtype(first, grid))


def pick_fused(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
               first: torch.Tensor, points: torch.Tensor) -> str:
    """``fused_rule`` for one fused op call on ``first`` (cells or
    cotangent) and ``points``."""
    return fused_rule(cfg, cells_shape, points.shape[0],
                      _device_type(first, points), _dtype(first, points))


def fused_rule(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
               n_queries: int, device_type: str = "cuda",
               dtype: torch.dtype = torch.float32) -> str:
    """The route of one fused op call (blend and bwd alike) over (N, C, *S)
    cells and ``n_queries`` shared points, where ``dtype`` is the promoted
    dtype of its tensors: ``"plain"`` for CUDA calls no fused kernel takes
    (a dtype other than f32; a precision not in KERNEL_PRECISIONS; strict
    reference in 2D with align_corners off, whose rows mix alignments; a
    tensor over the 32-bit indexing); else
    above FUSED_MAX_CHANNELS channels ``"fused2w"`` / ``"fused3w"`` where
    their bwd adds into the cotangent in place (fused2w.bwd_geometry's
    planar) and ``"fused"`` (the v1 kernels) otherwise; in 3D
    ``"fused3d"`` up to FUSED3D_MAX_Q_PER_CELL queries a cell and
    FUSED3D_MAX_Q queries (fused3d.supports takes every 3D stack),
    ``"fused3s"`` at FUSED3S_MIN_Q queries or
    more over stacks of FUSED3S_MIN_STACK_BYTES or more,
    FUSED3S_MIN_CHANNELS channels and FUSED3S_MIN_PLANES (cell, channel)
    planes or more, in zeros and border padding (fused3s.supports),
    ``"fused3w"`` otherwise; in 2D ``"fused2d"`` up to FUSED2D_MAX_Q
    queries or FUSED2D_MAX_Q_PER_CELL queries a cell, whichever allows
    more (fused2d.supports takes every 2D stack), ``"fused2w"``
    otherwise.  Off the
    card the same kernel routes apply, whose wrappers take the plain
    version on the CPU."""
    n, c, *spatial = cells_shape
    dim = len(spatial)
    too_big = max(n * c * math.prod(spatial), (1 + 2 * dim) * c * n_queries,
                  dim * n_queries) >= INDEX_LIMIT
    if device_type == "cuda" and (
            dtype != torch.float32 or too_big
            or cfg.precision not in KERNEL_PRECISIONS
            or (cfg.strict_reference and dim == 2 and not cfg.align_corners)):
        return "plain"
    if c > FUSED_MAX_CHANNELS:
        planar = fused2w.bwd_geometry(dim, n, c, n_queries, spatial).planar
        return f"fused{dim}w" if planar else "fused"
    if dim == 3:
        if (n_queries <= min(FUSED3D_MAX_Q, FUSED3D_MAX_Q_PER_CELL * n)
                and fused3d.supports(cfg, cells_shape)):
            return "fused3d"
        if (n_queries >= FUSED3S_MIN_Q
                and 4 * n * c * math.prod(spatial) >= FUSED3S_MIN_STACK_BYTES
                and c >= FUSED3S_MIN_CHANNELS and n * c >= FUSED3S_MIN_PLANES
                and fused3s.supports(cfg, cells_shape)):
            return "fused3s"
        return "fused3w"
    small = n_queries <= max(FUSED2D_MAX_Q, FUSED2D_MAX_Q_PER_CELL * n)
    if small and fused2d.supports(cfg, cells_shape):
        return "fused2d"
    return "fused2w"


def vol_rule(cfg: SamplerConfig, device_type: str = "cuda") -> str:
    """The route of one call of the slot-resident fused op over a
    kernel-layout volume (ops/fused.py: the planned and vol-resident ops),
    blend and bwd alike: ``"plain"`` for a CUDA call at a precision not in
    KERNEL_PRECISIONS, ``"fused3b"`` otherwise, whose wrappers take the
    plain versions on the CPU."""
    if device_type == "cuda" and cfg.precision not in KERNEL_PRECISIONS:
        return "plain"
    return "fused3b"


def run_plain(fn, *args):
    """The ``"plain"`` route: ``fn``, a plain PyTorch version, on the
    arguments' own device, counted in ``run_plain.launches``."""
    run_plain.launches += 1
    return fn(*args)


run_plain.launches = 0


class GridPlans:
    """The pair plans of the grid of one autograd chain: percell's pair
    plan and slab's bins, each built at its route's first launch that
    needs it and reused by the others.  Each is keyed on the grid's
    storage, shape, strides and version and on what it depends on, so a
    grid that is not the one it was built for (or was changed in place)
    gets a new one.  ``builds`` counts the builds of both."""

    def __init__(self):
        self._cache = {}
        self.builds = 0

    def _get(self, kind: str, key, make):
        held = self._cache.get(kind)
        if held is None or held[0] != key:
            held = (key, make())
            self._cache[kind] = held
            self.builds += 1
        return held[1]

    @staticmethod
    def _key(grid: torch.Tensor, cells_shape, cfg: SamplerConfig):
        return (grid.device, grid.data_ptr(), tuple(grid.shape),
                tuple(grid.stride()), grid.dtype, grid._version,
                tuple(cells_shape), cfg.padding_mode,
                cfg.align_corners, cfg.multicell, cfg.strict_reference)

    def percell(self, grid: torch.Tensor, cells_shape,
                cfg: SamplerConfig) -> percell.PairPlan:
        return self._get("percell", self._key(grid, cells_shape, cfg),
                         lambda: percell.make_plan(grid, cells_shape, cfg))

    def slab(self, grid: torch.Tensor, cells_shape, cfg: SamplerConfig,
             align: bool) -> slab.SlabBins:
        """slab's bins with ``align``, one set for each value: the
        blend's effective align_corners differs from the splat's in strict
        2D at order 0 only."""
        return self._get(f"slab, align {align}",
                         self._key(grid, cells_shape, cfg),
                         lambda: slab.make_bins(grid, cells_shape, cfg, align))


def blend(input: torch.Tensor, grid: torch.Tensor, cfg: SamplerConfig,
          orders: Tuple[int, ...],
          plans: Optional[GridPlans] = None) -> torch.Tensor:
    """blend_o of (N, C, *S) cells at the grid through the route ``pick``
    gives it."""
    shape = tuple(input.shape)
    route = pick(cfg, shape, input, grid)
    if route == "percell":
        plan = (plans or GridPlans()).percell(grid, shape, cfg)
        return percell.blend(input, grid, cfg, orders, plan)
    if route == "slab":
        align = effective_align(cfg, orders)
        bins = ((plans or GridPlans()).slab(grid, shape, cfg, align)
                if slab.needs_bins(shape, True) else None)
        return slab.blend(input, grid, cfg, orders, bins)
    if route == "plain":
        return run_plain(blend_splat.plain_blend, input, grid, cfg, orders)
    return blend_splat.blend(input, grid, cfg, orders)


def splat(gout: torch.Tensor, grid: torch.Tensor,
          in_spatial: Tuple[int, ...], cfg: SamplerConfig,
          orders: Tuple[int, ...],
          plans: Optional[GridPlans] = None) -> torch.Tensor:
    """splat_o, the transpose of blend, through the route ``pick`` gives
    it."""
    shape = (*gout.shape[:2], *in_spatial)
    route = pick(cfg, shape, gout, grid)
    if route == "percell":
        plan = (plans or GridPlans()).percell(grid, shape, cfg)
        return percell.splat(gout, grid, in_spatial, cfg, orders, plan)
    if route == "slab":
        bins = ((plans or GridPlans()).slab(grid, shape, cfg,
                                            cfg.align_corners)
                if slab.needs_bins(shape, False) else None)
        return slab.splat(gout, grid, in_spatial, cfg, orders, bins)
    if route == "plain":
        return run_plain(blend_splat.plain_splat, gout, grid,
                         tuple(in_spatial), cfg, orders)
    return blend_splat.splat(gout, grid, in_spatial, cfg, orders)
