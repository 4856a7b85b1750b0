"""The route of each blend_o / splat_o call of the public sampler.

Counterpart of the JAX package's ops/pallas/__init__.py ``_blend`` /
``_splat``, which send a volume over the TPU's VMEM budget to the binned
per-cell kernels (percell.py) when the cloud has enough (cell, query)
pairs and to the slab kernels (slab.py) otherwise.  That budget means
nothing on the card.  What does is whether one cell fits the 227 KB of
shared memory a block may use (splat_o then accumulates in shared
memory, and above it falls to global atomics at random over the stack)
and whether the stack fits the 50 MB L2 (those atomics then stay in L2).
``rule`` is the card's rule, measured (PERF.md section 4); ``pick``
applies it to one call.  Over a 3D stack larger than L2 with many pairs,
cells that fit a block's shared memory go to the slab kernels (one block
stages a whole cell) and larger ones to percell; everything else goes to
blend_o / splat_o.

A call that no kernel takes goes to the ``"plain"`` route, the plain
PyTorch version on the call's own CUDA device, as the JAX package sends it
to XLA: f64 tensors, and tensors whose element counts pass the kernels'
32-bit indexing.  ``sampler_rule`` makes that decision for the public
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

``GridPlans`` carries percell's pair plan along one autograd chain: the
nested 3D trainer makes some 200 blend/splat launches on one grid a step,
and each takes the plan built at the chain's first percell launch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import SamplerConfig
from . import blend_splat, fused2d, fused3d, fused3s, percell, slab
from .build import BLOCK_SMEM_BYTES

__all__ = ["GridPlans", "blend", "fused_rule", "pick", "pick_fused", "rule",
           "run_plain", "sampler_rule", "splat"]

# a stack up to this many bytes keeps splat_o's global atomics in L2 (the
# H100's 50 MB): blend_o / splat_o won or tied there (16 x 4 x 32^3)
STACK_L2_BYTES = 50 * 10**6
# fewest (cell, query) pairs at which percell, its plan reused along the
# chain, and slab beat blend_o / splat_o over a stack larger than L2
# (percell at 128^3: 2^20 won, 2^18 lost; slab at 16^3: 2^20 won, 2^18
# within noise; PERF.md section 4)
MIN_PAIRS = 1 << 20
# the kernels index with 32-bit ints: a tensor of this many elements or
# more takes the plain route
INDEX_LIMIT = 2**31
# the most channels a fused2w / fused3w thread keeps in registers at once
# (csrc/fused_rows.cuh kMaxChannels).  Above it both walk channel groups,
# as the v1 kernels do, and the rule picks by chip_smoke.py's
# wide_route_sweep_phase (PERF.md section 4): in 2D fused2w up to
# FUSED2W_WIDE_MAX_C channels, the v1 pair above; in 3D fused3w up to
# FUSED3W_WIDE_MAX_Q queries, the v1 pair above.  fused2w won on 96 x 12
# x 16^2 at 1024, 16 384 and 100 000 points and lost at 16 channels at
# all three; fused3w won on 50 x C x 16^3 at 8192 points at C = 16 (lost
# by 4% at C = 12) and lost at 16 384 at both.  On 16 x C x 128^3 it won
# by 2-3% at 100 000 too, which the rule gives up rather than extend a
# bound to point counts the sweep does not reach.
FUSED_MAX_CHANNELS = 8
FUSED2W_WIDE_MAX_C = 12
FUSED3W_WIDE_MAX_Q = 8192
# in 2D up to 8 channels, fused2d up to FUSED2D_MAX_Q queries or up to
# FUSED2D_MAX_PAIRS (cell, query) pairs, fused2w otherwise: each the last
# point where fused2d won in chip_smoke.py's sweep (PERF.md section 4).
# fused2d won at 96 cells x 3584 points, lost at 96 x 4096; won at 8 x
# 16384 and 32 x 4096 (2^17 pairs), lost at 8 x 24576 and 32 x 7168.  At
# 32 x 6144 (196 608 pairs) it won by 4%, but at 8 x 24576, as many pairs,
# it lost by 27%: the pair bound stops below both.
FUSED2D_MAX_Q = 3584
FUSED2D_MAX_PAIRS = 1 << 17
# in 3D up to 8 channels, fused3d up to FUSED3D_MAX_Q queries where a
# cell's channel group fits shared memory (fused3d.supports); fused3s, in
# zeros and border padding, at FUSED3S_MIN_Q queries or more over a stack
# of FUSED3S_MIN_STACK_BYTES or more with FUSED3S_MIN_CHANNELS channels
# and FUSED3S_MIN_PLANES (cell, channel) planes or more; fused3w
# otherwise: each the last point where the kernel won in chip_smoke.py's
# sweep (PERF.md section 4).  fused3d won at 6144 points at 8 and 50
# cells; at 8192 it lost at 8 cells and tied at 50.  fused3s (at 16 x 4
# x S^3 unless named) won at 81 920 points on 96^3 and 128^3 and lost at
# 65 536; won at 100 000 on 64^3 (67 MB, by 2%; it loses there at 81 920,
# the one point the rule sends to the slower kernel) and lost on 8 x 4 x
# 80^3 (65.5 MB); won on 16 x 3 x 96^3 and lost on 16 x 2 x 96^3; won on
# 6 x 4 x 128^3 and lost on 4 x 4 x 128^3.  Its sort costs ~0.15 ms at
# 100 000 points, which a stack that L2 holds or a thin one (few cells or
# channels a query) does not pay back.
FUSED3D_MAX_Q = 6144
FUSED3S_MIN_Q = 81_920
FUSED3S_MIN_STACK_BYTES = 16 * 4 * 64**3 * 4
FUSED3S_MIN_CHANNELS = 3
FUSED3S_MIN_PLANES = 24


def rule(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
         n_pairs: int) -> str:
    """The route of a CUDA f32 blend or splat over (N, C, *S) cells and
    ``n_pairs`` (cell, query) pairs.  A 3D stack over the L2 at MIN_PAIRS
    pairs or more: slab for cells up to a block's shared memory (where
    slab.supports them), percell for larger cells; blend_o / splat_o
    otherwise.  Both ops of a chain take one route, so they share one
    plan."""
    cell_bytes = 4 * math.prod(cells_shape[1:])
    if (not percell.supports(cfg, cells_shape) or n_pairs < MIN_PAIRS
            or cells_shape[0] * cell_bytes <= STACK_L2_BYTES):
        return "blend_o"
    # a cell up to a block's shared memory: slab stages it whole, and
    # splat_o accumulates it there (csrc/blend_splat.cu)
    if cell_bytes > BLOCK_SMEM_BYTES:
        return "percell"
    return "slab" if slab.supports(cfg, cells_shape) else "blend_o"


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
    (a dtype other than f32; strict reference in 2D with align_corners off,
    whose rows mix alignments; a tensor over the 32-bit indexing); else
    above FUSED_MAX_CHANNELS channels ``"fused2w"`` in 2D up to
    FUSED2W_WIDE_MAX_C channels, ``"fused3w"`` in 3D up to
    FUSED3W_WIDE_MAX_Q queries, and ``"fused"`` (the v1 kernels)
    otherwise; in 3D
    ``"fused3d"`` up to FUSED3D_MAX_Q queries where its chunks fit shared
    memory (fused3d.supports), ``"fused3s"`` at FUSED3S_MIN_Q queries or
    more over stacks of FUSED3S_MIN_STACK_BYTES or more,
    FUSED3S_MIN_CHANNELS channels and FUSED3S_MIN_PLANES (cell, channel)
    planes or more, in zeros and border padding (fused3s.supports),
    ``"fused3w"`` otherwise; in 2D ``"fused2d"`` up to FUSED2D_MAX_Q
    queries or FUSED2D_MAX_PAIRS (cell, query) pairs where its chunks fit
    shared memory (fused2d.supports), ``"fused2w"`` otherwise.  Off the
    card the same kernel routes apply, whose wrappers take the plain
    version on the CPU."""
    n, c, *spatial = cells_shape
    dim = len(spatial)
    too_big = max(n * c * math.prod(spatial), (1 + 2 * dim) * c * n_queries,
                  dim * n_queries) >= INDEX_LIMIT
    if device_type == "cuda" and (
            dtype != torch.float32 or too_big
            or (cfg.strict_reference and dim == 2 and not cfg.align_corners)):
        return "plain"
    if c > FUSED_MAX_CHANNELS:
        if dim == 2:
            return "fused2w" if c <= FUSED2W_WIDE_MAX_C else "fused"
        return "fused3w" if n_queries <= FUSED3W_WIDE_MAX_Q else "fused"
    if dim == 3:
        if (n_queries <= FUSED3D_MAX_Q
                and fused3d.supports(cfg, cells_shape)):
            return "fused3d"
        if (n_queries >= FUSED3S_MIN_Q
                and 4 * n * c * math.prod(spatial) >= FUSED3S_MIN_STACK_BYTES
                and c >= FUSED3S_MIN_CHANNELS and n * c >= FUSED3S_MIN_PLANES
                and fused3s.supports(cfg, cells_shape)):
            return "fused3s"
        return "fused3w"
    small = (n_queries <= FUSED2D_MAX_Q
             or n * n_queries <= FUSED2D_MAX_PAIRS)
    if small and fused2d.supports(cfg, cells_shape):
        return "fused2d"
    return "fused2w"


def run_plain(fn, *args):
    """The ``"plain"`` route: ``fn``, a plain PyTorch version, on the
    arguments' own device, counted in ``run_plain.launches``."""
    run_plain.launches += 1
    return fn(*args)


run_plain.launches = 0


class GridPlans:
    """The percell pair plan of the grid of one autograd chain, built at
    its first percell launch and reused by the others.  The plan is keyed
    on the grid's storage, shape, strides and version and on what the plan
    depends on, so a grid that is not the one it was built for (or was
    changed in place) gets a new one."""

    def __init__(self):
        self._key = None
        self._plan: Optional[percell.PairPlan] = None
        self.builds = 0

    def percell(self, grid: torch.Tensor, cells_shape,
                cfg: SamplerConfig) -> percell.PairPlan:
        key = (grid.device, grid.data_ptr(), tuple(grid.shape),
               tuple(grid.stride()), grid.dtype, grid._version,
               cells_shape[0], tuple(cells_shape[2:]), cfg.padding_mode,
               cfg.align_corners, cfg.multicell, cfg.strict_reference)
        if key != self._key:
            self._plan = percell.make_plan(grid, cells_shape, cfg)
            self._key = key
            self.builds += 1
        return self._plan


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
        return slab.blend(input, grid, cfg, orders)
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
        return slab.splat(gout, grid, in_spatial, cfg, orders)
    if route == "plain":
        return run_plain(blend_splat.plain_splat, gout, grid,
                         tuple(in_spatial), cfg, orders)
    return blend_splat.splat(gout, grid, in_spatial, cfg, orders)
