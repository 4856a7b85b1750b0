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

``GridPlans`` carries percell's pair plan along one autograd chain: the
nested 3D trainer makes some 200 blend/splat launches on one grid a step,
and each takes the plan built at the chain's first percell launch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import SamplerConfig
from . import blend_splat, percell, slab

__all__ = ["GridPlans", "blend", "pick", "rule", "splat"]

# a cell up to this many bytes fits one block's shared memory (the H100's
# opt-in limit per block): slab stages it whole, and splat_o accumulates
# it there (csrc/blend_splat.cu)
CELL_SMEM_BYTES = 227 * 1024
# a stack up to this many bytes keeps splat_o's global atomics in L2 (the
# H100's 50 MB): blend_o / splat_o won or tied there (16 x 4 x 32^3)
STACK_L2_BYTES = 50 * 10**6
# fewest (cell, query) pairs at which percell, its plan reused along the
# chain, and slab beat blend_o / splat_o over a stack larger than L2
# (percell at 128^3: 2^20 won, 2^18 lost; slab at 16^3: 2^20 won, 2^18
# within noise; PERF.md section 4)
MIN_PAIRS = 1 << 20


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
    if cell_bytes > CELL_SMEM_BYTES:
        return "percell"
    return "slab" if slab.supports(cfg, cells_shape) else "blend_o"


def pick(cfg: SamplerConfig, cells_shape: Tuple[int, ...],
         first: torch.Tensor, grid: torch.Tensor) -> str:
    """The route of one call: ``rule`` for CUDA f32 tensors; "blend_o"
    otherwise, whose wrapper takes the plain version on the CPU and raises
    for what its kernel does not take."""
    if (first.device.type != "cuda" or grid.device.type != "cuda"
            or first.dtype != torch.float32 or grid.dtype != torch.float32):
        return "blend_o"
    return rule(cfg, cells_shape,
                cells_shape[0] * math.prod(grid.shape[1:-1]))


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
    return blend_splat.splat(gout, grid, in_spatial, cfg, orders)
