"""The small-cloud fused 2D blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused2d.py
(``pallas_fused2_blend`` / ``pallas_fused2_bwd``), the JAX route of the 2D
fused op for point clouds too small for fused2w's bins: (N, C, H, W) cells
at (Q, 2) shared points -> (5, C, Q) rows value, d/dx, d/dy, d2/dx2,
d2/dy2 summed over the cells, and the exact transpose.  On the card the
fused op routes here by a measured rule (ops/cuda/route.py ``fused_rule``,
PERF.md section 4).

* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, the same function; they are the oracle the kernels
  are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused2d.cu (their body is csrc/staged_cells.cuh), which serve each
  block's queries from a chunk of cells staged in shared memory.  A
  tensor on the CPU takes the plain version; a CUDA tensor launches the
  kernel on the current stream, or raises for what the kernel does not
  take (``supports``).  Each wrapper counts its launches in its
  ``launches`` attribute.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import SamplerConfig
from .build import BLOCK_SMEM_BYTES
from .fused2w import (kernel_blend, kernel_bwd, plain_fused_blend,
                      plain_fused_bwd)

__all__ = ["fused_blend", "fused_bwd", "group_width", "plain_fused_blend",
           "plain_fused_bwd", "supports"]


def group_width(c: int, most: int = 8) -> int:
    """The width of the channel groups the channel-looped kernels walk:
    csrc/fused_rows.cuh ``group_width`` (kGroupChannels = 8), as few equal
    groups as hold ``most`` channels each."""
    groups = max(1, -(-c // most))
    return -(-c // groups)


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """2D cells whose channel group of one cell fits a block's shared
    memory, the rule csrc/staged_cells.cuh ``make_plan`` checks against the
    device's limit."""
    if cfg.dim != 2 or len(cells_shape) != 4:
        return False
    return (4 * group_width(cells_shape[1]) * math.prod(cells_shape[2:])
            <= BLOCK_SMEM_BYTES)


def _check(cfg: SamplerConfig, cells_shape) -> None:
    if not supports(cfg, cells_shape):
        raise ValueError(
            f"fused2d takes 2D cells whose channel group fits "
            f"{BLOCK_SMEM_BYTES} bytes of shared memory; got dim {cfg.dim} "
            f"and cells {tuple(cells_shape)}")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(5, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, H, W)
    cells at (Q, 2) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    _check(cfg, tuple(cells.shape))
    out = kernel_blend("fused2d_blend", 2, cells, points, cfg)
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, H, W) cells cotangent of fused_blend for the (5, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    _check(cfg, (n_cells, *g.shape[1:2], *in_spatial))
    dcells = kernel_bwd("fused2d_bwd", 2, g, points, tuple(in_spatial), cfg,
                        n_cells)
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
