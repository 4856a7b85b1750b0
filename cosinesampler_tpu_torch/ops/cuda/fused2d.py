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
  csrc/fused2d.cu: fused2w's gather and scatter (csrc/texel_gather.cuh,
  csrc/texel_scatter.cuh, through csrc/fused.cu's launchers) in blocks of
  a few queries, a warp's lanes over one query's cells, so that a cloud
  of a few hundred points fills the card where fused2w's blocks of 128
  queries fill a few SMs.  ``geometry`` is the host's layout of both
  launches, ops/cuda/small_cloud.py's rule (shared with fused3d) with
  this module's measured planar bounds (``RULE``); chip_smoke.py's
  ``fused2d_layout_sweep_phase`` times it against ``blend_alternatives``
  / ``bwd_alternatives``.  A tensor on the CPU takes the plain version; a
  CUDA tensor launches the kernel on the current stream, or raises for
  what the kernel does not take (``supports``).  Each wrapper counts its
  launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import SamplerConfig
from . import fused2w
from .fused2w import gather_blend, plain_fused_blend, plain_fused_bwd
from .small_cloud import (CELL_LANES, THREADS, BlendLayout, BwdLayout,
                          Geometry, Rule)

__all__ = ["CELL_LANES", "RULE", "THREADS", "BlendLayout", "BwdLayout",
           "Geometry", "blend_alternatives", "bwd_alternatives",
           "fused_blend", "fused_bwd", "geometry", "launch_blend",
           "launch_bwd", "plain_fused_blend", "plain_fused_bwd", "supports"]

# the blend reads the cells in place (planar) where it reads fewer cell
# values (N x Q x C) than PLANAR_POINTS_PER_TEXEL times the stack's plus
# PLANAR_VALUES, the texel-major copy otherwise; the bwd adds into the
# cotangent in place where it adds fewer (N x Q x C, each at 4 corners)
# than BWD_PLANAR_POINTS_PER_TEXEL times the stack's plus
# BWD_PLANAR_VALUES, into the zeroed texel-major scratch and the tiled
# transpose otherwise; its warps take two rounds of queries where one
# round's blocks would number BWD_ROUND_BLOCKS or more.  By device ms on
# the H100 80GB HBM3 at 700 W (chip_smoke.py fused2d_layout_sweep_phase,
# PERF.md section 6): at path (b)'s 96 x 4 x 16^2 the blend's planar read
# won at 200 points (0.0074 against 0.0080 ms), tied at 512 and lost from
# 1 024 (0.0104 against 0.0080), where 32 lanes reading one query's cells
# in 32 planes take a sector each; on 16 x 4 x 1024^2 (over the L2)
# planar won up to 16 384 points and lost at 65 536 (0.386 against
# 0.250); the one point it misses is 8 cells at 8 192 (planar 10%
# faster).  The bwd's scratch won at 96 cells from 200 points (0.0077
# against 0.0098) and at 8 cells from 2 048 (0.0067 against 0.0108); in
# place won up to 16 384 values added and, over the L2, up to 16 384
# points on 1024^2 (0.270 against 0.310).  Two rounds a warp won where
# one round made 1 024 blocks (96 cells at 4 096 points: 0.0159 against
# 0.0192; 32 cells: 0.0105 against 0.0123) and tied at 512.
PLANAR_POINTS_PER_TEXEL = 1 / 64
PLANAR_VALUES = 3 << 16
BWD_PLANAR_POINTS_PER_TEXEL = 1 / 64
BWD_PLANAR_VALUES = 1 << 15
BWD_ROUND_BLOCKS = 1024
RULE = Rule(PLANAR_POINTS_PER_TEXEL, PLANAR_VALUES,
            BWD_PLANAR_POINTS_PER_TEXEL, BWD_PLANAR_VALUES, BWD_ROUND_BLOCKS)
blend_layout = RULE.blend_layout
bwd_layout = RULE.bwd_layout
geometry = RULE.geometry
blend_alternatives = RULE.blend_alternatives
bwd_alternatives = RULE.bwd_alternatives


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """2D cells (N, C, H, W), every padding mode; any size and channel
    count (the 32-bit indexing aside, which the launch checks)."""
    return cfg.dim == 2 and len(cells_shape) == 4


def _check(cfg: SamplerConfig, cells_shape) -> None:
    if not supports(cfg, cells_shape):
        raise ValueError(
            f"fused2d takes a 2D config and cells (N, C, H, W); got dim "
            f"{cfg.dim} and cells {tuple(cells_shape)}")


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, lay: BlendLayout) -> torch.Tensor:
    """fused2d_blend with the layout ``lay``, on the card; not counted."""
    _check(cfg, tuple(cells.shape))
    return gather_blend("fused2d_blend", cells, points, cfg, lay)


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               lay: BwdLayout) -> torch.Tensor:
    """fused2d_bwd with the layout ``lay``, on the card; not counted."""
    _check(cfg, (n_cells, *g.shape[1:2], *in_spatial))
    return fused2w.launch_bwd(g, points, tuple(in_spatial), cfg, n_cells,
                              lay, entry="fused2d_bwd")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(5, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, H, W)
    cells at (Q, 2) points; kernel on CUDA tensors, plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    n, c, *spatial = cells.shape
    out = launch_blend(cells, points, cfg,
                       blend_layout(n, c, points.shape[0], spatial))
    fused_blend.launches += 1
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig,
              n_cells: int) -> torch.Tensor:
    """(N, C, H, W) cells cotangent of fused_blend for the (5, C, Q)
    cotangent ``g``; kernel on CUDA tensors, plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    dcells = launch_bwd(
        g, points, in_spatial, cfg, n_cells,
        bwd_layout(n_cells, g.shape[1], points.shape[0], in_spatial))
    fused_bwd.launches += 1
    return dcells


fused_blend.launches = 0
fused_bwd.launches = 0
