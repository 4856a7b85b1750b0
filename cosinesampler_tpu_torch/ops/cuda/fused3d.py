"""The small-cloud fused 3D blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused3d.py
(``pallas_fused3_blend`` / ``pallas_fused3_bwd``), the JAX route of the 3D
fused op for stacks within VMEM at point clouds too small for its other
generations: (N, C, D, H, W) cells at (Q, 3) shared points -> (7, C, Q)
rows value, d/dx, d/dy, d/dz, d2/dx2, d2/dy2, d2/dz2 summed over the
cells, and the exact transpose.  On the card the fused op routes here by
a measured rule (ops/cuda/route.py ``fused_rule``, PERF.md section 4).

* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, the same function; they are the oracle the kernels
  are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused3d.cu: fused3w's gather and scatter (csrc/texel_gather.cuh,
  csrc/texel_scatter.cuh, through csrc/fused.cu's launchers) in blocks of
  a few queries, a warp's lanes over one query's cells, so that a cloud
  of a few hundred points fills the card where fused3w's blocks of 128
  queries fill a few SMs.  ``geometry`` is the host's layout of both
  launches (the C entry points take it as integers and check it);
  chip_smoke.py's ``fused3d_layout_sweep_phase`` times it against
  ``blend_alternatives`` / ``bwd_alternatives``.  A tensor on the CPU
  takes the plain version; a CUDA tensor launches the kernel on the
  current stream, or raises for what the kernel does not take
  (``supports``).  Each wrapper counts its launches in its ``launches``
  attribute.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import SamplerConfig
from . import fused2w
from .fused2d import group_width
from .fused2w import gather_blend, plain_fused_blend, plain_fused_bwd
from .gather import QUERIES, GatherGeometry
from .scatter import ScatterGeometry, scatter_geometry

__all__ = ["BlendLayout", "BwdLayout", "Geometry", "blend_alternatives",
           "bwd_alternatives", "fused_blend", "fused_bwd", "geometry",
           "launch_blend", "launch_bwd", "plain_fused_blend",
           "plain_fused_bwd", "supports"]

# threads a block of either launch: four warps
THREADS = 128
# the most lanes over one query's cells: a warp
CELL_LANES = 32
# the blend reads the cells in place (planar) where it reads fewer cell
# values (N x Q x C) than PLANAR_POINTS_PER_TEXEL times the stack's plus
# PLANAR_VALUES, the texel-major copy otherwise; the bwd adds into the
# cotangent in place where it adds fewer (N x Q x C, each at 8 corners)
# than BWD_PLANAR_POINTS_PER_TEXEL times the stack's plus
# BWD_PLANAR_VALUES, into the zeroed texel-major scratch and the tiled
# transpose otherwise.  By device ms on the H100 80GB HBM3 at 700 W
# (chip_smoke.py fused3d_layout_sweep_phase, PERF.md section 6): the
# copy's and the scratch's passes over the stack cost little in the L2,
# where a warp's 32 lanes reading or adding one query's cells in 32
# planes take a sector each; at path (c) (50 x 4 x 16^3, 1 024 points,
# 205 k values) the blend tied (0.0123 against 0.0119 ms: planar, a
# launch fewer) and the bwd's scratch won (0.0118 against 0.0245); on
# 16 x 4 x 32^3 the copy lost at 2 048 points (0.0098 against 0.0122)
# and won at 4 096 (0.0129 against 0.0196); over the L2 (16 x 4 x 128^3)
# in place won up to 32 768 points (blend; the copy from 65 536) and
# 16 384 (bwd; the scratch from 32 768).  With the host in, its 60-130 us
# to enqueue a call hide these, and the faster read flips between calls.
PLANAR_POINTS_PER_TEXEL = 1 / 64
PLANAR_VALUES = 3 << 16
BWD_PLANAR_POINTS_PER_TEXEL = 1 / 128
BWD_PLANAR_VALUES = 1 << 16


class BlendLayout(NamedTuple):
    """One fused3d_blend launch: ``lanes`` (gather.py's GatherGeometry:
    width, groups, cell lanes, threads) over blocks of ``queries``
    queries in order, reading the cells in place where ``planar``, the
    texel-major copy otherwise."""
    lanes: GatherGeometry
    queries: int
    planar: bool = True

    def blocks(self, q: int) -> int:
        """Blocks along the queries."""
        return -(-q // self.queries)

    def args(self):
        """The layout as the C entry point takes it: width, groups, cell
        lanes, threads, queries a block, planar."""
        return (*self.lanes.args(), self.queries, int(self.planar))


class BwdLayout(NamedTuple):
    """One fused3d_bwd launch: ``lanes`` (scatter.py's ScatterGeometry:
    width, block groups, lane groups, lanes, threads) over blocks of
    ``queries`` queries in order, adding into the cotangent in place
    where ``planar``, into the texel-major scratch otherwise."""
    lanes: ScatterGeometry
    queries: int
    planar: bool = False

    def blocks(self, q: int) -> int:
        """Blocks along the queries."""
        return -(-q // self.queries)

    def args(self):
        """The layout as the C entry point takes it: width, block groups,
        lane groups, lanes, threads, queries a block, planar."""
        return (*self.lanes.args(), self.queries, int(self.planar))


class Geometry(NamedTuple):
    """Both launches' layouts for one (cells, points) shape."""
    blend: BlendLayout
    bwd: BwdLayout


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _queries(threads: int, lanes: int) -> int:
    """Queries a block of ``threads`` whose queries take ``lanes`` lanes
    each: one round of each warp, 32 // lanes queries a warp."""
    return min(QUERIES, threads // 32 * (32 // lanes))


def blend_planar(n: int, c: int, q: int, spatial) -> bool:
    """Whether the blend reads the cells in place: it reads fewer cell
    values (N x Q x C) than PLANAR_POINTS_PER_TEXEL times the stack's plus
    PLANAR_VALUES, where the copy (a pass over the whole stack and a
    launch, whatever Q) costs more than the sectors its records save."""
    return (n * q * c < PLANAR_POINTS_PER_TEXEL * n * c * math.prod(spatial)
            + PLANAR_VALUES)


def blend_lanes(n: int, c: int, cell_lanes: int = CELL_LANES,
                threads: int = THREADS) -> GatherGeometry:
    """A lane holds a channel group of at most 8 channels (fused_rows.cuh
    group_width; grid axis y walks the groups), ``cell_lanes`` lanes (a
    power of 2, at most N) split a query's cells."""
    return GatherGeometry(group_width(c), 1,
                          max(1, min(cell_lanes, _pow2_floor(n))), threads)


def blend_layout(n: int, c: int, q: int, spatial) -> BlendLayout:
    """The blend's layout: a warp over one query's cells (fewer lanes
    where N < 32, several queries a warp then), THREADS a block, one round
    a warp (4 queries a block at N >= 32: 1 024 points make 256 blocks),
    the cells in place by ``blend_planar``."""
    lanes = blend_lanes(n, c)
    return BlendLayout(lanes, _queries(lanes.threads, lanes.lanes),
                       blend_planar(n, c, q, spatial))


def bwd_planar(n: int, c: int, q: int, spatial) -> bool:
    """Whether the bwd adds into the cotangent in place: it adds fewer
    cell values (N x Q x C, at 8 corners each) than
    BWD_PLANAR_POINTS_PER_TEXEL times the stack's plus BWD_PLANAR_VALUES,
    where the scratch's fill and transpose (passes over the whole stack,
    whatever Q) cost more than the sectors its float4 reductions save."""
    return (n * q * c < BWD_PLANAR_POINTS_PER_TEXEL * n * c
            * math.prod(spatial) + BWD_PLANAR_VALUES)


def bwd_layout(n: int, c: int, q: int, spatial) -> BwdLayout:
    """The bwd's layout: scatter.py's lanes over (cell, channel group),
    groups of 4 channels at C a multiple of 4 (float4 reductions into the
    scratch), a warp or half of one a query, THREADS a block, one round a
    warp (fused3w_bwd's lanes in blocks of a few queries); into the
    cotangent in place by ``bwd_planar``."""
    lanes = scatter_geometry(n, c, dim=3)._replace(threads=THREADS)
    return BwdLayout(lanes, _queries(lanes.threads, lanes.lanes),
                     bwd_planar(n, c, q, spatial))


def geometry(n: int, c: int, q: int, spatial) -> Geometry:
    """Both launches' layouts for N cells of C channels over ``spatial``
    at Q points in query order."""
    return Geometry(blend_layout(n, c, q, spatial),
                    bwd_layout(n, c, q, spatial))


def _unique(alts):
    out = {}
    for name, lay in alts.items():
        if name == "rule" or lay not in out.values():
            out[name] = lay
    return out


def blend_alternatives(n: int, c: int, q: int, spatial):
    """The blend layouts chip_smoke.py's sweep times against the rule's,
    by name: the other read (the texel-major copy or planar), 8 and 16
    cell lanes, two and four rounds a warp (twice and four times the
    queries a block), 256 threads, and fused3w's blocks of 128 queries
    with two cell lanes; layouts equal to the rule's are left out."""
    rule = blend_layout(n, c, q, spatial)
    other = "texel-major copy" if rule.planar else "planar"
    alts = {"rule": rule, other: rule._replace(planar=not rule.planar)}
    for cell_lanes in (8, 16):
        lanes = blend_lanes(n, c, cell_lanes)
        alts[f"{cell_lanes} cell lanes"] = rule._replace(
            lanes=lanes, queries=_queries(THREADS, lanes.lanes))
    for rounds in (2, 4):
        alts[f"{rounds} rounds a warp"] = rule._replace(
            queries=min(QUERIES, rounds * rule.queries))
    wide = rule.lanes._replace(threads=2 * THREADS)
    alts["256 threads"] = rule._replace(lanes=wide, queries=_queries(
        wide.threads, wide.lanes))
    alts["fused3w's blocks"] = rule._replace(
        lanes=blend_lanes(n, c, 2, 2 * THREADS), queries=QUERIES)
    return _unique(alts)


def bwd_alternatives(n: int, c: int, q: int, spatial):
    """The bwd layouts chip_smoke.py's sweep times against the rule's, by
    name: the other destination (the texel-major scratch or planar), half
    the lanes a query, two and four rounds a warp, 256 threads, and
    fused3w's blocks of 128 queries; layouts equal to the rule's are left
    out."""
    rule = bwd_layout(n, c, q, spatial)
    other = "texel-major scratch" if rule.planar else "planar"
    alts = {"rule": rule, other: rule._replace(planar=not rule.planar)}
    half = rule.lanes._replace(lanes=max(1, rule.lanes.lanes // 2))
    alts["half the lanes"] = rule._replace(
        lanes=half, queries=_queries(THREADS, half.lanes))
    for rounds in (2, 4):
        alts[f"{rounds} rounds a warp"] = rule._replace(
            queries=min(QUERIES, rounds * rule.queries))
    wide = rule.lanes._replace(threads=2 * THREADS)
    alts["256 threads"] = rule._replace(lanes=wide, queries=_queries(
        wide.threads, wide.lanes))
    alts["fused3w's blocks"] = rule._replace(queries=QUERIES)
    return _unique(alts)


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """3D cells (N, C, D, H, W), every padding mode; any size and channel
    count (the 32-bit indexing aside, which the launch checks)."""
    return cfg.dim == 3 and len(cells_shape) == 5


def _check(cfg: SamplerConfig, cells_shape) -> None:
    if not supports(cfg, cells_shape):
        raise ValueError(
            f"fused3d takes a 3D config and cells (N, C, D, H, W); got dim "
            f"{cfg.dim} and cells {tuple(cells_shape)}")


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, lay: BlendLayout) -> torch.Tensor:
    """fused3d_blend with the layout ``lay``, on the card; not counted."""
    _check(cfg, tuple(cells.shape))
    return gather_blend("fused3d_blend", cells, points, cfg, lay)


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               lay: BwdLayout) -> torch.Tensor:
    """fused3d_bwd with the layout ``lay``, on the card; not counted."""
    _check(cfg, (n_cells, *g.shape[1:2], *in_spatial))
    return fused2w.launch_bwd(g, points, tuple(in_spatial), cfg, n_cells,
                              lay, entry="fused3d_bwd")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig) -> torch.Tensor:
    """(7, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, D, H, W)
    cells at (Q, 3) points; kernel on CUDA tensors, plain on CPU ones."""
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
    """(N, C, D, H, W) cells cotangent of fused_blend for the (7, C, Q)
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
