"""The z-sorted fused 3D blend and its cells transpose.

Counterpart of the JAX package's ops/pallas/fused3s.py
(``pallas_fused3s_blend`` / ``pallas_fused3s_bwd``), the JAX route of the
3D fused op for mid volumes at point clouds too small for fused3w's bins:
(N, C, D, H, W) cells at (Q, 3) shared points -> (7, C, Q) rows value,
d/dx, d/dy, d/dz, d2/dx2, d2/dy2, d2/dz2 summed over the cells, and the
exact transpose, in zeros and border padding.  On the card the fused op
routes here by a measured rule (ops/cuda/route.py ``fused_rule``, PERF.md
section 4).

* **The z sort** (``zsort``): the JAX package's ``_zbin`` without its
  per-bin block padding, built on the device with no host sync.  Each
  query's key is the floor of its folded shared z base (fused3b.py
  ``bin_base``) clamped to [Z_LO, D - 1], less Z_LO; ``perm`` is the
  stable sort of the keys, and ``table`` holds, for each of the static
  bound cdiv(Q, Q_BLOCK) + D - Z_LO blocks, its bin, its first sorted
  slot and its query count (0 past the last block).
* The plain versions are ops/cuda/fused2w.py's ``plain_fused_blend`` /
  ``plain_fused_bwd``, the same function; they are the oracle the kernels
  are held to.
* ``fused_blend`` / ``fused_bwd`` wrap the hand-written CUDA kernels in
  csrc/fused3s.cu, whose blocks each serve queries of one bin, their
  corners within three z slabs of each cell.
  Each takes the sort as ``order`` or makes its own; the fused op sorts
  once for a blend and its transpose.  The blend copies the cells into a
  texel-major (D, H, W, N, C) temporary with a tiled transpose, gathers
  from it with a few lanes a query (csrc/texel_gather.cuh, shared with
  fused3b_blend; layouts ops/cuda/gather.py), so that one warp
  instruction reads whole sectors, and writes each query's rows to a
  (Q, 7, C) temporary that the transpose turns into (7, C, Q); below
  PLANAR_POINTS_PER_TEXEL points a texel (``planar``), where the copy
  costs more than it saves, the gather reads the cells in place.  The
  transpose's lanes run over (query, cell) (csrc/texel_scatter.cuh,
  shared with fused3b_bwd) and add into a texel-major scratch, so that
  neighbouring lanes add neighbouring 16-byte records of one texel; the
  tiled transpose in the same entry point writes the (N, C, D, H, W)
  cotangent.  A
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
from .build import check, load_kernels
from .fused2w import (check_kernel_inputs, cuda_device, plain_fused_blend,
                      plain_fused_bwd, sampler_args)
from .fused3b import bin_base, vol_layout
from .gather import GatherGeometry, gather_geometry
from .scatter import ScatterGeometry, scatter_geometry

__all__ = ["PADDING_MODES", "PLANAR_POINTS_PER_TEXEL", "Q_BLOCK", "Z_LO",
           "fused_blend", "fused_bwd", "launch_blend", "launch_bwd", "planar",
           "plain_fused_blend", "plain_fused_bwd", "supports", "zsort"]

# queries a block serves at most (csrc/fused3s.cu kQBlock)
Q_BLOCK = 128
# the lowest bin's z floor: fz = -2 still has a corner at z = 0
# (fused3s._ZLO)
Z_LO = -2
# points per texel of a cell below which fused3s_blend reads the cells in
# place instead of through a texel-major copy (planar): on 16 x 4 x 128^3
# planar won at 100 000 points (0.048 a texel; 0.4960 ms against 0.6209)
# and lost at 200 000 (0.095; 0.8395 against 0.7403), and on 64^3 it
# lost from 49 152 points (0.19) up (chip_smoke.py gather_sweep_phase,
# PERF.md section 6)
PLANAR_POINTS_PER_TEXEL = 0.05
# the JAX kernels' padding modes (prep.FUSED_PADDING_MODES): reflection's
# fold can reverse the per-cell shift, sending corners outside the bin's
# three slabs
PADDING_MODES = ("zeros", "border")


def supports(cfg: SamplerConfig, cells_shape) -> bool:
    """3D cells in zeros or border padding, any size (csrc/fused3s.cu
    reads the cells in place)."""
    return (cfg.dim == 3 and len(cells_shape) == 5
            and cfg.padding_mode in PADDING_MODES)


def zsort(points: torch.Tensor, d: int, cfg: SamplerConfig,
          q_block: int = Q_BLOCK):
    """``(perm, table)`` of (Q, 3) points over D z slabs, on the points'
    device, with no host sync.

    ``perm`` (Q,) int32 lists the queries in stable order of their key
    ``clamp(floor(bin_base(z)), Z_LO, D - 1) - Z_LO`` (computed from the
    points cast to f32, as the JAX package's ``_zbin``).  ``table``
    (NB, 3) int32, NB = cdiv(Q, q_block) + D - Z_LO, gives each block's
    bin, first slot of ``perm`` and query count: each bin's queries fill
    whole blocks of ``q_block`` in order, the last one partly, and the
    blocks past the last are empty (count 0).  The blocks that hold
    queries are the JAX package's non-empty padded blocks, in order.
    """
    q = points.shape[0]
    device = points.device
    nbins = d - Z_LO
    base = bin_base(points.detach()[:, 2].to(torch.float32), d, cfg)
    fz = torch.floor(base).nan_to_num_(nan=0.0).clamp_(Z_LO, d - 1)
    key = (fz - Z_LO).to(torch.int64)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    counts = torch.zeros((nbins,), dtype=torch.int64, device=device)
    counts.index_add_(0, key, torch.ones_like(key))
    blocks = (counts + q_block - 1) // q_block
    block_end = torch.cumsum(blocks, 0)
    block_start = block_end - blocks
    slot_start = torch.cumsum(counts, 0) - counts
    nb = -(-q // q_block) + nbins
    b = torch.arange(nb, dtype=torch.int64, device=device)
    # each block's bin: the first whose blocks end after it; nbins past
    # the last block
    bins = torch.searchsorted(block_end, b, right=True)
    real = bins < nbins
    bins = bins.clamp_(max=nbins - 1)
    local = (b - block_start[bins]) * q_block
    count = torch.where(real, (counts[bins] - local).clamp(0, q_block), 0)
    table = torch.stack([bins, slot_start[bins] + local, count], dim=1)
    return perm, table.to(torch.int32).contiguous()


def _launch(entry: str, first: torch.Tensor, points: torch.Tensor,
            outs, cfg: SamplerConfig, n: int, c: int,
            spatial: Tuple[int, ...], order, extra=()) -> None:
    """Launch ``entry`` on ``first`` (cells or g), the points, their z sort
    and the output tensors ``outs``, then ``extra`` after the table's
    block count."""
    out = outs[-1]
    cuda_device(first, points, *outs)
    check_kernel_inputs(cfg, first, points)
    if not supports(cfg, (n, c, *spatial)):
        raise ValueError(
            f"fused3s takes 3D cells in {PADDING_MODES} padding; got dim "
            f"{cfg.dim}, padding {cfg.padding_mode!r} and cells "
            f"{(n, c, *spatial)}")
    if n * c * math.prod(spatial) >= 2**31:
        raise ValueError("cell stack too large for the kernels' 32-bit "
                         "indexing")
    perm, table = order if order is not None else zsort(points, spatial[0],
                                                        cfg)
    if perm.shape != (points.shape[0],) or table.dim() != 2:
        raise ValueError("order is zsort's (perm, table) of these points")
    lib = load_kernels()
    with torch.cuda.device(out.device):
        err = getattr(lib, entry)(
            first.data_ptr(), points.data_ptr(), perm.data_ptr(),
            table.data_ptr(), *(t.data_ptr() for t in outs), n, c, *spatial,
            points.shape[0], table.shape[0], *extra,
            *sampler_args(cfg, n, out.device))
    check(lib, err, f"{entry} launch")


def fused_blend(cells: torch.Tensor, points: torch.Tensor,
                cfg: SamplerConfig, order=None) -> torch.Tensor:
    """(7, C, Q) multicell-summed value/jac/diag-Hessian of (N, C, D, H, W)
    cells at (Q, 3) points; kernel on CUDA tensors (``order``: the points'
    zsort, made here if None), plain on CPU ones."""
    if cells.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_blend(cells, points, cfg)
    if cells.dim() != 5 or points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"fused3s_blend takes cells (N, C, D, H, W) and "
                         f"points (Q, 3); got {tuple(cells.shape)} and "
                         f"{tuple(points.shape)}")
    out = launch_blend(cells, points, cfg, order,
                       gather_geometry(cells.shape[0], cells.shape[1]),
                       planar(points.shape[0], cells.shape[2:]))
    fused_blend.launches += 1
    return out


def planar(q: int, spatial) -> bool:
    """Whether fused3s_blend reads the cells in place (planar) rather than
    through a texel-major copy: below PLANAR_POINTS_PER_TEXEL points per
    texel of a cell, where the copy, which costs the stack's bytes read
    and written whatever Q, outweighs the sectors the texel-major reads
    save a query."""
    return q < PLANAR_POINTS_PER_TEXEL * math.prod(spatial)


def launch_blend(cells: torch.Tensor, points: torch.Tensor,
                 cfg: SamplerConfig, order, geom: GatherGeometry,
                 planar: bool = False) -> torch.Tensor:
    """fused_blend's kernels with the launch layout ``geom``
    (ops/cuda/gather.py), on the card; not counted.  A tiled transpose
    copies the cells into a texel-major (D, H, W, N, C) temporary (not
    where ``planar``: the gather then reads the cells a channel a load),
    the gather writes each query's rows to a (Q, 7, C) temporary, and the
    transpose writes them out in (7, C, Q) layout; the temporaries are
    freed on return."""
    n, c, *spatial = cells.shape
    q = points.shape[0]
    vol = cells if planar else torch.empty(
        vol_layout(n, c, spatial), dtype=torch.float32, device=cells.device)
    rows = torch.empty((q, 7, c), dtype=torch.float32, device=cells.device)
    out = torch.empty((7, c, q), dtype=torch.float32, device=cells.device)
    _launch("fused3s_blend", cells, points, (vol, rows, out), cfg, n, c,
            tuple(spatial), order, (*geom.args(), int(planar)))
    return out


def fused_bwd(g: torch.Tensor, points: torch.Tensor,
              in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
              order=None) -> torch.Tensor:
    """(N, C, D, H, W) cells cotangent of fused_blend for the (7, C, Q)
    cotangent ``g``; kernel on CUDA tensors (``order`` as for
    fused_blend), plain on CPU ones."""
    if g.device.type == "cpu" and points.device.type == "cpu":
        return plain_fused_bwd(g, points, tuple(in_spatial), cfg, n_cells)
    if (g.dim() != 3 or g.shape[0] != 7 or len(in_spatial) != 3
            or points.shape != (g.shape[2], 3)):
        raise ValueError(f"fused3s_bwd takes g (7, C, Q), points (Q, 3) and "
                         f"3 spatial sizes; got {tuple(g.shape)}, "
                         f"{tuple(points.shape)}, {tuple(in_spatial)}")
    dcells = launch_bwd(g, points, tuple(in_spatial), cfg, n_cells, order,
                        scatter_geometry(n_cells, g.shape[1], dense=True))
    fused_bwd.launches += 1
    return dcells


def launch_bwd(g: torch.Tensor, points: torch.Tensor,
               in_spatial: Tuple[int, ...], cfg: SamplerConfig, n_cells: int,
               order, geom: ScatterGeometry) -> torch.Tensor:
    """fused_bwd's kernels with the launch layout ``geom``
    (ops/cuda/scatter.py), on the card; not counted.  The scatter adds
    into a zeroed texel-major (D, H, W, N, C) scratch, which a tiled
    transpose writes out in (N, C, D, H, W) layout."""
    c = g.shape[1]
    scratch = torch.zeros(vol_layout(n_cells, c, in_spatial),
                          dtype=torch.float32, device=g.device)
    out = torch.empty((n_cells, c, *in_spatial), dtype=torch.float32,
                      device=g.device)
    _launch("fused3s_bwd", g, points, (scratch, out), cfg, n_cells, c,
            in_spatial, order, geom.args())
    return out


fused_blend.launches = 0
fused_bwd.launches = 0
