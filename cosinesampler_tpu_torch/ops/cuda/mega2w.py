"""The whole 2D PINN train-step gradient in one launch.

Counterpart of the JAX package's ops/pallas/mega2w.py: the value and
gradient of the fused PINN loss (models/pinn.py ``loss_fused_slots``) with
respect to the cells and the MLP, for one tanh hidden layer and the
allen_cahn / helmholtz residuals.  Two versions:

* ``plain_mega2w_step``: plain PyTorch, no autograd inside.  The fused
  rows (``plain_fused_blend``), the closed-form MLP forward, its
  hand-derived backward and the cells transpose (``plain_fused_bwd``) of
  the feature cotangent.  It is the oracle the kernel is held to.
* ``mega2w_step``: the wrapper of the hand-written CUDA kernel in
  csrc/mega2w.cu.  Tensors on the CPU take the plain version; CUDA tensors
  launch the kernel on the current stream, or raise for what the kernel
  does not take.  It counts its launches in ``mega2w_step.launches``.

The MLP is passed as its four tensors in the params' layouts: the JAX
package's ``pack_mlp`` is a TPU VMEM tile layout and has no counterpart.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..config import SamplerConfig
from .build import (BLOCK_SMEM_BYTES, H100_SMS, RESERVED_SMEM_BYTES,
                    SM_SMEM_BYTES, check, load_kernels)
from .fused2w import (check_kernel_inputs, cuda_device, plain_fused_blend,
                      plain_fused_bwd, sampler_args)

__all__ = ["MegaGeometry", "geometry", "launch_step", "mega2w_step",
           "plain_mega2w_step", "supports"]

PDE_IDS = {"allen_cahn": 0, "helmholtz": 1}
# the JAX kernel's bounds: C + 4 <= 128 (its MLP tile) and 32 hidden rows
# (csrc/mega2w.cu kMaxHidden)
MAX_CHANNELS = 124
MAX_HIDDEN = 32
# csrc/fused_rows.cuh kMaxChannels: above it the kernel keeps the feature
# rows and their cotangents in a scratch of 10 * C * Q floats
REGISTER_CHANNELS = 8
# the register path's blocks an SM (csrc/mega2w.cu mega2w_staged_kernel's
# launch bounds: 64 registers a thread up to this many channels, 128 above)
TWO_BLOCKS_CHANNELS = 4
# the staged path's scratch (partial rows and cotangents) at most: above
# it, the global path
SCRATCH_LIMIT_BYTES = 1 << 30
# the fewest queries of a slice: one round of the kernel's 512 threads
MIN_SLICE_QUERIES = 512


class MegaGeometry(NamedTuple):
    """One mega2w launch's work units (csrc/mega2w.cu MegaGeom): ``chunks``
    of ``cells`` cells (0 chunks: the global path, corners gathered through
    L1/L2 and the splat added with global atomics), ``stride`` floats a
    cell in shared memory, ``slices`` of ``q_per_slice`` queries, and the
    ``lanes`` cells a warp's lanes split over in the splat."""
    chunks: int
    cells: int
    stride: int
    slices: int
    q_per_slice: int
    lanes: int


GLOBAL_PATH = MegaGeometry(0, 0, 0, 0, 0, 0)


def _head_bytes(c: int, hidden: int) -> int:
    """Shared memory ahead of a staged block's cells: the MLP, its gradient
    row and the mbarrier (csrc/mega2w.cu staged_head)."""
    row = (c + 2) * hidden + 2
    return 4 * ((2 * row + 3) // 4 * 4 + 4)


def geometry(n: int, c: int, h: int, w: int, q: int, hidden: int,
             sms: int = H100_SMS) -> MegaGeometry:
    """The work units of mega2w over (N, C, H, W) cells and Q queries on a
    card of ``sms`` SMs.

    Above REGISTER_CHANNELS channels the wide kernel takes the call
    (GLOBAL_PATH, ignored).  Otherwise a block (two an SM up to
    TWO_BLOCKS_CHANNELS channels) stages the most cells its share of the
    SM's shared memory holds, each stride padded to 4 floats past a
    multiple of 32 when several fit (8 cells then sit in 8 distinct bank
    quads); the cells split into as few chunks as that allows, of equal
    size but the last, and the queries into as many slices (of at least
    MIN_SLICE_QUERIES) as leave one unit a block.  A cell that no block
    can stage, or a scratch over SCRATCH_LIMIT_BYTES, takes the global
    path."""
    if c > REGISTER_CHANNELS:
        return GLOBAL_PATH
    cell = c * h * w
    head = _head_bytes(c, hidden)
    padded = (cell + 27) // 32 * 32 + 4
    for per_sm in ((2, 1) if c <= TWO_BLOCKS_CHANNELS else (1,)):
        budget = min(BLOCK_SMEM_BYTES,
                     SM_SMEM_BYTES // per_sm - RESERVED_SMEM_BYTES) - head
        stride = padded if 2 * 4 * padded <= budget else -(-cell // 4) * 4
        most = budget // (4 * stride)
        if most >= 1:
            break
    else:
        return GLOBAL_PATH
    chunks = -(-n // most)
    cells = -(-n // chunks)
    chunks = -(-n // cells)
    if 4 * (chunks + 1) * 5 * c * q > SCRATCH_LIMIT_BYTES:
        return GLOBAL_PATH
    slices = max(1, min(per_sm * sms // chunks, q // MIN_SLICE_QUERIES))
    q_per_slice = -(-max(q, 1) // slices)
    lanes = 1
    while lanes < 8 and 2 * lanes <= cells:
        lanes *= 2
    return MegaGeometry(chunks, cells, stride, -(-max(q, 1) // q_per_slice),
                        q_per_slice, lanes)


def supports(cfg: SamplerConfig, cells_shape, pde: str, hidden: int) -> bool:
    """True when the kernel takes this configuration; ``mega2w_step`` on
    CUDA tensors raises for any other."""
    return (cfg.dim == 2 and len(cells_shape) == 4
            and 1 <= cells_shape[1] <= MAX_CHANNELS
            and 1 <= hidden <= MAX_HIDDEN and pde in PDE_IDS
            and cfg.precision in ("exact", "highest")
            and not (cfg.strict_reference and not cfg.align_corners))


def _cotangents(pde: str, u, u_d, u_dd, q: int):
    """The residual r and d(sum r^2 / q) / d(u, u_x, u_y, u_xx, u_yy)."""
    zero = torch.zeros_like(u)
    if pde == "allen_cahn":
        # r = 2 u_y + 5 u^3 - 5 u - 1e-4 u_xx
        r = 2.0 * u_d[1] + 5.0 * u**3 - 5.0 * u - 1e-4 * u_dd[0]
        g_r = 2.0 * r / q
        return r, g_r * (15.0 * u * u - 5.0), [zero, 2.0 * g_r], \
            [-1e-4 * g_r, zero]
    if pde == "helmholtz":
        # r = u_xx + u_yy + u
        r = u_dd[0] + u_dd[1] + u
        g_r = 2.0 * r / q
        return r, g_r, [zero, zero], [g_r, g_r]
    raise ValueError(f"unknown pde {pde!r}")


@torch.no_grad()
def plain_mega2w_step(cells, w1, b1, w2, b2, points, cfg: SamplerConfig,
                      pde: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of pinn.loss_fused_slots with the identity slot plan:
    loss = sum r^2 / Q, grads {"cells", "w1", "b1", "w2", "b2"} in the
    params' layouts.  The MLP backward is the hand derivation of
    csrc/mega2w.cu, with a_k = W1^T f_k, b_k = W1^T f_kk (k = x, y)."""
    n, _, *spatial = cells.shape
    q = points.shape[0]
    feats = plain_fused_blend(cells, points, cfg)          # (5, C, Q)

    def lin(z):                                            # (C, Q) -> (Hd, Q)
        return torch.einsum("ch,cq->hq", w1, z)

    w2v = w2[:, 0]
    h = torch.tanh(lin(feats[0]) + b1[:, None])
    d1 = 1.0 - h * h
    d2 = -2.0 * h * d1
    d3 = (6.0 * h * h - 2.0) * d1
    a = [lin(feats[1]), lin(feats[2])]
    b = [lin(feats[3]), lin(feats[4])]
    u = torch.einsum("h,hq->q", w2v, h) + b2[0]
    u_d = [torch.einsum("h,hq->q", w2v, d1 * a[k]) for k in range(2)]
    u_dd = [torch.einsum("h,hq->q", w2v, d2 * a[k] * a[k] + d1 * b[k])
            for k in range(2)]
    r, g_u, g_ud, g_udd = _cotangents(pde, u, u_d, u_dd, q)

    inner = g_u * d1                                       # (Hd, Q)
    g_w2 = g_u * h
    g_a, g_b = [], []
    for k in range(2):
        inner = inner + g_ud[k] * d2 * a[k] + g_udd[k] * (
            d3 * a[k] * a[k] + d2 * b[k])
        g_w2 = g_w2 + g_ud[k] * d1 * a[k] + g_udd[k] * (
            d2 * a[k] * a[k] + d1 * b[k])
        g_a.append(w2v[:, None] * (g_ud[k] * d1 + 2.0 * g_udd[k] * d2 * a[k]))
        g_b.append(w2v[:, None] * (g_udd[k] * d1))
    g_pre = w2v[:, None] * inner
    rows = [g_pre, g_a[0], g_a[1], g_b[0], g_b[1]]          # per feature row
    g_w1 = sum(torch.einsum("cq,hq->ch", feats[i], rows[i]) for i in range(5))
    g_feats = torch.stack([w1 @ row for row in rows])      # (5, C, Q)
    grads = {
        "cells": plain_fused_bwd(g_feats, points, tuple(spatial), cfg, n),
        "w1": g_w1,
        "b1": g_pre.sum(dim=1),
        "w2": g_w2.sum(dim=1)[:, None],
        "b2": g_u.sum()[None],
    }
    return torch.sum(r * r) / q, grads


def mega2w_step(cells, w1, b1, w2, b2, points, cfg: SamplerConfig,
                pde: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of the 2D fused PINN loss for (N, C, H, W) cells, the
    MLP w1 (C, Hd), b1 (Hd,), w2 (Hd, 1), b2 (1,) and (Q, 2) points; kernel
    on CUDA tensors, plain on CPU ones.  The loss is a 0-dim tensor."""
    tensors = (cells, w1, b1, w2, b2, points)
    if all(t.device.type == "cpu" for t in tensors):
        return plain_mega2w_step(*tensors, cfg, pde)
    device = cuda_device(*tensors)
    check_kernel_inputs(cfg, *tensors)
    if cfg.dim != 2 or cells.dim() != 4 or points.dim() != 2 \
            or points.shape[1] != 2:
        raise ValueError(f"mega2w takes a 2D config, cells (N, C, H, W) and "
                         f"points (Q, 2); got dim {cfg.dim}, "
                         f"{tuple(cells.shape)} and {tuple(points.shape)}")
    n, c, h, w = cells.shape
    hidden = w1.shape[-1]
    if (w1.shape != (c, hidden) or b1.shape != (hidden,)
            or w2.shape != (hidden, 1) or b2.shape != (1,)):
        raise ValueError(
            f"expected w1 ({c}, Hd), b1 (Hd,), w2 (Hd, 1), b2 (1,); got "
            f"{[tuple(t.shape) for t in (w1, b1, w2, b2)]}")
    if pde not in PDE_IDS:
        raise ValueError(f"unknown pde {pde!r}")
    if not supports(cfg, cells.shape, pde, hidden):
        raise NotImplementedError(
            f"mega2w takes at most {MAX_CHANNELS} channels and "
            f"{MAX_HIDDEN} hidden units, got {c} and {hidden}")
    if cells.numel() >= 2**31:
        raise ValueError("cell stack too large for the kernel's 32-bit "
                         "indexing")
    geom = GLOBAL_PATH
    if c <= REGISTER_CHANNELS:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        geom = geometry(n, c, h, w, points.shape[0], hidden, sms)
    loss, grads = launch_step(cells, w1, b1, w2, b2, points, cfg, pde, geom)
    mega2w_step.launches += 1
    return loss, grads


def launch_step(cells, w1, b1, w2, b2, points, cfg: SamplerConfig, pde: str,
                geom: MegaGeometry):
    """mega2w of checked CUDA inputs with the work units ``geom``: (loss,
    grads) as ``mega2w_step`` gives them, on the card."""
    n, c, h, w = cells.shape
    hidden = w1.shape[-1]
    q = points.shape[0]
    device = cells.device
    # one zeroed buffer: the cells gradient, then the gradient row dW1
    # (C, Hd), db1, dw2, db2 and the loss (csrc/mega2w.cu)
    ncell = cells.numel()
    out = torch.zeros((ncell + (c + 2) * hidden + 2,), dtype=torch.float32,
                      device=device)
    if c > REGISTER_CHANNELS:
        scratch = torch.empty((10 * c * q,), dtype=torch.float32,
                              device=device)
    elif geom.chunks:
        scratch = torch.empty(((geom.chunks + 1) * 5 * c * q,),
                              dtype=torch.float32, device=device)
    else:
        scratch = None
    lib = load_kernels()
    with torch.cuda.device(device):
        err = lib.mega2w_step(
            cells.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), points.data_ptr(), out.data_ptr(),
            out[ncell:].data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, c, h, w, q,
            hidden, PDE_IDS[pde], *geom, *sampler_args(cfg, n, device))
    check(lib, err, "mega2w_step launch")
    row = out[ncell:]
    ch = c * hidden
    grads = {
        "cells": out[:ncell].view(n, c, h, w),
        "w1": row[:ch].view(c, hidden),
        "b1": row[ch:ch + hidden],
        "w2": row[ch + hidden:ch + 2 * hidden].view(hidden, 1),
        "b2": row[ch + 2 * hidden:ch + 2 * hidden + 1],
    }
    return row[-1], grads


mega2w_step.launches = 0
