"""Coordinate transforms: normalized grid coords -> pixel-space source coords.

Counterpart of the JAX package's ops/coords.py, with the same floating-point
operation order so that both packages floor to the same corner: a one-ulp
difference in a source coordinate flips a corner at exact texel ticks,
where the second derivative jumps.  Every function returns ``(coord,
mult)``, ``mult`` being d(coord)/d(normalized coord), piecewise constant.
"""

from __future__ import annotations

import numpy as np
import torch


def unnormalize(coord, size: int, align_corners: bool, multicell: bool, offset):
    """[-1, 1] normalized coord -> pixel coord, plus the d(pixel)/d(norm) scale.

    Operation order is ``(coord + 1) * scale + offset``: the per-cell floor
    must be taken of ``base + offset``, never derived from ``frac(base) +
    offset``.
    """
    eff = size - 1 if (align_corners and multicell) else size
    if align_corners:
        scale = (eff - 1) / 2.0
        out = (coord + 1.0) * scale + offset
    else:
        scale = eff / 2.0
        out = ((coord + 1.0) * eff - 1.0) / 2.0 + offset
    mult = torch.full_like(coord, scale)
    return out, mult


def clip_coordinates(coord, size: int):
    """Clamp to [0, size-1]; the multiplier is zero at and beyond the borders."""
    hi = float(size - 1)
    inside = (coord > 0.0) & (coord < hi)
    out = torch.where(coord <= 0.0, 0.0, torch.where(coord >= hi, hi, coord))
    mult = inside.to(coord.dtype)
    return out, mult


def reflect_coordinates(coord, twice_low: int, twice_high: int):
    """Reflect into [twice_low/2, twice_high/2]; the multiplier is the fold parity."""
    if twice_low == twice_high:
        return torch.zeros_like(coord), torch.zeros_like(coord)
    mn = twice_low / 2.0
    span = (twice_high - twice_low) / 2.0
    shifted = coord - mn
    sign = torch.where(shifted < 0.0, -1.0, 1.0).to(coord.dtype)
    mag = torch.abs(shifted)
    # torch.fmod is the exact C fmod (torch.remainder is not); mag >= 0.
    # The quotient divides by a tensor: on the card torch divides by a
    # Python scalar as a product with its rounded reciprocal, which can
    # floor mag just under a multiple of span to the next fold (one pair
    # in 5 M at 50 x 16^3 in reflection: a corner off by the span) where
    # the kernels and the JAX package divide correctly rounded
    extra = torch.fmod(mag, span)
    flips = torch.floor(mag / torch.full_like(mag, span))
    even = torch.fmod(flips, 2.0) == 0.0
    out = torch.where(even, extra + mn, span - extra + mn)
    mult = torch.where(even, sign, -sign)
    return out, mult


def compute_source_coords(coord, size: int, padding_mode: str,
                          align_corners: bool, multicell: bool, offset,
                          strict: bool = False):
    """unnormalize -> (clip | reflect+clip), with the chain multiplier."""
    x, mult = unnormalize(coord, size, align_corners, multicell, offset)
    if padding_mode == "zeros":
        return x, mult
    if padding_mode == "border":
        x, mc = clip_coordinates(x, size)
        return x, mult * mc
    if padding_mode == "reflection":
        eff = size - 1 if (multicell or strict) else size
        if align_corners:
            x, mr = reflect_coordinates(x, 0, 2 * (eff - 1))
        else:
            x, mr = reflect_coordinates(x, -1, 2 * size - 1)
        x, mc = clip_coordinates(x, size)
        return x, mult * mr * mc
    raise ValueError(
        f"unknown padding_mode {padding_mode!r}; expected zeros|border|reflection"
    )


def offset_lattice(n_cells: int, multicell: bool, np_dtype=np.float32):
    """``(step, stop)`` of the per-cell shifts: cell i < N-1 is shifted by
    ``i * step`` rounded to the dtype, cell N-1 by ``stop``.

    This is how the JAX package's ``jnp.linspace(0, 1 - 1/N, N)``
    evaluates once XLA has simplified it: step = stop * (1 / (N - 1)),
    each operation rounded to the dtype.  torch.linspace and np.linspace
    round differently in the last bit for most N (68 of the 96 f32 offsets
    at N = 96), which moves corner floors at exact texel ticks.  The CUDA
    kernels take the two scalars and form the shifts themselves.
    """
    if not multicell or n_cells == 1:
        return np_dtype(0.0), np_dtype(0.0)
    stop = np_dtype(1.0 - 1.0 / n_cells)
    return stop * (np_dtype(1.0) / np_dtype(n_cells - 1)), stop


def multicell_offsets(n_cells: int, multicell: bool, dtype,
                      device=None) -> torch.Tensor:
    """Per-cell lattice shifts linspace(0, 1 - 1/N, N), or zeros, with the
    JAX package's exact values (see offset_lattice)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    step, stop = offset_lattice(n_cells, multicell, np_dtype)
    offsets = torch.arange(n_cells, dtype=dtype, device=device) * float(step)
    if n_cells > 1:
        offsets[-1] = float(stop)
    return offsets
