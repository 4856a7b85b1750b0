"""The launch layouts of the fused op's kernels over points in query order.

The fused op's blends and bwds over (N, C, *S) cells and shared points in
query order, in 2D and 3D, run through one device launcher each:

* The blends, fused2w_blend and fused3w_blend (csrc/fused2w.cu,
  csrc/fused3w.cu) and the v1 blend (csrc/fused.cu, the route above 8
  channels, ops/cuda/route.py ``fused_rule``), are
  csrc/texel_gather.cuh's gather over blocks of 128 queries
  (``fused_gather_blend``), from a texel-major copy of the cells, or from
  the cells in place below a measured number of points a texel (planar),
  with the lanes of ``blend_geometry``: ``narrow_lanes`` up to 8
  channels, the v1 blend's rule above; the lanes store the (1 + 2D, C,
  Q) rows directly.
* The bwds, fused2w_bwd, fused3w_bwd and the v1 bwd, are
  csrc/texel_scatter.cuh's scatter into a texel-major scratch
  (``fused_scatter_bwd``) with the layout of ``bwd_geometry``:
  scatter.py's rule for dense blocks, 128 threads a block in 3D
  (fused2w.py adds the planar choice of fused2w_bwd / fused3w_bwd).

``blend_geometry`` / ``bwd_geometry`` are the host's choices; the C
entry points take them as integers and check them.  chip_smoke.py's
``v1_layout_sweep_phase`` and ``w_blend_layout_sweep_phase`` time them
against ``blend_alternatives`` / ``bwd_alternatives``.  Nothing here
runs a kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from .gather import (MAX_GROUPS, MAX_THREADS, MAX_WIDTH, QUERIES,
                     GatherGeometry, gather_alternatives, gather_geometry)
from .scatter import THREADS, ScatterGeometry, scatter_alternatives
from .scatter import scatter_geometry as _scatter_geometry

__all__ = ["NARROW_PLANAR_POINTS_PER_TEXEL", "NARROW_PLANAR_VALUES",
           "PLANAR_POINTS_PER_TEXEL", "BlendGeometry", "blend_alternatives",
           "blend_geometry", "bwd_alternatives", "bwd_geometry",
           "narrow_lanes"]

# the most channels a lane of the 2D blend holds (csrc/fused.cu: the
# gather's fused_rows.cuh kMaxChannels, or 16 in 2D)
WIDE = 16
# points per texel of a cell below which the blend reads the cells in
# place rather than through the texel-major copy, by dimension, above
# MAX_WIDTH channels (chip_smoke.py v1_layout_sweep_phase, C = 16,
# PERF.md section 6): on 16 x 16 x 128^3 (2.1 GB) planar won up to
# 24 576 points (0.0117 a texel; 1.22 against 1.80 ms), tied at 32 768
# (1/64: 1.82-1.86 against 1.83) and lost from 49 152 on (2.62-2.67
# against 1.95); on 16 x 16 x 1024^2 it won up to 16 384 (0.0156; 0.50
# against 0.89) and lost at 32 768 (1/32; 0.99 against 0.91).  In the
# L2 the copy is cheap: on path (a)'s stacks (96 x 16 x 16^2, 50 x 16 x
# 16^3) planar lost from 0.0625 a texel on; on the large cells (2 x 16 x
# 128^2, 2 x 16 x 32^3) it won up to 0.5-1 a texel by 7-40 us (calls
# under 0.13 ms), which the bound gives up.
PLANAR_POINTS_PER_TEXEL = {2: 1 / 32, 3: 1 / 64}
# up to MAX_WIDTH channels the blend reads the cells in place where it
# reads fewer cell values (N x Q x C) than NARROW_PLANAR_POINTS_PER_TEXEL
# [dim] times the stack's plus NARROW_PLANAR_VALUES[dim]: there the copy,
# a pass over the stack and a launch, costs more than the scattered loads
# save (chip_smoke.py w_blend_layout_sweep_phase,
# C = 4, CUDA events around 5 calls, PERF.md section 6).  Over the L2
# planar won up to 0.031 a texel and lost from 0.0625 in 2D and 3D
# (16 x 4 x 1024^2 at 32 768 points 0.12 against 0.25 ms, at 65 536 0.30
# against 0.27; 16 x 4 x 128^3 at 65 536 0.51 against 0.57, at 131 072
# 1.07 against 0.68).  In the L2, on the main paths' stacks planar won up
# to 4 096 points (2D, 1.6 M values: 0.071 against 0.088 ms) and 16 384
# (3D, 3.3 M: 0.102 against 0.106) and lost from 16 384 (2D, 6.3 M) and
# 32 768 (3D, 6.6 M); on the two-cell large cells it won at every point
# count (to 65 536, 0.5 M values).
NARROW_PLANAR_POINTS_PER_TEXEL = {2: 1 / 32, 3: 1 / 64}
NARROW_PLANAR_VALUES = {2: 1 << 21, 3: 1 << 22}
# lanes over a query's cells up to MAX_WIDTH channels, by dimension, with
# 256 threads a block (chip_smoke.py w_blend_layout_sweep_phase, main
# paths, device ms, PERF.md section 6): in 2D four lanes, 0.157 ms at C = 4
# against two lanes' 0.160 and one's 0.163 (a thread a query, 128
# threads), 0.160 against 0.299 at C = 3; in 3D two, 0.190 at C = 4
# against four's 0.199 and one's 0.213, 0.309 against 0.322 at C = 8.
NARROW_CELL_LANES = {2: 4, 3: 2}


class BlendGeometry(NamedTuple):
    """One blend launch: ``lanes`` (gather.py's GatherGeometry: width,
    groups, cell lanes, threads) over the texel-major copy of the cells
    or, where ``planar``, the cells in place."""
    lanes: GatherGeometry
    planar: bool = False

    def args(self):
        """The layout as the C entry points take it: width, groups, cell
        lanes, threads, planar."""
        return (*self.lanes.args(), int(self.planar))


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _planar(q: int, spatial, per_texel: float) -> bool:
    """Whether a gather reads the cells in place rather than through the
    texel-major copy: below ``per_texel`` points per texel of a cell,
    where the copy, which costs the stack's bytes read and written
    whatever Q, outweighs the sectors its reads save."""
    return q < per_texel * math.prod(spatial)


def _wide(n: int, c: int, cell_lanes: int) -> GatherGeometry:
    """Lanes of 16 channels, up to MAX_GROUPS of them, and ``cell_lanes``
    lanes over the cells (at most N); 256 threads a block where a query
    takes more than one lane, 128 where it takes one."""
    groups = min(c // WIDE, MAX_GROUPS)
    cell_lanes = max(1, min(cell_lanes, _pow2_floor(n)))
    return GatherGeometry(WIDE, groups, cell_lanes,
                          MAX_THREADS if groups * cell_lanes > 1 else QUERIES)


def _narrow(n: int, c: int, cell_lanes: int, threads: int) -> GatherGeometry:
    """A lane holds all C <= MAX_WIDTH channels, ``cell_lanes`` lanes (at
    most N) split a query's cells, ``threads`` a block."""
    return GatherGeometry(c, 1, max(1, min(cell_lanes, _pow2_floor(n))),
                          threads)


def narrow_lanes(dim: int, n: int, c: int) -> GatherGeometry:
    """The blend's lanes up to MAX_WIDTH channels: a lane holds all C
    channels, so that each (query, cell) is walked once, and
    NARROW_CELL_LANES[dim] lanes split a query's cells, their records of
    one texel side by side, 256 threads a block."""
    return _narrow(n, c, NARROW_CELL_LANES[dim], MAX_THREADS)


def blend_geometry(dim: int, n: int, c: int, q: int,
                   spatial) -> BlendGeometry:
    """The blend's layout of N cells of C channels over ``spatial`` at Q
    points in query order.  Up to MAX_WIDTH channels narrow_lanes,
    planar where the cell values read (N x Q x C) fall below
    NARROW_PLANAR_POINTS_PER_TEXEL times the stack's plus
    NARROW_PLANAR_VALUES.  Above,
    in 2D at C a multiple of 16, lanes of 16 channels and four lanes
    over the cells (fewer where channel lanes take them): each (query,
    cell) is walked once and the four cell lanes' 64-byte records of one
    texel make two whole lines.  At 2D path (a) (96 x 16 x 16^2) that
    took 0.447-0.455 ms against 0.455-0.468 with two cell lanes, 0.71
    with one, 0.47-0.50 with the table blocks' two lanes of 8 channels
    (which walk each (query, cell) twice) and 0.50-0.56 staging chunks
    of cells in shared memory (chip_smoke.py v1_layout_sweep_phase,
    PERF.md section 6).  Otherwise the table blocks' rule
    (gather.gather_geometry: at C = 16 in 3D two lanes of 8 interleaved
    channels).  Planar below PLANAR_POINTS_PER_TEXEL points a texel."""
    if c <= MAX_WIDTH:
        return BlendGeometry(narrow_lanes(dim, n, c), _planar(
            q - NARROW_PLANAR_VALUES[dim] / (n * c), spatial,
            NARROW_PLANAR_POINTS_PER_TEXEL[dim]))
    if dim == 2 and c % WIDE == 0:
        lanes = _wide(n, c, max(1, 4 // min(c // WIDE, MAX_GROUPS)))
    else:
        lanes = gather_geometry(n, c)
    return BlendGeometry(lanes, _planar(q, spatial,
                                        PLANAR_POINTS_PER_TEXEL[dim]))


def blend_alternatives(dim: int, n: int, c: int, q: int, spatial):
    """The layouts chip_smoke.py's sweeps time against the rule's, by
    name: the rule read planar (the cells in place) or through the copy
    (whichever it does not) and the table blocks' rule; up to MAX_WIDTH
    channels a lane of all C channels with
    1, 2, 4 and 8 cell lanes at 128 and 256 threads; above it each
    layout of gather.gather_alternatives, and in 2D at C a multiple of 16
    a lane of 16 channels with one, two and four cell lanes; layouts
    equal to the rule's are left out."""
    rule = blend_geometry(dim, n, c, q, spatial)
    other = "texel-major copy" if rule.planar else "planar"
    alts = {"rule": rule, other: rule._replace(planar=not rule.planar),
            "table blocks' rule": BlendGeometry(gather_geometry(n, c))}
    if c <= MAX_WIDTH:
        for cell_lanes in (1, 2, 4, 8):
            for threads in (QUERIES, MAX_THREADS):
                alts[f"{cell_lanes} cell lanes, {threads} threads"] = \
                    rule._replace(lanes=_narrow(n, c, cell_lanes, threads))
    else:
        for name, lanes in gather_alternatives(n, c).items():
            alts[f"gather: {name}"] = BlendGeometry(lanes)
        if dim == 2 and c % WIDE == 0:
            for cell_lanes, name in ((1, "one"), (2, "two"), (4, "four")):
                alts[f"16 channels a lane, {name} cell lanes"] = \
                    BlendGeometry(_wide(n, c, cell_lanes))
    out = {}
    for name, geom in alts.items():
        if geom.lanes.lanes <= 32 and (name == "rule"
                                       or geom not in out.values()):
            out[name] = geom
    return out


def bwd_geometry(dim: int, n: int, c: int) -> ScatterGeometry:
    """The scatter layout of the fused op's bwds over points in query
    order (fused2w_bwd, fused3w_bwd and the v1 bwd): scatter.py's rule for
    dense blocks (each block of 128 queries full but the last), with 128
    threads a block in 3D.  At the 3D main path (50 x C x 16^3, 100 000
    points) 128 threads took 0.27-0.29, 0.48-0.50 and 0.87-0.88 ms at
    C = 4, 8 and 16 against 256's 0.30-0.33, 0.50-0.52 and 0.93-0.96; in
    2D (96 x C x 16^2) 256 took 0.26-0.27, 0.45-0.46 and 0.83-0.85
    against 128's 0.26-0.27, 0.46 and 1.05-1.08 (chip_smoke.py
    w_bwd_layout_sweep_phase, two runs, PERF.md section 6)."""
    geom = _scatter_geometry(n, c, dense=True, dim=dim)
    return geom._replace(threads=THREADS) if dim == 3 else geom


def bwd_alternatives(dim: int, n: int, c: int):
    """The scatter layouts the sweep times against bwd_geometry's
    (scatter.scatter_alternatives for dense blocks, and the rule with the
    other block size); layouts equal to the rule's are left out."""
    rule = bwd_geometry(dim, n, c)
    other = 3 * THREADS - rule.threads
    alts = {f"{other} threads": rule._replace(threads=other),
            **scatter_alternatives(n, c, dense=True, dim=dim)}
    out = {"rule": rule}
    for name, geom in alts.items():
        if name != "rule" and geom not in out.values():
            out[name] = geom
    return out
