"""The launch layouts of the v1 fused pair.

The v1 blend and bwd (csrc/fused.cu) serve the fused op above 8 channels
where the route sends it there (ops/cuda/route.py ``fused_rule``), over
(N, C, *S) cells and shared points in query order, in 2D and 3D.

* The blend is the gather of csrc/texel_gather.cuh over blocks of 128
  queries, from a texel-major copy of the cells, or from the cells in
  place below ``PLANAR_POINTS_PER_TEXEL`` points a texel (planar,
  measured for this blend by dimension), with the lanes of
  ``blend_geometry``.
* The bwd is csrc/texel_scatter.cuh's scatter into a texel-major scratch,
  with the layout of fused2w_bwd's and fused3w_bwd's (``bwd_geometry`` is
  fused2w.py's ``bwd_lanes``: scatter.py's rule for dense blocks, 128
  threads a block in 3D).

``blend_geometry`` / ``bwd_geometry`` are the host's choices; the C
entry points take them as integers and check them.  chip_smoke.py's
``v1_layout_sweep_phase`` times each against ``blend_alternatives`` /
``bwd_alternatives``.  Nothing here runs a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

from .fused2w import bwd_lanes as bwd_geometry
from .fused3s import planar
from .gather import (MAX_GROUPS, MAX_THREADS, QUERIES, GatherGeometry,
                     gather_alternatives, gather_geometry)
from .scatter import THREADS, scatter_alternatives

__all__ = ["PLANAR_POINTS_PER_TEXEL", "V1Blend", "blend_alternatives",
           "blend_geometry", "bwd_alternatives", "bwd_geometry"]

# the most channels a lane of the 2D blend holds (csrc/fused.cu: the
# gather's fused_rows.cuh kMaxChannels, or 16 in 2D)
WIDE = 16
# points per texel of a cell below which the blend reads the cells in
# place rather than through the texel-major copy, by dimension
# (chip_smoke.py v1_layout_sweep_phase, C = 16, PERF.md section 6): on
# 16 x 16 x 128^3 (2.1 GB) planar won up to 24 576 points (0.0117 a
# texel; 1.22 against 1.80 ms), tied at 32 768 (1/64: 1.82-1.86 against
# 1.83) and lost from 49 152 on (2.62-2.67 against 1.95); on 16 x 16 x
# 1024^2 it won up to 16 384 (0.0156; 0.50 against 0.89) and lost at
# 32 768 (1/32; 0.99 against 0.91).  In the L2 the copy is cheap: on
# path (a)'s stacks (96 x 16 x 16^2, 50 x 16 x 16^3) planar lost from
# 0.0625 a texel on; on the large cells (2 x 16 x 128^2, 2 x 16 x 32^3)
# it won up to 0.5-1 a texel by 7-40 us (calls under 0.13 ms), which
# the bound gives up.
PLANAR_POINTS_PER_TEXEL = {2: 1 / 32, 3: 1 / 64}


class V1Blend(NamedTuple):
    """One v1 blend launch: ``lanes`` (gather.py's GatherGeometry: width,
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


def _wide(n: int, c: int, cell_lanes: int) -> GatherGeometry:
    """Lanes of 16 channels, up to MAX_GROUPS of them, and ``cell_lanes``
    lanes over the cells (at most N); 256 threads a block where a query
    takes more than one lane, 128 where it takes one."""
    groups = min(c // WIDE, MAX_GROUPS)
    cell_lanes = max(1, min(cell_lanes, _pow2_floor(n)))
    return GatherGeometry(WIDE, groups, cell_lanes,
                          MAX_THREADS if groups * cell_lanes > 1 else QUERIES)


def blend_geometry(dim: int, n: int, c: int, q: int, spatial) -> V1Blend:
    """The v1 blend's layout of N cells of C channels over ``spatial`` at
    Q points.  In 2D at C a multiple of 16, lanes of 16 channels and four
    lanes over the cells (fewer where channel lanes take them): each
    (query, cell) is walked once and the four cell lanes' 64-byte records
    of one texel make two whole lines.  At 2D path (a) (96 x 16 x 16^2)
    that took 0.447-0.455 ms against 0.455-0.468 with two cell lanes,
    0.71 with one, 0.47-0.50 with the table blocks' two lanes of 8
    channels (which walk each (query, cell) twice) and 0.50-0.56 staging
    chunks of cells in shared memory (chip_smoke.py v1_layout_sweep_phase,
    PERF.md section 6).  Otherwise the table blocks' rule
    (gather.gather_geometry: at C = 16 in 3D two lanes of 8 interleaved
    channels).  Planar below PLANAR_POINTS_PER_TEXEL points a texel."""
    if dim == 2 and c % WIDE == 0:
        lanes = _wide(n, c, max(1, 4 // min(c // WIDE, MAX_GROUPS)))
    else:
        lanes = gather_geometry(n, c)
    return V1Blend(lanes,
                   planar=planar(q, spatial, PLANAR_POINTS_PER_TEXEL[dim]))


def blend_alternatives(dim: int, n: int, c: int, q: int, spatial):
    """The layouts chip_smoke.py's v1 sweep times against the rule's, by
    name: the rule read planar (the cells in place) or through the copy
    (whichever it does not), the table blocks' rule and each layout of
    gather.gather_alternatives, and in 2D at C a multiple of 16 a lane of
    16 channels with one, two and four cell lanes; layouts equal to the
    rule's are left out."""
    rule = blend_geometry(dim, n, c, q, spatial)
    other = "texel-major copy" if rule.planar else "planar"
    alts = {"rule": rule, other: rule._replace(planar=not rule.planar),
            "table blocks' rule": V1Blend(gather_geometry(n, c))}
    for name, lanes in gather_alternatives(n, c).items():
        alts[f"gather: {name}"] = V1Blend(lanes)
    if dim == 2 and c % WIDE == 0:
        for cell_lanes, name in ((1, "one"), (2, "two"), (4, "four")):
            alts[f"16 channels a lane, {name} cell lanes"] = V1Blend(
                _wide(n, c, cell_lanes))
    out = {}
    for name, geom in alts.items():
        if geom.lanes.lanes <= 32 and (name == "rule"
                                       or geom not in out.values()):
            out[name] = geom
    return out


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
