"""The launch layouts of the small-cloud fused pairs, in 2D and 3D.

fused2d and fused3d (csrc/fused2d.cu, csrc/fused3d.cu) run fused2w's and
fused3w's gather and scatter (csrc/texel_gather.cuh,
csrc/texel_scatter.cuh, through csrc/fused.cu's launchers) in blocks of a
few queries, a warp's lanes over one query's cells, so that a cloud of a
few hundred points fills the card where blocks of 128 queries fill a few
SMs.  ``Rule`` holds one dimension's measured planar bounds
(ops/cuda/fused2d.py and ops/cuda/fused3d.py each keep their own) and
gives both launches' layouts for a shape (``geometry``) and the
alternatives chip_smoke.py's layout sweeps time against them.  The C
entry points take a layout as integers and check it.  Nothing here runs
a kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from .gather import QUERIES, GatherGeometry
from .scatter import ScatterGeometry, scatter_geometry
from .v1 import NARROW_CELL_LANES

__all__ = ["CELL_LANES", "THREADS", "BlendLayout", "BwdLayout", "Geometry",
           "Rule", "blend_lanes", "group_width"]

# threads a block of either launch: four warps
THREADS = 128
# the most lanes over one query's cells: a warp
CELL_LANES = 32


def group_width(c: int, most: int = 8) -> int:
    """The width of the channel groups the channel-looped kernels walk:
    csrc/fused_rows.cuh ``group_width`` (kGroupChannels = 8), as few equal
    groups as hold ``most`` channels each."""
    groups = max(1, -(-c // most))
    return -(-c // groups)


class BlendLayout(NamedTuple):
    """One small-cloud blend launch: ``lanes`` (gather.py's
    GatherGeometry: width, groups, cell lanes, threads) over blocks of
    ``queries`` queries in order, reading the cells in place where
    ``planar``, the texel-major copy otherwise."""
    lanes: GatherGeometry
    queries: int
    planar: bool = True

    def blocks(self, q: int) -> int:
        """Blocks along the queries."""
        return -(-q // self.queries)

    def args(self):
        """The layout as the C entry points take it: width, groups, cell
        lanes, threads, queries a block, planar."""
        return (*self.lanes.args(), self.queries, int(self.planar))


class BwdLayout(NamedTuple):
    """One small-cloud bwd launch: ``lanes`` (scatter.py's
    ScatterGeometry: width, block groups, lane groups, lanes, threads)
    over blocks of ``queries`` queries in order, adding into the
    cotangent in place where ``planar``, into the texel-major scratch
    otherwise."""
    lanes: ScatterGeometry
    queries: int
    planar: bool = False

    def blocks(self, q: int) -> int:
        """Blocks along the queries."""
        return -(-q // self.queries)

    def args(self):
        """The layout as the C entry points take it: width, block groups,
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


def blend_lanes(n: int, c: int, cell_lanes: int = CELL_LANES,
                threads: int = THREADS) -> GatherGeometry:
    """A lane holds a channel group of at most 8 channels (fused_rows.cuh
    group_width; grid axis y walks the groups), ``cell_lanes`` lanes (a
    power of 2, at most N) split a query's cells."""
    return GatherGeometry(group_width(c), 1,
                          max(1, min(cell_lanes, _pow2_floor(n))), threads)


def _unique(alts):
    out = {}
    for name, lay in alts.items():
        if name == "rule" or lay not in out.values():
            out[name] = lay
    return out


class Rule(NamedTuple):
    """One dimension's layout rule.  The blend reads the cells in place
    (planar) where it reads fewer cell values (N x Q x C) than
    ``points_per_texel`` times the stack's plus ``values``, the
    texel-major copy otherwise; the bwd adds into the cotangent in place
    where it adds fewer (N x Q x C, each at 2^D corners) than
    ``bwd_points_per_texel`` times the stack's plus ``bwd_values``, into
    the zeroed texel-major scratch and the tiled transpose otherwise.
    The bwd's warps take two rounds of queries where one round's blocks
    would number ``bwd_round_blocks`` or more."""
    points_per_texel: float
    values: float
    bwd_points_per_texel: float
    bwd_values: float
    bwd_round_blocks: float = math.inf

    def blend_planar(self, n: int, c: int, q: int, spatial) -> bool:
        """Whether the blend reads the cells in place: the copy, a pass
        over the whole stack and a launch whatever Q, costs more than the
        sectors its records save."""
        return (n * q * c < self.points_per_texel * n * c
                * math.prod(spatial) + self.values)

    def bwd_planar(self, n: int, c: int, q: int, spatial) -> bool:
        """Whether the bwd adds into the cotangent in place: the
        scratch's fill and transpose, passes over the whole stack whatever
        Q, cost more than the sectors its float4 reductions save."""
        return (n * q * c < self.bwd_points_per_texel * n * c
                * math.prod(spatial) + self.bwd_values)

    def blend_layout(self, n: int, c: int, q: int, spatial) -> BlendLayout:
        """The blend's layout: a warp over one query's cells (fewer lanes
        where N < 32, several queries a warp then), THREADS a block, one
        round a warp (4 queries a block at N >= 32: 1 024 points make 256
        blocks), the cells in place by ``blend_planar``."""
        lanes = blend_lanes(n, c)
        return BlendLayout(lanes, _queries(lanes.threads, lanes.lanes),
                           self.blend_planar(n, c, q, spatial))

    def bwd_layout(self, n: int, c: int, q: int, spatial) -> BwdLayout:
        """The bwd's layout: scatter.py's lanes over (cell, channel
        group), groups of 4 channels at C a multiple of 4 (float4
        reductions into the scratch), a warp or half of one a query,
        THREADS a block, one round a warp, or two from
        ``bwd_round_blocks`` blocks of one (fused2w_bwd's / fused3w_bwd's
        lanes in blocks of a few queries); into the cotangent in place by
        ``bwd_planar``."""
        lanes = scatter_geometry(n, c, dim=len(spatial))._replace(
            threads=THREADS)
        one = _queries(lanes.threads, lanes.lanes)
        rounds = 2 if -(-q // one) >= self.bwd_round_blocks else 1
        return BwdLayout(lanes, min(QUERIES, rounds * one),
                         self.bwd_planar(n, c, q, spatial))

    def geometry(self, n: int, c: int, q: int, spatial) -> Geometry:
        """Both launches' layouts for N cells of C channels over
        ``spatial`` at Q points in query order."""
        return Geometry(self.blend_layout(n, c, q, spatial),
                        self.bwd_layout(n, c, q, spatial))

    def blend_alternatives(self, n: int, c: int, q: int, spatial):
        """The blend layouts chip_smoke.py's sweeps time against the
        rule's, by name: the other read (the texel-major copy or planar),
        8 and 16 cell lanes, two and four rounds a warp (twice and four
        times the queries a block), 256 threads, and fused2w's and
        fused3w's blocks of 128 queries with their cell lanes (v1.py
        NARROW_CELL_LANES: 4 in 2D, 2 in 3D); layouts equal to the rule's
        are left out."""
        rule = self.blend_layout(n, c, q, spatial)
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
        alts["128-query blocks"] = rule._replace(
            lanes=blend_lanes(n, c, NARROW_CELL_LANES[len(spatial)],
                              2 * THREADS), queries=QUERIES)
        return _unique(alts)

    def bwd_alternatives(self, n: int, c: int, q: int, spatial):
        """The bwd layouts chip_smoke.py's sweeps time against the rule's,
        by name: the other destination (the texel-major scratch or
        planar), half the lanes a query, one, two and four rounds a warp,
        256 threads, and fused2w's and fused3w's blocks of 128 queries;
        layouts equal to the rule's are left out."""
        rule = self.bwd_layout(n, c, q, spatial)
        other = "texel-major scratch" if rule.planar else "planar"
        alts = {"rule": rule, other: rule._replace(planar=not rule.planar)}
        half = rule.lanes._replace(lanes=max(1, rule.lanes.lanes // 2))
        alts["half the lanes"] = rule._replace(
            lanes=half, queries=_queries(THREADS, half.lanes))
        one = _queries(rule.lanes.threads, rule.lanes.lanes)
        for rounds, name in ((1, "1 round"), (2, "2 rounds"),
                             (4, "4 rounds")):
            alts[f"{name} a warp"] = rule._replace(
                queries=min(QUERIES, rounds * one))
        wide = rule.lanes._replace(threads=2 * THREADS)
        alts["256 threads"] = rule._replace(lanes=wide, queries=_queries(
            wide.threads, wide.lanes))
        alts["128-query blocks"] = rule._replace(queries=QUERIES)
        return _unique(alts)
