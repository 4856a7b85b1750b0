"""The launch layout of the shared 3D backward scatter.

fused3b_bwd and fused3s_bwd (csrc/fused3b.cu, csrc/fused3s.cu) add the
transpose of the fused 3D rows into the cells through one device body,
csrc/texel_scatter.cuh: a block per block of at most ``QUERIES`` queries
(fused3b's plan block, fused3s's table block), with a warp's lanes over
(query, cell).  ``scatter_geometry`` is the host's choice of how the
lanes and blocks cover the work; the C entry points take it as integers
and check it.  Nothing here runs a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

from .blend_splat import RESERVED_SMEM_BYTES, SM_SMEM_BYTES
from .build import BLOCK_SMEM_BYTES

__all__ = ["MAX_BLOCK_CHANNELS", "QUERIES", "THREADS", "ScatterGeometry",
           "scatter_alternatives", "scatter_geometry"]

# queries a block serves at most (csrc/texel_scatter.cuh kScatterQueries)
QUERIES = 128
# threads a block: one a staged query; twice as many where shared memory
# holds fewer than FULL_BLOCKS_PER_SM blocks an SM, or where the blocks
# are dense (full but for a bin's last: fused3s's table blocks; fused3b's
# plan blocks hold 70% real slots at config 5).  At config 5, C = 4 (16 KB
# a block, 13 an SM) 128 threads took fused3b_bwd 1.34-1.37 ms and 256
# 1.43-1.56; at C = 8 (30 KB, 7 an SM) 3.00-3.02 and 2.56-2.65; fused3s_bwd
# at 1 M points, C = 4, 2.49-2.53 and 2.31-2.42 (chip_smoke.py
# scatter_sweep_phase, PERF.md section 6)
THREADS = 128
FULL_BLOCKS_PER_SM = 8
# the most channels a block stages cotangents for: 16 take 58 KB of
# shared memory, so three blocks share an SM
MAX_BLOCK_CHANNELS = 16
# the fused 3D rows: value, 3 first and 3 second derivatives
ROWS = 7


class ScatterGeometry(NamedTuple):
    """One scatter launch's layout (csrc/texel_scatter.cuh ScatterLayout):
    channel groups of ``width``; ``block_groups`` of them a block (grid
    axis y walks the rest), of which ``lane_groups`` are spread over a
    query's lanes (each lane loops over the others); ``lanes`` lanes a
    query, each taking every ``lanes``-th of the query's N x lane_groups
    (cell, group) units, 32 // lanes queries a warp; ``threads`` a
    block."""
    width: int
    block_groups: int
    lane_groups: int
    lanes: int
    threads: int = THREADS

    def groups(self, c: int) -> int:
        """Channel groups of c channels."""
        return -(-c // self.width)

    def grid_y(self, c: int) -> int:
        """Blocks along the channel groups."""
        return -(-self.groups(c) // self.block_groups)

    def smem_bytes(self, c: int) -> int:
        """A block's shared memory: its channels' staged cotangents and the
        points, QUERIES of each (texel_scatter.cuh scatter_smem_bytes)."""
        return 4 * (ROWS * min(self.block_groups * self.width, c) + 3) \
            * QUERIES

    def args(self):
        """The layout as the C entry points take it."""
        return (self.width, self.block_groups, self.lane_groups, self.lanes,
                self.threads)


def scatter_geometry(n: int, c: int, dense: bool = False) -> ScatterGeometry:
    """The layout of the scatter of N cells of C channels (``dense``: in
    blocks that are full but for a bin's last).

    At C a multiple of 4, groups of 4 channels, one float4 reduction a
    corner each, up to MAX_BLOCK_CHANNELS of them a block, all over a
    query's lanes: the lanes of one cell add its neighbouring 16-byte
    records and the cells follow each other, so a warp's reductions
    cover contiguous runs of the texel's N * C values.  Otherwise
    (scalar reductions) groups of at most 8 channels (fused_rows.cuh
    group_width), all of a block's over the lanes.  A query takes as
    many lanes as it has (cell, group) units up to a warp, or half a
    warp where that leaves fewer lanes idle (48 units: 16 lanes a query,
    two queries a warp, three units a lane); THREADS a block, or twice as
    many where the blocks are dense or fewer than FULL_BLOCKS_PER_SM fit
    an SM's shared memory."""
    if c % 4 == 0:
        width = 4
        block_groups = min(c // 4, MAX_BLOCK_CHANNELS // 4)
    else:
        groups = -(-c // 8)
        width = -(-c // groups)
        block_groups = max(1, min(groups, MAX_BLOCK_CHANNELS // width))
    return _sized(ScatterGeometry(width, block_groups, block_groups,
                                  _lanes(n * block_groups)), c, dense)


def _lanes(units: int) -> int:
    """Lanes a query of ``units`` (cell, group) units: all of them up to a
    warp; above, a warp or half of one, whichever keeps more lanes busy
    (the larger on a tie)."""
    if units <= 32:
        return units

    def busy(lanes):
        return (32 // lanes) * units / (32 * -(-units // lanes))
    return 16 if busy(16) > busy(32) else 32


def _sized(geom: ScatterGeometry, c: int,
           dense: bool = False) -> ScatterGeometry:
    """``geom`` with THREADS a block, or twice as many where the blocks
    are dense or fewer than FULL_BLOCKS_PER_SM fit an SM's shared
    memory."""
    smem = geom.smem_bytes(c)
    assert smem <= BLOCK_SMEM_BYTES
    full = SM_SMEM_BYTES // (smem + RESERVED_SMEM_BYTES) >= FULL_BLOCKS_PER_SM
    return geom._replace(threads=THREADS if full and not dense
                         else 2 * THREADS)


def scatter_alternatives(n: int, c: int, dense: bool = False):
    """The layouts chip_smoke.py's scatter sweep times against the rule's
    for N cells of C channels, by name: lanes over queries (a lane walks
    all of a query's units: the layout before lanes over cells), half the
    lanes (and twice, where the rule took half a warp), the other block
    size (128 or 256 threads); over several channel groups, the block's
    groups looped in a lane (the lane carries all of its cell's
    channels), two of four over the lanes, and on the grid (a block a
    group); at C a multiple of 4 above 4, groups of 8 over the lanes and
    looped in a lane.  Each but the other block size is sized as the rule
    sizes its layout (``dense`` as for scatter_geometry); layouts equal
    to the rule's are left out."""
    rule = scatter_geometry(n, c, dense)
    other = 3 * THREADS - rule.threads
    alts = {"rule": rule,
            "lanes over queries": rule._replace(lanes=1),
            "half the lanes": rule._replace(lanes=max(1, rule.lanes // 2)),
            f"{other} threads": rule._replace(threads=other)}
    if rule.lanes < 32 and n * rule.lane_groups > rule.lanes:
        alts["twice the lanes"] = rule._replace(lanes=2 * rule.lanes)
    if rule.groups(c) > 1:
        bg = rule.block_groups
        alts["groups looped in a lane"] = rule._replace(
            lane_groups=1, lanes=_lanes(n))
        if bg % 2 == 0 and bg > 2:
            alts["two groups over lanes"] = rule._replace(
                lane_groups=2, lanes=_lanes(2 * n))
        alts["groups on the grid"] = _sized(
            ScatterGeometry(rule.width, 1, 1, _lanes(n)), c, dense)
    if c % 4 == 0 and c > 4:
        bg = min(-(-c // 8), MAX_BLOCK_CHANNELS // 8)
        alts["groups of 8 over lanes"] = _sized(
            ScatterGeometry(8, bg, bg, _lanes(n * bg)), c, dense)
        alts["groups of 8 looped in a lane"] = _sized(
            ScatterGeometry(8, bg, 1, _lanes(n)), c, dense)
    out = {}
    for name, geom in alts.items():
        if name == "rule" or geom not in out.values():
            out[name] = geom
    return out
