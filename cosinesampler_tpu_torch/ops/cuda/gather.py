"""The launch layout of the shared 3D forward gather.

fused3b_blend and fused3s_blend (csrc/fused3b.cu, csrc/fused3s.cu) gather
the fused 3D rows from the texel-major (D, H, W, N, C) volume through one
device body, csrc/texel_gather.cuh: a block per block of at most
``QUERIES`` queries (fused3b's plan block, fused3s's table block), with a
few lanes a query that split its channels and its cells.
``gather_geometry`` is the host's choice of how the lanes and blocks
cover the work; the C entry points take it as integers and check it.
Nothing here runs a kernel.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["MAX_GROUPS", "QUERIES", "SECTOR_BYTES", "GatherGeometry",
           "gather_alternatives", "gather_geometry"]

# queries a block serves at most (csrc/texel_gather.cuh kGatherQueries)
QUERIES = 128
# the most threads a block (texel_gather.cuh kGatherMaxThreads); a block
# runs QUERIES or MAX_THREADS threads, each size a kernel instance with
# its own launch bounds
MAX_THREADS = 256
# the most channels a lane holds (fused_rows.cuh kMaxChannels)
MAX_WIDTH = 8
# the most lanes that split a query's channels: 64 channels a block
MAX_GROUPS = 8
# an L2 sector: the lanes of a query fill one with each load instruction
SECTOR_BYTES = 32


class GatherGeometry(NamedTuple):
    """One gather launch's layout (csrc/texel_gather.cuh GatherLayout):
    ``groups`` lanes split a block's ``groups * width`` channels, lane g
    taking the units (quads of 4 channels where C is a multiple of 4 and
    ``width`` too, single channels otherwise) g, g + groups, ...; grid
    axis y walks the rest; ``cell_lanes`` lanes (a power of 2) split a
    query's cells, lane m taking cells m, m + cell_lanes, ...; so a query
    takes ``groups * cell_lanes`` lanes; ``threads`` a block."""
    width: int
    groups: int
    cell_lanes: int
    threads: int = MAX_THREADS

    @property
    def lanes(self) -> int:
        """Lanes a query."""
        return self.groups * self.cell_lanes

    def vec(self, c: int) -> bool:
        """Whether the loads are float4 (texel_gather.cuh gather_vec)."""
        return c % 4 == 0 and self.width % 4 == 0

    def grid_y(self, c: int) -> int:
        """Blocks along the channels."""
        return -(-c // (self.groups * self.width))

    def args(self):
        """The layout as the C entry points take it."""
        return self.width, self.groups, self.cell_lanes, self.threads


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def _cell_lanes(n: int, groups: int, record_bytes: int) -> int:
    """Lanes over cells: as many as it takes the cells' neighbouring
    records of ``record_bytes`` (one lane set's channels of one cell) to
    fill a sector, a power of 2, at most N and 32 // groups."""
    want = _pow2_floor(max(1, SECTOR_BYTES // max(1, record_bytes)))
    return max(1, min(want, _pow2_floor(n), _pow2_floor(32 // groups)))


def gather_geometry(n: int, c: int, bricked: bool = False) -> GatherGeometry:
    """The layout of the gather of N cells of C channels; ``bricked``: in
    fused3b's plan blocks, whose queries share one brick of the volume,
    rather than fused3s's table blocks, which span a z slab.

    Table blocks (fused3s): at C a multiple of 4, float4 loads, one quad a
    lane at C = 4 and two lanes or more over a cell's quads above (so that
    one instruction reads a whole sector of each record), each lane
    holding at most 8 channels, up to MAX_GROUPS lanes (64 channels) a
    block; otherwise scalar loads, lanes over groups of at most 8
    channels; lanes over cells until one lane set's channels of the
    cells fill a sector (C = 4: two cells, 32 bytes), at most N; 256
    threads a block where a query takes more than one lane, 128 (a
    thread a staged query) where it takes one.  At 16 x 4 x 128^3 two
    cell lanes took fused3s_blend 1.36 ms at 1 M points against 1.73
    with a thread a query (chip_smoke.py gather_sweep_phase, PERF.md
    section 6).

    Plan blocks (fused3b): a lane holds all of up to 8 channels, and
    above 8 (C a multiple of 4) two lanes or more take interleaved quads,
    8 channels each; two lanes over the cells where a query has 32
    (cell, lane) units or more (N x channel lanes), one otherwise; 128
    threads up to two lanes a query, 256 above.  The queries of a brick
    read neighbouring texels, so L1 already merges the records of cells
    2j and 2j + 1 across a thread's loop: at config 5 (C = 4) a thread a
    query took 0.89 ms against 0.97-1.04 with two cell lanes, while at
    C = 16 two channel lanes times two cell lanes took 3.83 against 4.36
    with a thread a query."""
    if bricked:
        if c % 4 == 0 and c > MAX_WIDTH:
            groups, width = min(MAX_GROUPS, -(-c // 8)), MAX_WIDTH
        else:
            groups = min(MAX_GROUPS, -(-c // MAX_WIDTH))
            width = -(-c // groups)
        cell_lanes = 2 if n * groups >= 32 and n >= 2 else 1
        lanes = groups * cell_lanes
        return GatherGeometry(width, groups, cell_lanes,
                              min(MAX_THREADS, QUERIES * max(1, lanes // 2)))
    if c % 4 == 0:
        quads = c // 4
        groups = 1 if quads == 1 else min(MAX_GROUPS,
                                          max(2, -(-quads // 2)))
        width = 4 * min(2, -(-quads // groups))
    else:
        groups = min(MAX_GROUPS, -(-c // MAX_WIDTH))
        width = -(-c // -(-c // MAX_WIDTH))
    geom = GatherGeometry(width, groups,
                          _cell_lanes(n, groups, 4 * min(c, groups * width)))
    return geom._replace(threads=MAX_THREADS if geom.lanes > 1 else QUERIES)


def gather_alternatives(n: int, c: int, bricked: bool = False):
    """The layouts chip_smoke.py's gather sweep times against the rule's
    for N cells of C channels (``bricked`` as for gather_geometry), by
    name: the other kind of block's rule, a thread a query over all its
    cells with channel groups of at most 8 on the grid (the design
    before the shared body), half and twice the rule's cell lanes, the
    other block size (128 or 256 threads); at C a multiple of 4 above 4,
    a lane a quad (4 channels a lane, up to 8 lanes) and two lanes over
    the cells with 8 channels a lane and the rest on the grid.  Layouts
    equal to the rule's, over 32 lanes a query or over N cell lanes are
    left out."""
    rule = gather_geometry(n, c, bricked)
    groups = -(-c // MAX_WIDTH)
    other = QUERIES + MAX_THREADS - rule.threads
    alts = {"rule": rule,
            f"{'table' if bricked else 'plan'} blocks' rule":
                gather_geometry(n, c, not bricked),
            "a thread a query": GatherGeometry(-(-c // groups), 1, 1,
                                               QUERIES),
            "half the cell lanes": rule._replace(
                cell_lanes=max(1, rule.cell_lanes // 2)),
            "twice the cell lanes": rule._replace(
                cell_lanes=2 * rule.cell_lanes),
            f"{other} threads": rule._replace(threads=other)}
    if c % 4 == 0 and c > 4:
        quads = min(c // 4, MAX_GROUPS)
        alts["a lane a quad"] = GatherGeometry(
            4, quads, _cell_lanes(n, quads, 16 * quads), MAX_THREADS)
        alts["two cell lanes, 8 channels a pass"] = GatherGeometry(
            8, 1, _cell_lanes(n, 1, 16), MAX_THREADS)
    out = {}
    for name, geom in alts.items():
        if geom.lanes > 32 or geom.cell_lanes > _pow2_floor(n):
            continue
        if name == "rule" or geom not in out.values():
            out[name] = geom
    return out
