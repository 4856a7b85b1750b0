"""PyTorch port, the host side of the staged blend_o and mega2w launches:
the work units ``blend_splat.blend_geometry`` and ``mega2w.geometry``
compute for the card, at every shape chip_smoke.py runs them.

Each (cell, query) pair must fall in exactly one unit, a block's shared
memory must stay within ``build.BLOCK_SMEM_BYTES`` (two blocks an SM where
the geometry counts on two), and a cell is staged exactly where it fits.
The kernels themselves run on the card only (chip_smoke.py holds them to
their plain versions there).
"""

import math

import numpy as np
import pytest

from cosinesampler_tpu_torch.ops.cuda import blend_splat, build, mega2w
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SM_SMEM = blend_splat.SM_SMEM_BYTES
RESERVED = blend_splat.RESERVED_SMEM_BYTES

# (N, C, spatial, Q) of chip_smoke.py's blend_o calls: the main paths,
# the variants, the cells too large to stage and the route sweep's stacks
BLEND_SHAPES = [
    (96, 4, (16, 16), 100_000), (50, 4, (16, 16, 16), 100_000),
    (8, 3, (12, 10), 4099), (6, 3, (7, 8, 9), 4099), (3, 3, (7, 9), 4099),
    (2, 4, (128, 128), 4096), (2, 4, (32, 32, 32), 4096),
    (16, 4, (16, 16, 16), 100_000), (16, 4, (32, 32, 32), 100_000),
    (1024, 4, (16, 16, 16), 256), (1024, 4, (16, 16, 16), 1024),
    (1024, 4, (16, 16, 16), 4096), (24, 4, (16, 16), 20_000),
    (10, 3, (12, 20), 4099),
    (512, 4, (24, 24, 24), 2048), (4, 4, (1024, 1024), 65_536),
    (8, 12, (16, 16), 1000), (4, 4, (64, 64, 64), 4096),
]

# (N, C, H, W, Q, hidden) of chip_smoke.py's mega2w calls
MEGA_SHAPES = [
    (96, 4, 16, 16, 100_000, 16), (8, 3, 12, 10, 4096, 16),
    (8, 3, 12, 10, 4096, 8), (8, 3, 12, 10, 4096, 32),
    (8, 1, 12, 10, 4096, 16), (8, 8, 12, 10, 4096, 16),
    (8, 3, 12, 10, 4099, 16), (8, 3, 12, 10, 1000, 16),
    (2, 4, 128, 128, 4096, 16), (8, 4, 16, 16, 4096, 16),
    (7, 4, 16, 16, 100_000, 16), (97, 4, 16, 16, 100_000, 16),
    (96, 4, 16, 16, 100, 16), (96, 4, 16, 16, 1, 16),
    (2, 4, 120, 120, 4096, 16), (2, 4, 121, 120, 4096, 16),
    (96, 8, 16, 16, 100_000, 16), (5, 3, 7, 9, 4099, 16),
]


def _cover(n, q, units):
    """How many units each (cell, query) pair falls in; ``units`` yields
    (cells, queries) ranges."""
    hits = np.zeros((n, q), dtype=np.int16)
    for (n0, n1), (q0, q1) in units:
        hits[n0:n1, q0:q1] += 1
    return hits


@pytest.mark.parametrize("n,c,spatial,q", BLEND_SHAPES)
def test_blend_geometry_units(n, c, spatial, q):
    """blend_geometry: staged where a cell fits a block and has
    STAGE_QUERIES_PER_TEXEL queries a texel, its blocks cover every pair
    once within a block's shared memory, channels interleaved exactly
    where C is a multiple of 4; otherwise the unstaged kernel."""
    g = blend_splat.blend_geometry(n, c, spatial, q)
    texels = math.prod(spatial)
    fits = (blend_splat.BARRIER_BYTES + 4 * -(-c * texels // 4) * 4
            <= build.BLOCK_SMEM_BYTES)
    staged = fits and q >= blend_splat.STAGE_QUERIES_PER_TEXEL * texels
    assert (g.cells > 0) == staged
    if not staged:
        return
    rounds = -(-q // blend_splat.STAGED_THREADS)
    assert 1 <= g.q_blocks <= min(rounds, 65535)
    assert g.interleave == (c % 4 == 0)
    assert g.stride >= c * texels and g.stride % 4 == 0
    assert blend_splat.BARRIER_BYTES + 4 * g.cells * g.stride \
        <= build.BLOCK_SMEM_BYTES
    assert g.cells == 1 or 4 * g.cells * g.stride \
        <= blend_splat.BLEND_CELL_BYTES
    # block (b, y) takes rounds y, y + q_blocks, ... of STAGED_THREADS
    t = blend_splat.STAGED_THREADS
    chunks = -(-n // g.cells)
    hits = _cover(n, q, (((b * g.cells, min(n, (b + 1) * g.cells)),
                          (r * t, min(q, (r + 1) * t)))
                         for b in range(chunks) for y in range(g.q_blocks)
                         for r in range(y, rounds, g.q_blocks)))
    assert (hits == 1).all()


def test_blend_geometry_main_paths():
    """The main paths' geometry on the H100's 132 SMs, two blocks of 512
    an SM (by registers): in 2D 4 cells of 4 KB a block, one wave of 11
    query blocks of the 24 chunks; in 3D one 64 KB cell a block, 5 query
    blocks of the 50 cells; both interleaved."""
    bg = blend_splat.BlendGeometry
    assert blend_splat.blend_geometry(96, 4, (16, 16), 100_000) == bg(
        4, True, 1024, 11)
    assert blend_splat.blend_geometry(50, 4, (16, 16, 16), 100_000) == bg(
        1, True, 16384, 5)


@pytest.mark.parametrize("n,c,h,w,q,hidden", MEGA_SHAPES)
def test_mega2w_geometry_units(n, c, h, w, q, hidden):
    """mega2w.geometry: staged where one cell fits a block (above 8
    channels the wide kernel, which takes no units); its (chunk, slice)
    units cover every (cell, query) pair once, chunks of equal size but
    the last, a block's shared memory within its share of the SM, lanes
    the largest power of two up to 8 and the chunk's cells."""
    g = mega2w.geometry(n, c, h, w, q, hidden)
    if c > mega2w.REGISTER_CHANNELS:
        assert g == mega2w.GLOBAL_PATH
        return
    head = mega2w._head_bytes(c, hidden)
    cell = c * h * w
    fits = head + 4 * -(-cell // 4) * 4 <= build.BLOCK_SMEM_BYTES
    assert (g.chunks > 0) == fits
    if not fits:
        return
    assert g.stride >= cell and g.stride % 4 == 0
    assert (g.chunks - 1) * g.cells < n <= g.chunks * g.cells
    assert g.slices * g.q_per_slice >= q > (g.slices - 1) * g.q_per_slice
    assert g.q_per_slice >= min(q, mega2w.MIN_SLICE_QUERIES)
    bytes_ = head + 4 * g.cells * g.stride
    per_sm = 2 if c <= mega2w.TWO_BLOCKS_CHANNELS else 1
    assert bytes_ <= build.BLOCK_SMEM_BYTES
    if g.slices * g.chunks > blend_splat.H100_SMS:
        assert per_sm * (bytes_ + RESERVED) <= SM_SMEM
    assert g.lanes in (1, 2, 4, 8) and g.lanes <= g.cells
    assert g.lanes == 8 or 2 * g.lanes > g.cells
    hits = _cover(n, q, (((k * g.cells, min(n, (k + 1) * g.cells)),
                          (s * g.q_per_slice,
                           min(q, (s + 1) * g.q_per_slice)))
                         for k in range(g.chunks) for s in range(g.slices)))
    assert (hits == 1).all()


def test_mega2w_geometry_main_path_and_staging_limit():
    """The 2D main path (96 x 4 x 16^2, Q = 100 000, hidden 16): 4 chunks
    of 24 cells at strides 4 floats past a multiple of 32 (8 lanes in 8
    bank quads), 66 slices, two blocks an SM; a 4 x 120 x 120 cell is the
    largest that one block a SM stages (230 400 bytes), 4 x 121 x 120 takes
    the global path."""
    mg = mega2w.MegaGeometry
    assert mega2w.geometry(96, 4, 16, 16, 100_000, 16) == mg(
        4, 24, 1028, 66, 1516, 8)
    assert mega2w.geometry(2, 4, 120, 120, 4096, 16) == mg(
        2, 1, 57600, 8, 512, 1)
    assert mega2w.geometry(2, 4, 121, 120, 4096, 16) == mega2w.GLOBAL_PATH
    assert 2 * (mega2w._head_bytes(4, 16) + 4 * 24 * 1028 + RESERVED) \
        <= SM_SMEM
