// The z-sorted fused 3D blend and its transpose to the cells, for NVIDIA
// Hopper (sm_90a): value, d/dx, d/dy, d/dz, d2/dx2, d2/dy2, d2/dz2 summed
// over the multicell ensemble, each block serving queries of one z bin,
// whose corners lie in three z slabs of each cell.
//
// fused3s_blend replaces the TPU kernel
//   ops/pallas/fused3s.py::_fused3s_blend_kernel of the JAX package
// fused3s_bwd replaces
//   ops/pallas/fused3s.py::_fused3s_bwd_kernel of the JAX package
//
// Contract (fused3w's: the JAX package's fused op at dim 3):
//   blend: cells (N, C, D, H, W) f32, points (Q, 3) f32 shared by all
//          cells -> out (7, C, Q) f32 in query order.
//   bwd:   g (7, C, Q) f32 -> dcells (N, C, D, H, W) f32, the exact
//          transpose.
//   perm (Q,) int32 and table (NB, 3) int32 are the wrapper's z sort
//   (ops/cuda/fused3s.py zsort): the queries in stable order of the
//   clamped key floor(base_z) + 2 in [0, D + 1], and per block its bin
//   (not read here), first sorted slot and query count (at most 128; 0
//   for the blocks past the last, since NB is the static bound
//   cdiv(Q, 128) + D + 2).
// Zeros and border padding (the JAX kernels' set), every interpolant,
// multicell on and off, both align_corners; any C and cell size.
//
// What bounds it on the H100 SXM (67 TFLOP/s f32, 3.35 TB/s at 700 W): over
// the L2 (16 x 4 x 128^3, 537 MB) at 100 000 fresh points, the gathers
// and atomics of its corners.  In query order they fall anywhere in the
// stack; the blocks of one z bin touch three slabs of each cell, which
// stay in L2.
//
// Design:
// * The TPU kernels sort the queries by z bin, pad each bin to whole
//   blocks, and contract one-hot panels against each block's three slabs
//   on the MXU.  Only the sort is carried over: the lanes of a query walk
//   its own corners (fused_rows.cuh) over every cell, each cell's floor
//   taken as floor(base + offset).  A corner outside the volume is
//   dropped, so the queries of the clamped edge bins and the slabs
//   outside [0, D - 1] need no mask (the JAX kernels' zmask and kmask).
// * blend, three stages in one entry point.  A tiled transpose copies the
//   cells into a texel-major (D, H, W, N, C) temporary (0.41 ms at
//   16 x 4 x 128^3, bound 0.32).  The gather (csrc/texel_gather.cuh,
//   shared with fused3b_blend) then serves a table block a block with a
//   few lanes a query: at C = 4 two, over its cells 2j and 2j + 1, so
//   one warp instruction reads both 16-byte records of a texel, a whole
//   sector (75 M sectors at 1 M points where a thread a query reading
//   the planar cells took 509 M, one a 4-byte load;
//   scripts/count_brick_flush.py).  Each query's rows go to a (Q, 7, C)
//   temporary, 112 contiguous bytes at C = 4, and the transpose writes
//   them out as (7, C, Q): stored in query order straight from the
//   lanes, each of a query's 28 values took a sector of its own (27 M at
//   1 M points, against 4 M).  The wrapper allocates both temporaries.
//   Below a measured number of points a texel (ops/cuda/fused3s.py
//   planar) the copy costs more than it saves, and the gather reads the
//   cells in place, a channel a load: at 100 000 points on 16 x 4 x 128^3
//   0.50 ms against 0.62, at 200 000 0.84 against 0.74.
// * bwd (csrc/texel_scatter.cuh, shared with fused3b_bwd): a block per
//   table block stages its queries' points and cotangents, and a warp's
//   lanes run over (query, cell).  Into a texel-major (D, H, W, N, C)
//   scratch (zeroed by the wrapper, ops/cuda/fused3s.py), neighbouring
//   lanes add neighbouring 16-byte records of one texel with float4
//   atomics: 7.5 M sectors for 12.8 M reductions at 100 000 points on
//   16 x 4 x 128^3, where a thread a query adding planar scalars took
//   51 M sectors for 51 M (scripts/count_brick_flush.py).  A tiled
//   transpose then writes the cells' (N, C, D, H, W) layout: torch's
//   permuted copy of the 537 MB scratch took 4.4 ms, its strided reads a
//   sector a float; the tile reads and writes whole lines (1.07 GB, a
//   0.32 ms bound; the transpose takes ~0.40 ms).  At 100 000 points the
//   scatter is bound by its sectors, not by latency: adding in place
//   into (N, C, D, H, W) took 1.94 ms with lanes over cells and 1.35 with
//   lanes over queries, against 0.83 through the scratch (1 M points:
//   8.1, 7.1 and 2.4; PERF.md section 6), so the planar layout is gone.
//   f32 atomics: not deterministic.
// * The transpose (entry point texel_transpose, any 4- or 8-byte element)
//   is also the layout move of ops/cuda/fused3b.py cells_to_vol /
//   vol_to_cells on the card, where torch's permuted copies took 0.80 and
//   4.30 ms at 16 x 4 x 128^3.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fused_rows.cuh"
#include "texel_gather.cuh"
#include "texel_scatter.cuh"

namespace {

using csm::CellGeom;
using csm::SamplerParams;

constexpr int kQBlock = 128;  // queries of a table block, threads a block

struct Block {
  int first;  // first sorted slot
  int count;  // queries
};

__device__ __forceinline__ Block block_of(const int* __restrict__ table) {
  const int* t = table + 3 * blockIdx.x;
  return Block{t[1], t[2]};
}

// Block (bx, by): table block bx's queries, channels [by * groups * G,
// ...) of c, gathered from the texel-major copy vol (D, H, W, N, C), or
// where PLANAR from the cells (N, C, D, H, W) themselves
// (csrc/texel_gather.cuh), into rows (Q, 7, C) in query order.
template <int G, bool VEC, int THREADS, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
    blend_kernel(const float* __restrict__ vol,
                 const float* __restrict__ points,
                 const int* __restrict__ perm, const int* __restrict__ table,
                 float* __restrict__ rows, int n, int c, CellGeom<3> geom,
                 int q, csm::GatherLayout lay, SamplerParams p) {
  const Block b = block_of(table);
  if (b.count == 0) return;
  const bool mine = static_cast<int>(threadIdx.x) < b.count;
  csm::gather_block<G, VEC, true, PLANAR>(
      csm::GatherQuery{mine, mine ? perm[b.first + threadIdx.x] : 0}, points,
      vol, rows, q, n, c, lay, geom, p);
}

// Block (bx, by): table block bx's queries, channel groups [by *
// block_groups, ...) of c (csrc/texel_scatter.cuh), into the zeroed
// texel-major scratch (D, H, W, N, C); VEC: scatter_vec.
template <int G, bool VEC>
__global__ void __launch_bounds__(csm::kScatterMaxThreads)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ points,
               const int* __restrict__ perm, const int* __restrict__ table,
               float* __restrict__ scratch, int n, int c, CellGeom<3> geom,
               int q, csm::ScatterLayout lay, SamplerParams p) {
  const Block b = block_of(table);
  if (b.count == 0) return;
  const bool mine = static_cast<int>(threadIdx.x) < b.count;
  csm::scatter_block<G, VEC>(
      csm::ScatterQuery{mine, mine ? perm[b.first + threadIdx.x] : 0}, g, q,
      points, scratch, n, c, lay, geom, p);
}

constexpr int kTile = 32;      // transpose tile: kTile x kTile elements
constexpr int kTileRows = 8;   // thread rows a transpose block

// out (cols, rows) = in (rows, cols) transposed, T a 4- or 8-byte element
// copied bit for bit: the cells (N * C, D * H * W) to the texel-major
// (D * H * W, N * C) and back.  A shared-memory tile makes both the reads
// and the writes rows of kTile elements a warp.  The longer of the two
// axes goes on grid axis x (2^31 - 1 blocks), the shorter on y (65 535):
// at 128^3, D * H * W needs 65 536 tiles.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const T* __restrict__ in, T* __restrict__ out,
                     int64_t rows, int64_t cols, bool rows_on_x) {
  __shared__ T tile[kTile][kTile + 1];
  const int64_t r0 = (rows_on_x ? blockIdx.x : blockIdx.y) *
                     static_cast<int64_t>(kTile);
  const int64_t c0 = (rows_on_x ? blockIdx.y : blockIdx.x) *
                     static_cast<int64_t>(kTile);
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (r0 + i < rows && c0 + tx < cols)
      tile[i][tx] = in[(r0 + i) * cols + c0 + tx];
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (c0 + i < cols && r0 + tx < rows)
      out[(c0 + i) * rows + r0 + tx] = tile[tx][i];
}

// Launches transpose_kernel over (rows, cols) elements of elem_bytes (4 or
// 8) bytes on the stream.
cudaError_t transpose(const void* in, void* out, int64_t rows, int64_t cols,
                      int elem_bytes, cudaStream_t s) {
  if (rows == 0 || cols == 0) return cudaGetLastError();
  const bool rows_on_x = rows >= cols;
  const int64_t tx = (std::max(rows, cols) + kTile - 1) / kTile;
  const int64_t ty = (std::min(rows, cols) + kTile - 1) / kTile;
  if (tx > 2147483647 || ty > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tx), static_cast<unsigned>(ty));
  const dim3 block(kTile, kTileRows);
  if (elem_bytes == 4)
    transpose_kernel<uint32_t><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
        cols, rows_on_x);
  else if (elem_bytes == 8)
    transpose_kernel<uint64_t><<<grid, block, 0, s>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), rows,
        cols, rows_on_x);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Stage 1 transposes the cells (N, C, D, H, W) into vol, a texel-major
// (D, H, W, N, C) copy of them; stage 2 gathers from it into rows
// (Q, 7, C), which stage 3 transposes into out (7, C, Q).  planar: no
// stage 1, the gather reads the cells a channel a load (vol unused).
// The launch layout (width, groups, cell lanes) and threads a block come
// from ops/cuda/gather.py gather_geometry, planar from ops/cuda/fused3s.py.
int fused3s_blend(const void* cells, const void* points, const void* perm,
                  const void* table, void* vol, void* rows, void* out,
                  int n, int c, int d, int h, int w, int q, int nb,
                  int width, int groups, int cell_lanes, int threads,
                  int planar, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  static_assert(kQBlock == csm::kGatherQueries, "one table block a block");
  if (q == 0 || c == 0) return cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nb == 0 || d * h * w == 0)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(7) * c * q * 4, s);
  cudaError_t err = cudaSuccess;
  if (!planar) {
    err = transpose(cells, vol, static_cast<int64_t>(n) * c,
                    static_cast<int64_t>(d) * h * w, 4, s);
    if (err != cudaSuccess) return err;
  }
  const csm::GatherLayout lay{width, groups, cell_lanes};
  const auto gather = [&](auto pick, const void* src) {
    return csm::launch_gather(
        lay, c, threads, nb, s, pick, static_cast<const float*>(src),
        static_cast<const float*>(points), static_cast<const int*>(perm),
        static_cast<const int*>(table), static_cast<float*>(rows), n, c,
        csm::cell_geom3(d, h, w), q, lay,
        csm::make_params(kernel, padding, align, multicell, strict,
                         off_step, off_stop));
  };
  // planar cells take scalar loads whatever the channel count
  err = planar ? gather(
                     [](auto gw, auto, auto threads) {
                       return &blend_kernel<decltype(gw)::value, false,
                                            decltype(threads)::value, true>;
                     },
                     cells)
               : gather(
                     [](auto gw, auto vec, auto threads) {
                       return &blend_kernel<decltype(gw)::value,
                                            decltype(vec)::value,
                                            decltype(threads)::value, false>;
                     },
                     vol);
  if (err != cudaSuccess) return err;
  return transpose(rows, out, q, static_cast<int64_t>(csm::kRows<3>) * c, 4,
                   s);
}

// The scatter adds into scratch (texel-major (D, H, W, N, C), zeroed) and
// a second kernel transposes it into out (N, C, D, H, W).  The launch
// layout (width, block_groups, lane_groups, lanes) and threads a block
// come from ops/cuda/scatter.py scatter_geometry.
int fused3s_bwd(const void* g, const void* points, const void* perm,
                const void* table, void* scratch, void* out, int n, int c,
                int d, int h, int w, int q, int nb, int width,
                int block_groups, int lane_groups, int lanes, int threads,
                int kernel, int padding, int align, int multicell, int strict,
                float off_step, float off_stop, void* stream) {
  static_assert(kQBlock == csm::kScatterQueries, "one table block a block");
  if (q == 0 || n == 0 || c == 0 || nb == 0 || d * h * w == 0)
    return cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  const csm::ScatterLayout lay{width, block_groups, lane_groups, lanes};
  const cudaError_t err = csm::launch_scatter(
      lay, c, threads, nb, s,
      [](auto gw, auto vec) {
        return &bwd_kernel<decltype(gw)::value, decltype(vec)::value>;
      },
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<const int*>(perm), static_cast<const int*>(table),
      static_cast<float*>(scratch), n, c, csm::cell_geom3(d, h, w), q, lay,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop));
  if (err != cudaSuccess) return err;
  return transpose(scratch, out, static_cast<int64_t>(d) * h * w,
                   static_cast<int64_t>(n) * c, 4, s);
}

// out (cols, rows) = in (rows, cols) transposed, elements of elem_bytes
// (4 or 8) bytes copied bit for bit: the layout move of
// ops/cuda/fused3b.py cells_to_vol / vol_to_cells.
int texel_transpose(const void* in, void* out, int rows, int cols,
                    int elem_bytes, void* stream) {
  return transpose(in, out, rows, cols, elem_bytes,
                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
