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
//   on the MXU.  Only the sort is carried over: a thread per query walks
//   its own corners (fused_rows.cuh) over every cell, each cell's floor
//   taken as floor(base + offset), reading the cells in place.  A corner
//   outside the volume is dropped, so the queries of the clamped edge
//   bins and the slabs outside [0, D - 1] need no mask (the JAX kernels'
//   zmask and kmask).
// * blend blocks: (table block, channel group).  The rows go back to query
//   order through perm.
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
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"
#include "texel_scatter.cuh"

namespace {

using csm::CellGeom;
using csm::kGroupChannels;
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

__global__ void __launch_bounds__(kQBlock)
    blend_kernel(const float* __restrict__ cells,
                 const float* __restrict__ points,
                 const int* __restrict__ perm, const int* __restrict__ table,
                 float* __restrict__ out, int n, int c, int cw, CellGeom<3> g,
                 int q, SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  const Block b = block_of(table);
  if (static_cast<int>(threadIdx.x) >= b.count) return;
  const int c0 = blockIdx.y * cw;
  const int cg = min(cw, c - c0);
  const int qi = perm[b.first + threadIdx.x];
  const float pt[3] = {points[3 * qi], points[3 * qi + 1],
                       points[3 * qi + 2]};
  float acc[R][kGroupChannels];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j) acc[r][j] = 0.0f;
  for (int ni = 0; ni < n; ++ni) {
    const float* cell = cells + (static_cast<int64_t>(ni) * c + c0) * g.texels;
    csm::for_each_corner<3>(
        g, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
#pragma unroll
          for (int j = 0; j < kGroupChannels; ++j) {
            if (j < cg) {
              const float v = cell[idx + j * g.texels];
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][j] = fmaf(wr[r], v, acc[r][j]);
            }
          }
        });
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j)
      if (j < cg)
        out[static_cast<int64_t>(r * c + c0 + j) * q + qi] = acc[r][j];
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

constexpr int kTile = 32;      // transpose tile: kTile x kTile floats
constexpr int kTileRows = 8;   // thread rows a transpose block

// out (cols, rows) = in (rows, cols) transposed: the texel-major scratch
// (D * H * W, N * C) back to the cells' (N * C, D * H * W), through a
// shared-memory tile so that both the reads and the writes are rows of
// 128 bytes a warp.
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int64_t rows, int cols) {
  __shared__ float tile[kTile][kTile + 1];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int c0 = blockIdx.y * kTile;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (r0 + i < rows && c0 + tx < cols)
      tile[i][tx] = __ldg(in + (r0 + i) * cols + c0 + tx);
  __syncthreads();
  for (int i = threadIdx.y; i < kTile; i += kTileRows)
    if (c0 + i < cols && r0 + tx < rows)
      out[static_cast<int64_t>(c0 + i) * rows + r0 + tx] = tile[tx][i];
}

}  // namespace

extern "C" {

int fused3s_blend(const void* cells, const void* points, const void* perm,
                  const void* table, void* out, int n, int c, int d, int h,
                  int w, int q, int nb, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  if (q == 0 || c == 0) return cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nb == 0)
    return cudaMemsetAsync(out, 0, static_cast<size_t>(7) * c * q * 4, s);
  const SamplerParams p = csm::make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  const int cw = csm::group_width(c);
  const dim3 grid(nb, csm::channel_groups(c));
  blend_kernel<<<grid, kQBlock, 0, s>>>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<const int*>(perm), static_cast<const int*>(table),
      static_cast<float*>(out), n, c, cw, csm::cell_geom3(d, h, w), q, p);
  return cudaGetLastError();
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
  const int64_t rows = static_cast<int64_t>(d) * h * w;
  const int cols = n * c;
  if (csm::cdiv(cols, kTile) > 65535) return cudaErrorInvalidValue;
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
  transpose_kernel<<<dim3(static_cast<unsigned>((rows + kTile - 1) / kTile),
                          csm::cdiv(cols, kTile)),
                     dim3(kTile, kTileRows), 0, s>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), rows,
      cols);
  return cudaGetLastError();
}

}  // extern "C"
