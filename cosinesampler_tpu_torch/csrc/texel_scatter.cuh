// The transpose of the fused rows for one block of queries, added into
// the cells with a warp's lanes over (query, cell), in 2D and 3D: the
// backward body that fused3b_bwd (csrc/fused3b.cu), fused3s_bwd
// (csrc/fused3s.cu), and through fused_scatter_bwd below the v1 bwd
// (csrc/fused.cu), fused2w_bwd and fused3w_bwd share.
//
// Why lanes over cells: the texel-major layout (*S, N, C) keeps one
// texel's N * C values together, and the cells of one query are shifted
// by less than a texel, so at one corner the 16 cells of a query fall on
// a few contiguous runs of 16-byte records.  Lanes over cells put those
// runs in one warp instruction, so its reductions reach L2 in shared
// 32-byte sectors; a thread a query over its cells (the design before)
// spent a sector on each 16-byte (or, planar, 4-byte) reduction.  At
// BASELINE config 5 (16 x 4 x 128^3, 1M points) 75 M sectors for the
// 128 M reductions instead of 124 M (scripts/count_brick_flush.py).
//
// A block serves at most kScatterQueries queries: it compacts the valid
// ones, stages their points and their (7, channels) cotangents in shared
// memory (each query's read once), then its warps take the queries in
// turns (ScatterLayout below).  A lane computes its cell's axis tables
// once, and for each channel group it carries loads the group's
// cotangent into registers and walks the 2^D corners: the (1 + 2D)-row dot
// (fused_rows.cuh's FMA order) and the group's reductions, one float4 a
// corner for a group of 4 channels (VEC), scalars otherwise.  At C = 16
// the lanes run over (cell, group of 4): 16 cells x 4 groups a query, so
// a warp's 32 float4 reductions cover 8 cells' contiguous 64 bytes.
// PLANAR adds scalars into the cells' own (N, C, *S) layout instead: for
// a call with few points a texel of a large stack, where zeroing and
// transposing a texel-major scratch would cost more than the sectors it
// saves.
//
// Measured at config 5 on the H100 (PERF.md section 6): the reductions
// now take ~0.2 of fused3b_bwd's ~1.2 ms kernel at C = 4; the walk (the
// per-(query, cell) tables and weights, 166 registers a thread) takes the
// rest.  A rolled corner loop (96 registers) or a 128-register cap ran
// no faster at C = 4 and 15% slower at C = 16; batching the staging loads
// changed nothing.  f32 atomics: not deterministic.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "fused_rows.cuh"

namespace csm {

// queries a block serves at most: fused3b's plan block, fused3s's table
// block
constexpr int kScatterQueries = 128;
constexpr int kScatterMaxThreads = 256;

// How a block's lanes cover its work, from the host (ops/cuda/scatter.py
// ScatterGeometry, which the tests check):
// * channels: groups of `width` (<= 8) channels, the last one partial;
//   a block serves `block_groups` of them (grid axis y walks the rest),
//   of which `lane_groups` are spread over a query's lanes and each lane
//   loops over the other block_groups / lane_groups;
// * a query's work is n * lane_groups units (cell, lane group), unit u
//   being cell u / lane_groups; `lanes` lanes (<= 32) share a query,
//   lane l of them taking units l, l + lanes, ...; a warp serves
//   32 / lanes queries at once, and the block's warps take the block's
//   queries in turns.
struct ScatterLayout {
  int width;
  int block_groups;
  int lane_groups;
  int lanes;
};

// The shared memory of a block (bytes): the staged cotangent of
// block_channels channels and the points, kScatterQueries of each.
template <int D>
__host__ __device__ inline int scatter_smem_bytes(int block_channels) {
  return 4 * (kRows<D> * block_channels + D) * kScatterQueries;
}

// Where one query's values come from: column `col` of the (1 + 2D, C,
// cols) cotangent and row `col` of the (cols, D) points.
struct ScatterQuery {
  bool valid;
  int col;
};

// dst[k * stride] += v[k], k < cg, atomically; float4 atomics where VEC
// (G a multiple of 4, cg == G and stride 1, 16-byte aligned).
template <int G, bool VEC>
__device__ __forceinline__ void add_channels(float* dst, int cg,
                                             int64_t stride,
                                             const float (&v)[G]) {
  if constexpr (VEC) {
    static_assert(G % 4 == 0, "float4 reductions");
#pragma unroll
    for (int k = 0; k < G; k += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + k),
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (k < cg) atomicAdd(dst + k * stride, v[k]);
  }
}

// Whether a scatter of c channels in groups of `width` takes float4
// reductions (VEC): every group full and 4 channels wide or a multiple,
// so that every record starts 16-byte aligned.
inline bool scatter_vec(int c, int width) {
  return width % 4 == 0 && c % width == 0;
}

// The block's scatter into the texel-major (*S, N, C) out, or where
// PLANAR into the cells' own (N, C, *S) layout (scalar reductions, each
// channel a plane apart), which must hold the sum so far (zeros).
// Thread t < kScatterQueries holds staging slot t: `mine` says whether
// it is a query and which column; the valid slots are compacted in
// order.  VEC: scatter_vec.  Every thread of the block must call it.
template <int D, int G, bool VEC, bool PLANAR = false>
__device__ __forceinline__ void scatter_block(
    ScatterQuery mine, const float* __restrict__ g, int cols,
    const float* __restrict__ pts, float* __restrict__ out, int n, int c,
    const ScatterLayout& lay, const CellGeom<D>& geom,
    const SamplerParams& p) {
  static_assert(!(VEC && PLANAR), "planar cells take scalar reductions");
  constexpr int R = kRows<D>;
  constexpr int Q = kScatterQueries;
  extern __shared__ float smem[];
  __shared__ int warp_count[kScatterMaxThreads / 32];
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int nwarps = blockDim.x / 32;

  // compact the valid slots: rank among them, and their count
  const bool valid = t < Q && mine.valid;
  const unsigned ballot = __ballot_sync(~0u, valid);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1)), count = 0;
  for (int w = 0; w < nwarps; ++w) {
    rank += w < warp ? warp_count[w] : 0;
    count += warp_count[w];
  }
  if (count == 0) return;

  const int groups = (c + G - 1) / G;
  const int grp0 = blockIdx.y * lay.block_groups;
  const int cblk = grp0 * G;
  const int cb = min(lay.block_groups * G, c - cblk);
  float* gsm = smem;                       // [R][cb][Q]
  float* psm = smem + R * cb * Q;          // [Q][D]
  if (valid) {
#pragma unroll
    for (int i = 0; i < D; ++i) psm[D * rank + i] = pts[D * mine.col + i];
    for (int r = 0; r < R; ++r)
      for (int ch = 0; ch < cb; ++ch)
        gsm[(r * cb + ch) * Q + rank] = __ldg(
            g + static_cast<int64_t>(r * c + cblk + ch) * cols + mine.col);
  }
  __syncthreads();

  const int qpw = 32 / lay.lanes;       // queries a warp serves at once
  const int qo = lane / lay.lanes;
  if (qo >= qpw) return;
  const int u0 = lane % lay.lanes;
  const int units = n * lay.lane_groups;
  // the rule spreads all of a block's groups over the lanes (loops = 1),
  // but this run-time loop stays: without it the compiler keeps 80
  // registers and spills, where the loop keeps the tables in 161, and
  // fused3b_bwd ran 1.61-1.76 ms against 1.37-1.43 at config 5 (C = 16:
  // 6.5-7.3 against 5.6-5.9; PERF.md section 6)
  const int loops = lay.block_groups / lay.lane_groups;
  for (int j = warp * qpw + qo; j < count; j += nwarps * qpw) {
    float pt[D];
#pragma unroll
    for (int i = 0; i < D; ++i) pt[i] = psm[D * j + i];
    for (int u = u0; u < units; u += lay.lanes) {
      const int ni = u / lay.lane_groups;
      const int gs = u - ni * lay.lane_groups;
      AxisTable a[D];
      corner_tables<D>(geom, pt, ni, n, p, a);
      for (int k = 0; k < loops; ++k) {
        const int grp = grp0 + gs + k * lay.lane_groups;
        if (grp >= groups) break;
        const int c0 = grp * G;
        const int cg = VEC ? G : min(G, c - c0);
        float gv[R][G];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int jj = 0; jj < G; ++jj)
            gv[r][jj] =
                jj < cg ? gsm[(r * cb + c0 - cblk + jj) * Q + j] : 0.0f;
        // a texel's records (*S, N, C), or a cell's planes (N, C, *S)
        const int64_t texel_stride = PLANAR ? 1 : static_cast<int64_t>(n) * c;
        const int64_t chan_stride = PLANAR ? geom.texels : 1;
        float* base = out + (static_cast<int64_t>(ni) * c + c0) *
                                (PLANAR ? geom.texels : 1);
        for_each_table_corner<D>(
            geom, a, [&](const int (&)[D], int idx, const float (&wr)[R]) {
              float v[G];
#pragma unroll
              for (int jj = 0; jj < G; ++jj) {
                float s = 0.0f;
#pragma unroll
                for (int r = 0; r < R; ++r) s = fmaf(wr[r], gv[r][jj], s);
                v[jj] = s;
              }
              add_channels<G, VEC>(base + idx * texel_stride, cg,
                                   chan_stride, v);
            });
      }
    }
  }
}

// Checks the layout against c channels and a block of `threads` (and its
// shared memory against the device), then launches pick(G, VEC) with
// G = lay.width and VEC = scatter_vec(c, lay.width) as
// std::integral_constant / std::bool_constant, on a grid of (blocks,
// channel blocks), with args...; the kernel calls scatter_block<D, G,
// VEC>.
template <int D, typename Pick, typename... Args>
cudaError_t launch_scatter(const ScatterLayout& lay, int c, int threads,
                           unsigned blocks, cudaStream_t stream, Pick pick,
                           Args... args) {
  if (lay.width < 1 || lay.width > kMaxChannels || lay.block_groups < 1 ||
      lay.lane_groups < 1 || lay.block_groups % lay.lane_groups != 0 ||
      lay.lanes < 1 || lay.lanes > 32 || threads < kScatterQueries ||
      threads > kScatterMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int grid_y = cdiv(cdiv(c, lay.width), lay.block_groups);
  const int smem =
      scatter_smem_bytes<D>(std::min(lay.block_groups * lay.width, c));
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;
  if (smem > lim.smem_optin) return cudaErrorInvalidValue;
  const bool vec = scatter_vec(c, lay.width);
  return dispatch_channels(lay.width, [&](auto gw) {
    constexpr int G = decltype(gw)::value;
    auto* kernel = pick(gw, std::false_type{});
    if constexpr (G % 4 == 0)
      if (vec) kernel = pick(gw, std::true_type{});
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(blocks, grid_y), threads, smem, stream>>>(args...);
    return cudaGetLastError();
  });
}

// The fused op's bwd over points in query order, defined in csrc/fused.cu
// for D = 2 and 3: the v1 bwd's, fused2w_bwd's and fused3w_bwd's.  g (1 +
// 2D, C, Q) at points (Q, D), in blocks of kScatterQueries queries in
// order with the layout `lay` and `threads` a block, is added into
// scratch (texel-major (*S, N, C), zeroed), which the tiled transpose then
// writes out as the cells cotangent out (N, C, *S); where `planar`, the
// scatter adds into out (zeroed) in place and scratch is not used.
template <int D>
cudaError_t fused_scatter_bwd(const float* g, const float* points,
                              float* scratch, float* out, int n, int c,
                              const CellGeom<D>& geom, int q,
                              const ScatterLayout& lay, int threads,
                              bool planar, const SamplerParams& p,
                              cudaStream_t s);

}  // namespace csm
