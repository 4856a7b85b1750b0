// The fused rows of one block of queries, gathered from the texel-major
// (*S, N, C) volume with a few lanes a query, in 2D and 3D: the forward
// body that fused3b_blend (csrc/fused3b.cu), fused3s_blend
// (csrc/fused3s.cu), and through fused_gather_blend below the v1 blend
// (csrc/fused.cu), fused2w_blend, fused3w_blend, fused2d_blend and
// fused3d_blend share, the mirror of csrc/texel_scatter.cuh.
//
// Why a few lanes a query: the texel-major layout keeps one texel's N * C
// values together, and the cells of one query are shifted by less than a
// texel, so at one corner the query's cells 2j and 2j + 1 usually read
// neighbouring 16-byte records of one texel at C = 4.  A thread a query
// over its cells reads them in two warp instructions; where a warp's
// queries are scattered over a z slab (fused3s's table blocks) each
// 16-byte load takes a sector of its own.  Two lanes a query taking cells
// 2j and 2j + 1 read both records of each of 16 queries in one
// instruction, a whole sector, while a lane's walk per (query, cell)
// stays what a thread's was.  Above 4 channels the lanes can split the
// channels instead: lane g of `groups` takes the 4-channel quads g,
// g + groups, ..., so that at C = 16 (two lanes, 8 channels each) one
// instruction reads quads 0 and 1 of a record, the next quads 2 and 3:
// whole sectors again, and every channel of a query in one pass over the
// volume.  Where a block's queries share a brick (fused3b's plan blocks)
// L1 already merges the records of neighbouring cells, and the host's
// rule gives C <= 8 a thread a query (ops/cuda/gather.py).
//
// A block serves at most kGatherQueries queries: it compacts the valid
// ones with a warp ballot and stages their points in shared memory (each
// read once), then its warps take them in turns, 32 / lanes queries a warp
// at once.  A lane walks its cells with the per-query corner walk of
// fused_rows.cuh (tables, then 2^D corners) and keeps its (1 + 2D) x G
// rows in registers; the lanes of a query that split its cells add their
// rows by warp shuffles, and the lanes that split its channels store
// their own.  Loads are float4 where C is a multiple of 4 (VEC), scalars
// otherwise.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"

namespace csm {

// queries a block serves at most: fused3b's plan block, fused3s's table
// block
constexpr int kGatherQueries = 128;
constexpr int kGatherMaxThreads = 256;

// How a block's lanes cover its work, from the host (ops/cuda/gather.py
// GatherGeometry, which the tests check):
// * channels: a lane holds `width` (<= 8) of them; `groups` lanes split a
//   block's channels, lane g taking units g, g + groups, ... of 4
//   channels (VEC) or of one; a block serves groups * width channels and
//   grid axis y walks the rest;
// * cells: `cell_lanes` lanes (a power of 2) split a query's cells, lane
//   m taking cells m, m + cell_lanes, ...;
// * a query takes groups * cell_lanes <= 32 lanes, lane groups * m + g;
//   a warp serves 32 / (groups * cell_lanes) queries at once.
struct GatherLayout {
  int width;
  int groups;
  int cell_lanes;
};

__host__ __device__ inline int gather_lanes(const GatherLayout& lay) {
  return lay.groups * lay.cell_lanes;
}

// Whether a gather of c channels in lanes of `width` takes float4 loads:
// every record 16-byte aligned and a lane's channels whole quads.
inline bool gather_vec(int c, int width) {
  return c % 4 == 0 && width % 4 == 0;
}

// Where one query's values come from and go: row `col` of the (cols, 3)
// points and column `col` of the (7, C, cols) rows.
struct GatherQuery {
  bool valid;
  int col;
};

// The block's rows of channels [blockIdx.y * groups * width, ...) of c
// from the texel-major vol (*S, N, C) into out, for the valid queries
// among threads t < kGatherQueries (compacted in order; nothing is
// written for the others); R = 1 + 2D rows.  out is (R, C, cols), or
// (cols, R, C) where QMAJOR: a query's rows then take a few whole
// sectors (3D, C = 4: 112 bytes) where in (R, C, cols) each of its R * C
// values takes one of its own when the block's queries are scattered
// over the columns.  VEC: gather_vec.  PLANAR: vol is the cells (N, C,
// *S) instead, read a scalar a channel (fused3s_blend and the v1 blend
// below the stack's transpose's crossover).  Every thread of the block
// must call it.
template <int D, int G, bool VEC, bool QMAJOR, bool PLANAR = false>
__device__ __forceinline__ void gather_block(
    GatherQuery mine, const float* __restrict__ pts,
    const float* __restrict__ vol, float* __restrict__ out, int cols, int n,
    int c, const GatherLayout& lay, const CellGeom<D>& geom,
    const SamplerParams& p) {
  constexpr int R = kRows<D>;
  constexpr int U = VEC ? 4 : 1;       // channels of a load
  constexpr int K = G / U;             // loads a corner
  static_assert(!VEC || G % 4 == 0, "float4 loads");
  static_assert(!(VEC && PLANAR), "planar cells are read a channel a load");
  __shared__ float psm[kGatherQueries][D];
  __shared__ int colsm[kGatherQueries];
  __shared__ int warp_count[kGatherMaxThreads / 32];
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int nwarps = blockDim.x / 32;

  // compact the valid queries: rank among them, and their count
  const bool valid = t < kGatherQueries && mine.valid;
  const unsigned ballot = __ballot_sync(~0u, valid);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1)), count = 0;
  for (int w = 0; w < nwarps; ++w) {
    rank += w < warp ? warp_count[w] : 0;
    count += warp_count[w];
  }
  if (count == 0) return;
  if (valid) {
#pragma unroll
    for (int i = 0; i < D; ++i) psm[rank][i] = pts[D * mine.col + i];
    colsm[rank] = mine.col;
  }
  __syncthreads();

  const int lanes = gather_lanes(lay);
  const int qpw = 32 / lanes;          // queries a warp serves at once
  const int qo = lane / lanes;
  const int sub = lane - qo * lanes;
  const int g = sub % lay.groups;      // the lane's channel units
  const int m = sub / lay.groups;      // the lane's cells
  const int cblk = blockIdx.y * lay.groups * G;
  const int cb = min(lay.groups * G, c - cblk) / U;   // units of the block
  // a unit's stride: along the record, or from plane to plane
  const int64_t stride = PLANAR ? geom.texels : U;
  const float* base = vol + (cblk + g * U) * (PLANAR ? stride : 1);
  // the rounds are warp-uniform, so every lane reaches the shuffles
  for (int j0 = warp * qpw; j0 < count; j0 += nwarps * qpw) {
    const int j = j0 + qo;
    const bool act = qo < qpw && j < count;
    float acc[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < G; ++k) acc[r][k] = 0.0f;
    if (act) {
      float pt[D];
#pragma unroll
      for (int i = 0; i < D; ++i) pt[i] = psm[j][i];
      for (int ni = m; ni < n; ni += lay.cell_lanes) {
        for_each_corner<D>(
            geom, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
              const float* src =
                  PLANAR ? base + static_cast<int64_t>(ni) * c * stride + idx
                         : base + (static_cast<int64_t>(idx) * n + ni) * c;
              float v[G];
#pragma unroll
              for (int k = 0; k < K; ++k) {
                const bool in = g + k * lay.groups < cb;
                if constexpr (VEC) {
                  const float4 q =
                      in ? __ldg(reinterpret_cast<const float4*>(
                               src + 4 * k * lay.groups))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                  v[4 * k] = q.x;
                  v[4 * k + 1] = q.y;
                  v[4 * k + 2] = q.z;
                  v[4 * k + 3] = q.w;
                } else {
                  v[k] = in ? __ldg(src + k * lay.groups * stride) : 0.0f;
                }
              }
#pragma unroll
              for (int k = 0; k < G; ++k)
#pragma unroll
                for (int r = 0; r < R; ++r)
                  acc[r][k] = fmaf(wr[r], v[k], acc[r][k]);
            });
      }
    }
    // the query's cell lanes m > 0 add into m = 0, halving each time
    for (int off = lanes / 2; off >= lay.groups; off /= 2)
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < G; ++k)
          acc[r][k] += __shfl_down_sync(~0u, acc[r][k], off);
    if (act && m == 0) {
      const int col = colsm[j];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (g + k * lay.groups >= cb) continue;
        const int ch = cblk + (g + k * lay.groups) * U;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (QMAJOR && VEC) {
            *reinterpret_cast<float4*>(
                out + (static_cast<int64_t>(col) * R + r) * c + ch) =
                make_float4(acc[r][4 * k], acc[r][4 * k + 1],
                            acc[r][4 * k + 2], acc[r][4 * k + 3]);
          } else {
#pragma unroll
            for (int i = 0; i < U; ++i)
              out[QMAJOR ? (static_cast<int64_t>(col) * R + r) * c + ch + i
                         : static_cast<int64_t>(r * c + ch + i) * cols +
                               col] = acc[r][U * k + i];
          }
        }
      }
    }
  }
}

// Checks the layout against c channels and a block of `threads` (128 or
// kGatherMaxThreads), then launches pick(G, VEC, THREADS) with G =
// lay.width, VEC = gather_vec(c, width) and THREADS = threads as
// std::integral_constant / std::bool_constant, on a grid of (blocks,
// channel blocks), with args...; the kernel, whose __launch_bounds__ are
// THREADS, calls gather_block<D, G, VEC, ...>.  Bounds of 128 where 128
// threads run: at config 5 fused3b_blend took 0.94-0.97 ms with them
// and 1.04-1.05 with bounds of 256 at the same launch (PERF.md section
// 6).  G is at most kMaxChannels, or WIDE where the caller takes a lane
// of WIDE channels (the v1 blend in 2D: 16).
template <int WIDE = kMaxChannels, typename Pick, typename... Args>
cudaError_t launch_gather(const GatherLayout& lay, int c, int threads,
                          unsigned blocks, cudaStream_t stream, Pick pick,
                          Args... args) {
  const int lanes = gather_lanes(lay);
  if (lay.width < 1 ||
      (lay.width > kMaxChannels && lay.width != WIDE) || lay.groups < 1 ||
      lay.cell_lanes < 1 || (lay.cell_lanes & (lay.cell_lanes - 1)) != 0 ||
      lanes > 32 ||
      (threads != kGatherQueries && threads != kGatherMaxThreads))
    return cudaErrorInvalidValue;
  const int grid_y = cdiv(c, lay.groups * lay.width);
  const bool vec = gather_vec(c, lay.width);
  const auto launch = [&](auto gw) {
    constexpr int G = decltype(gw)::value;
    using Small = std::integral_constant<int, kGatherQueries>;
    using Large = std::integral_constant<int, kGatherMaxThreads>;
    const bool small = threads == kGatherQueries;
    auto* kernel = small ? pick(gw, std::false_type{}, Small{})
                         : pick(gw, std::false_type{}, Large{});
    if constexpr (G % 4 == 0)
      if (vec)
        kernel = small ? pick(gw, std::true_type{}, Small{})
                       : pick(gw, std::true_type{}, Large{});
    kernel<<<dim3(blocks, grid_y), threads, 0, stream>>>(args...);
    return cudaGetLastError();
  };
  if constexpr (WIDE > kMaxChannels)
    if (lay.width == WIDE) return launch(std::integral_constant<int, WIDE>{});
  return dispatch_channels(lay.width, launch);
}

// The fused op's blend over points in query order, defined in
// csrc/fused.cu for D = 2 and 3: the v1 blend's, fused2w_blend's,
// fused3w_blend's, fused2d_blend's and fused3d_blend's.  The tiled
// transpose copies the
// cells (N, C, *S) into vol, a texel-major (*S, N, C) temporary, and
// gather_block serves blocks of `qblock` (<= kGatherQueries) queries in
// order with the layout `lay` and `threads` a block, its lanes storing
// the rows out (1 + 2D, C, Q) directly (queries in order: a warp's
// stores cover whole sectors); where `planar` it reads the cells in
// place and vol is not used.  The v1, fused2w and fused3w blends take
// kGatherQueries; fused2d and fused3d take a few queries a block, so
// that a small cloud fills the card.
template <int D>
cudaError_t fused_gather_blend(const float* cells, const float* points,
                               float* vol, float* out, int n, int c,
                               const CellGeom<D>& geom, int q,
                               const GatherLayout& lay, int threads,
                               bool planar, const SamplerParams& p,
                               cudaStream_t s, int qblock = kGatherQueries);

}  // namespace csm
