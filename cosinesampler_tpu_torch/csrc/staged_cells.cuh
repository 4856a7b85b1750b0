// The small-cloud fused 2D kernels' body (csrc/fused2d.cu), written for
// any D: the fused rows (value, d/dx_i, d2/dx_i2, summed over the
// multicell ensemble) and their cells transpose, served from chunks of
// cells staged in shared memory.  (csrc/fused3d.cu says why the 3D
// small-cloud pair stages nothing.)
//
// Block (bx, by, bz) serves queries [bx * q_per_block, ...) from cells
// [by * cells_per_chunk, ...) of channel group bz (fused_rows.cuh
// channel_groups / group_width), staged once with coalesced loads; a
// thread per query walks its corners in the staged copy.  With more than
// one chunk the blocks add their partial rows into the zeroed output with
// f32 atomics (not bit-deterministic).  The bwd accumulates a block's
// queries into a zeroed shared copy of its chunk with shared atomics and
// flushes it once with global atomicAdd (f32 atomics: not deterministic).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "fused_rows.cuh"

namespace csm {
namespace staged {

constexpr int kThreads = 128;
// fewest cells a chunk stages, so that staging a chunk is paid by the
// work it serves
constexpr int kMinChunkCells = 4;

struct Plan {
  int cw;           // channel group width
  int groups;       // channel groups
  int cells_per_chunk;
  int chunks;
  int q_blocks;
  int q_per_block;
  size_t bytes;     // dynamic shared memory of a block
};

// Chunks of at most 48 KB (or one cell group up to the opted-in limit),
// small enough that the grid fills the card twice over where the cells
// allow it.
inline cudaError_t make_plan(int n, int c, int texels, int q, Plan* plan) {
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;
  plan->cw = group_width(c);
  plan->groups = channel_groups(c);
  const int64_t group_bytes = static_cast<int64_t>(plan->cw) * texels * 4;
  if (group_bytes > lim.smem_optin) return cudaErrorInvalidValue;
  const int fit = static_cast<int>(
      std::max<int64_t>(1, kStaticSmemBytes / group_bytes));
  const int q_tiles = cdiv(q, kThreads);
  const int want_chunks =
      cdiv(2 * lim.sms, std::max(1, q_tiles * plan->groups));
  const int cells = std::max(kMinChunkCells, cdiv(n, want_chunks));
  plan->cells_per_chunk = std::min(n, std::min(fit, cells));
  plan->chunks = cdiv(n, plan->cells_per_chunk);
  plan->q_blocks = std::max(
      1, std::min(q_tiles, cdiv(2 * lim.sms, plan->chunks * plan->groups)));
  plan->q_per_block = cdiv(q, plan->q_blocks);
  plan->q_blocks = cdiv(q, plan->q_per_block);
  plan->bytes = static_cast<size_t>(plan->cells_per_chunk) * group_bytes;
  return cudaSuccess;
}

// dst[i] = src[i], i < len, by the whole block: 16-byte loads where both
// are 16-byte aligned and len is a multiple of 4, four of them in flight
// per thread before their stores.
__device__ __forceinline__ void copy_run(float* dst,
                                         const float* __restrict__ src,
                                         int len) {
  constexpr int kDepth = 4;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   (len & 3) == 0;
  if (vec) {
    const auto* s4 = reinterpret_cast<const float4*>(src);
    auto* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = len >> 2;
    for (int i = threadIdx.x; i < n4; i += kDepth * blockDim.x) {
      float4 v[kDepth];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int j = i + k * blockDim.x;
        if (j < n4) v[k] = __ldg(s4 + j);
      }
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int j = i + k * blockDim.x;
        if (j < n4) d4[j] = v[k];
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < len; i += kDepth * blockDim.x) {
    float v[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int j = i + k * blockDim.x;
      if (j < len) v[k] = __ldg(src + j);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int j = i + k * blockDim.x;
      if (j < len) dst[j] = v[k];
    }
  }
}

// Stages cells [n0, n1), channels [c0, c0 + cg) into s as (cell, channel,
// texel): one contiguous run of cg * texels values a cell.
__device__ __forceinline__ void stage(const float* __restrict__ cells,
                                      float* s, int n0, int n1, int c, int c0,
                                      int cg, int texels) {
  const int group_elems = cg * texels;
  for (int ln = 0; ln < n1 - n0; ++ln)
    copy_run(s + ln * group_elems,
             cells + (static_cast<int64_t>(n0 + ln) * c + c0) * texels,
             group_elems);
}

// ATOMIC: add the partial rows into out (zeroed); otherwise store them.
template <int D, bool ATOMIC>
__global__ void __launch_bounds__(kThreads)
    blend_kernel(const float* __restrict__ cells,
                 const float* __restrict__ points, float* __restrict__ out,
                 int n, int c, int cw, CellGeom<D> g, int q,
                 int cells_per_chunk, int q_per_block, SamplerParams p) {
  constexpr int R = kRows<D>;
  extern __shared__ float scells[];
  const int c0 = blockIdx.z * cw;
  const int cg = min(cw, c - c0);
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  stage(cells, scells, n0, n1, c, c0, cg, g.texels);
  __syncthreads();
  const int q1 = min(q, static_cast<int>(blockIdx.x + 1) * q_per_block);
  for (int qi = blockIdx.x * q_per_block + threadIdx.x; qi < q1;
       qi += blockDim.x) {
    float pt[D];
#pragma unroll
    for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
    float acc[R][kGroupChannels];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j) acc[r][j] = 0.0f;
    blend_query_range<D, kGroupChannels>(scells, cg * g.texels, g, n0, n1, n,
                                         cg, pt, p, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j) {
        if (j < cg) {
          float* o = out + static_cast<int64_t>(r * c + c0 + j) * q + qi;
          if (ATOMIC) {
            atomicAdd(o, acc[r][j]);
          } else {
            *o = acc[r][j];
          }
        }
      }
  }
}

// dcells must be zeroed.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ points,
               float* __restrict__ dcells, int n, int c, int cw,
               CellGeom<D> geom, int q, int cells_per_chunk, int q_per_block,
               SamplerParams p) {
  constexpr int R = kRows<D>;
  extern __shared__ float sacc[];
  const int c0 = blockIdx.z * cw;
  const int cg = min(cw, c - c0);
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  const int group_elems = cg * geom.texels;
  const int chunk_elems = (n1 - n0) * group_elems;
  for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
  __syncthreads();
  const int q1 = min(q, static_cast<int>(blockIdx.x + 1) * q_per_block);
  for (int qi = blockIdx.x * q_per_block + threadIdx.x; qi < q1;
       qi += blockDim.x) {
    float gv[R][kGroupChannels];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kGroupChannels; ++j)
        gv[r][j] = j < cg
                       ? __ldg(g + static_cast<int64_t>(r * c + c0 + j) * q + qi)
                       : 0.0f;
    float pt[D];
#pragma unroll
    for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
    splat_query_range<D, kGroupChannels>(sacc, group_elems, geom, n0, n1, n,
                                         cg, pt, p, gv);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
    const float v = sacc[e];
    if (v != 0.0f) {
      const int ln = e / group_elems;
      atomicAdd(dcells + (static_cast<int64_t>(n0 + ln) * c + c0) *
                             geom.texels + (e - ln * group_elems), v);
    }
  }
}

template <int D>
cudaError_t launch_blend(const void* cells, const void* points, void* out,
                         int n, int c, const CellGeom<D>& g, int q,
                         const SamplerParams& p, cudaStream_t s) {
  if (q == 0 || c == 0) return cudaGetLastError();
  const size_t out_bytes = static_cast<size_t>(kRows<D>) * c * q * 4;
  if (n == 0) return cudaMemsetAsync(out, 0, out_bytes, s);
  Plan plan;
  cudaError_t err = make_plan(n, c, g.texels, q, &plan);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.q_blocks, plan.chunks, plan.groups);
  const auto* x = static_cast<const float*>(cells);
  const auto* pts = static_cast<const float*>(points);
  auto* o = static_cast<float*>(out);
  if (plan.chunks > 1) {
    err = cudaMemsetAsync(out, 0, out_bytes, s);
    if (err != cudaSuccess) return err;
    auto* kernel_fn = &blend_kernel<D, true>;
    err = allow_smem(kernel_fn, plan.bytes);
    if (err != cudaSuccess) return err;
    kernel_fn<<<grid, kThreads, plan.bytes, s>>>(
        x, pts, o, n, c, plan.cw, g, q, plan.cells_per_chunk,
        plan.q_per_block, p);
  } else {
    auto* kernel_fn = &blend_kernel<D, false>;
    err = allow_smem(kernel_fn, plan.bytes);
    if (err != cudaSuccess) return err;
    kernel_fn<<<grid, kThreads, plan.bytes, s>>>(
        x, pts, o, n, c, plan.cw, g, q, plan.cells_per_chunk,
        plan.q_per_block, p);
  }
  return cudaGetLastError();
}

// dcells (N, C, *S) must be zeroed.
template <int D>
cudaError_t launch_bwd(const void* g, const void* points, void* dcells,
                       int n, int c, const CellGeom<D>& geom, int q,
                       const SamplerParams& p, cudaStream_t s) {
  if (q == 0 || n == 0 || c == 0 || geom.texels == 0)
    return cudaGetLastError();
  Plan plan;
  cudaError_t err = make_plan(n, c, geom.texels, q, &plan);
  if (err != cudaSuccess) return err;
  err = allow_smem(&bwd_kernel<D>, plan.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.q_blocks, plan.chunks, plan.groups);
  bwd_kernel<D><<<grid, kThreads, plan.bytes, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(dcells), n, c, plan.cw, geom, q,
      plan.cells_per_chunk, plan.q_per_block, p);
  return cudaGetLastError();
}

}  // namespace staged
}  // namespace csm
