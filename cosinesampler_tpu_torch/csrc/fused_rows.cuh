// The fused rows of one query, in 2D and 3D, and the kernels built from
// them: fused2w / fused3w (value, jacobian, diagonal Hessian, summed over
// the multicell ensemble, and its cells transpose), shared with the mega2w
// train-step kernel.
//
// Rows, in the JAX package's order: value, d/dx_i for each grid axis i,
// then d2/dx_i2 for each grid axis i (1 + 2D rows).  Grid axis 0 (x)
// addresses W, axis 1 (y) H, axis 2 (z) D; a cell is C planes of
// prod(size) texels, x fastest.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "sampler_math.cuh"

namespace csm {

// Channel counts the fused kernels are instantiated for.
constexpr int kMaxChannels = 8;

template <int D>
struct CellGeom {
  int size[D];  // per grid axis: W, H(, D)
  int texels;   // prod(size)
};

template <int D>
constexpr int kRows = 1 + 2 * D;

// The geometry of a (D, H, W) cell.
inline CellGeom<3> cell_geom3(int d, int h, int w) {
  CellGeom<3> g;
  g.size[0] = w;
  g.size[1] = h;
  g.size[2] = d;
  g.texels = d * h * w;
  return g;
}

// Calls f(flat texel index, wr) for every in-bounds corner of the query
// at pt in cell ni, wr[r] being the corner's weight in row r.  Corners run
// with axis 0 fastest; a corner out of bounds (zeros padding) is dropped.
template <int D, typename F>
__device__ __forceinline__ void for_each_corner(const CellGeom<D>& g,
                                                const float (&pt)[D], int ni,
                                                int n, const SamplerParams& p,
                                                F&& f) {
  const float off = cell_offset(ni, n, p);
  AxisTable a[D];
#pragma unroll
  for (int i = 0; i < D; ++i) a[i] = axis_table(pt[i], g.size[i], off, p);
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    int idx = 0, stride = 1;
    bool ok = true;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int ci = a[i].i0 + ((k >> i) & 1);
      ok = ok && ci >= 0 && ci < g.size[i];
      idx += ci * stride;
      stride *= g.size[i];
    }
    if (!ok) continue;
    float wr[kRows<D>];
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r) {
      float w = 1.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int order = r == 1 + i ? 1 : (r == 1 + D + i ? 2 : 0);
        const float wi = a[i].w[order][(k >> i) & 1];
        w = i == 0 ? wi : w * wi;
      }
      wr[r] = w;
    }
    f(idx, wr);
  }
}

// acc[r][c] = row r, channel c of the query at pt, summed over all n cells.
template <int D, int C>
__device__ __forceinline__ void blend_query(const float* __restrict__ cells,
                                            const CellGeom<D>& g, int n,
                                            const float (&pt)[D],
                                            const SamplerParams& p,
                                            float (&acc)[kRows<D>][C]) {
#pragma unroll
  for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
  for (int ni = 0; ni < n; ++ni) {
    const float* cell = cells + static_cast<int64_t>(ni) * C * g.texels;
    for_each_corner<D>(g, pt, ni, n, p,
                       [&](int idx, const float (&wr)[kRows<D>]) {
#pragma unroll
                         for (int c = 0; c < C; ++c) {
                           const float v = __ldg(cell + c * g.texels + idx);
#pragma unroll
                           for (int r = 0; r < kRows<D>; ++r)
                             acc[r][c] = fmaf(wr[r], v, acc[r][c]);
                         }
                       });
  }
}

// Adds the transpose of blend_query for the cotangent gv into cells
// [n0, n1) of acc, which holds those cells only; atomically, since other
// threads add into the same texels.
template <int D, int C>
__device__ __forceinline__ void splat_query(float* acc, const CellGeom<D>& g,
                                            int n0, int n1, int n,
                                            const float (&pt)[D],
                                            const SamplerParams& p,
                                            const float (&gv)[kRows<D>][C]) {
  for (int ni = n0; ni < n1; ++ni) {
    float* cell = acc + static_cast<int64_t>(ni - n0) * C * g.texels;
    for_each_corner<D>(g, pt, ni, n, p,
                       [&](int idx, const float (&wr)[kRows<D>]) {
#pragma unroll
                         for (int c = 0; c < C; ++c) {
                           float v = 0.0f;
#pragma unroll
                           for (int r = 0; r < kRows<D>; ++r)
                             v = fmaf(wr[r], gv[r][c], v);
                           atomicAdd(cell + c * g.texels + idx, v);
                         }
                       });
  }
}

// The channel-looped kernels (csrc/fused.cu, csrc/fused2d.cu) take any
// channel count: grid axis z walks groups of at most kGroupChannels
// channels, whose rows a thread keeps in registers.
constexpr int kGroupChannels = 8;

// The groups of c channels: as few as hold `most` each, all of width
// group_width(c, most) but the last.
inline int channel_groups(int c, int most = kGroupChannels) {
  return cdiv(c, most);
}
inline int group_width(int c, int most = kGroupChannels) {
  return cdiv(c, channel_groups(c, most));
}

// acc[r][j] += row r of channel j < cg of the query at pt, over cells
// [n0, n1) of n: cell ni's plane j starts at
// cells + (ni - n0) * cell_stride + j * g.texels.  The channel range is
// given at run time, so one instance serves every group of a stack and
// both a global stack and a staged copy in shared memory.
template <int D, int G>
__device__ __forceinline__ void blend_query_range(
    const float* cells, int64_t cell_stride, const CellGeom<D>& g, int n0,
    int n1, int n, int cg, const float (&pt)[D], const SamplerParams& p,
    float (&acc)[kRows<D>][G]) {
  for (int ni = n0; ni < n1; ++ni) {
    const float* cell = cells + (ni - n0) * cell_stride;
    for_each_corner<D>(g, pt, ni, n, p,
                       [&](int idx, const float (&wr)[kRows<D>]) {
#pragma unroll
                         for (int j = 0; j < G; ++j) {
                           if (j < cg) {
                             const float v = cell[j * g.texels + idx];
#pragma unroll
                             for (int r = 0; r < kRows<D>; ++r)
                               acc[r][j] = fmaf(wr[r], v, acc[r][j]);
                           }
                         }
                       });
  }
}

// The transpose of blend_query_range: adds the cotangent gv of channels
// j < cg into cells [n0, n1) of acc, laid out as blend_query_range reads
// them; atomically (shared or global memory), since other threads add
// into the same texels.
template <int D, int G>
__device__ __forceinline__ void splat_query_range(
    float* acc, int64_t cell_stride, const CellGeom<D>& g, int n0, int n1,
    int n, int cg, const float (&pt)[D], const SamplerParams& p,
    const float (&gv)[kRows<D>][G]) {
  for (int ni = n0; ni < n1; ++ni) {
    float* cell = acc + (ni - n0) * cell_stride;
    for_each_corner<D>(g, pt, ni, n, p,
                       [&](int idx, const float (&wr)[kRows<D>]) {
#pragma unroll
                         for (int j = 0; j < G; ++j) {
                           if (j < cg) {
                             float v = 0.0f;
#pragma unroll
                             for (int r = 0; r < kRows<D>; ++r)
                               v = fmaf(wr[r], gv[r][j], v);
                             atomicAdd(cell + j * g.texels + idx, v);
                           }
                         }
                       });
  }
}

// Calls f(std::integral_constant<int, C>) for the runtime channel count c.
template <typename F>
cudaError_t dispatch_channels(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

namespace fused {

constexpr int kBlendThreads = 128;
// 256 threads while four chunks share an SM; 512 for a chunk that takes
// the SM's whole shared memory (the 64 KiB 3D cell), or too few warps
// would wait on the shared-memory atomics.
constexpr int kBwdThreadsSmall = 256;
constexpr int kBwdThreadsLarge = 512;

// One thread per query: its 1 + 2D rows over all n cells, in registers.
template <int D, int C>
__global__ void __launch_bounds__(kBlendThreads)
    blend_kernel(const float* __restrict__ cells,
                 const float* __restrict__ points, float* __restrict__ out,
                 int n, CellGeom<D> g, int q, SamplerParams p) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  float pt[D];
#pragma unroll
  for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
  float acc[kRows<D>][C];
  blend_query<D, C>(cells, g, n, pt, p, acc);
#pragma unroll
  for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[static_cast<int64_t>(r * C + c) * q + qi] = acc[r][c];
}

// Block (bx, by) accumulates queries [bx * q_per_block, ...) into cells
// [by * cells_per_chunk, ...).  SMEM: in shared memory, flushed once at the
// end; otherwise straight into dcells.  dcells must be zeroed.
template <int D, int C, bool SMEM>
__global__ void __launch_bounds__(kBwdThreadsLarge)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ points,
               float* __restrict__ dcells, int n, CellGeom<D> geom, int q,
               int cells_per_chunk, int q_per_block, SamplerParams p) {
  extern __shared__ float sacc[];
  const int cell_elems = C * geom.texels;
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  const int chunk_elems = (n1 - n0) * cell_elems;
  float* chunk_out = dcells + static_cast<int64_t>(n0) * cell_elems;
  float* acc = SMEM ? sacc : chunk_out;
  if (SMEM) {
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
    __syncthreads();
  }

  const int q0 = blockIdx.x * q_per_block;
  const int q1 = min(q, q0 + q_per_block);
  for (int qi = q0 + threadIdx.x; qi < q1; qi += blockDim.x) {
    float gv[kRows<D>][C];
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        gv[r][c] = __ldg(g + static_cast<int64_t>(r * C + c) * q + qi);
    float pt[D];
#pragma unroll
    for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
    splat_query<D, C>(acc, geom, n0, n1, n, pt, p, gv);
  }

  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
      const float v = sacc[e];
      if (v != 0.0f) atomicAdd(chunk_out + e, v);
    }
  }
}

template <int D, int C>
cudaError_t launch_blend(const float* cells, const float* points, float* out,
                         int n, const CellGeom<D>& g, int q,
                         const SamplerParams& p, cudaStream_t stream) {
  if (q == 0) return cudaGetLastError();
  blend_kernel<D, C><<<cdiv(q, kBlendThreads), kBlendThreads, 0, stream>>>(
      cells, points, out, n, g, q, p);
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch_bwd(const float* g, const float* points, float* dcells,
                       int n, const CellGeom<D>& geom, int q,
                       const SamplerParams& p, cudaStream_t stream) {
  if (q == 0 || n == 0 || geom.texels == 0) return cudaGetLastError();
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;

  // up to 48 KB of cells per block, or as many cells of a larger size as
  // the opted-in limit holds; a cell above that takes global atomics
  const int64_t cell_bytes = static_cast<int64_t>(C) * geom.texels * 4;
  const bool smem = cell_bytes <= lim.smem_optin;
  const int64_t budget =
      cell_bytes <= kStaticSmemBytes ? kStaticSmemBytes : lim.smem_optin;
  const int cells_per_chunk =
      smem ? static_cast<int>(std::min<int64_t>(n, budget / cell_bytes)) : n;
  const int chunks = cdiv(n, cells_per_chunk);
  const size_t bytes = smem ? static_cast<size_t>(cells_per_chunk) * cell_bytes
                            : 0;
  const int threads =
      bytes > static_cast<size_t>(kStaticSmemBytes) ? kBwdThreadsLarge
                                                    : kBwdThreadsSmall;
  // as many blocks as fit on the card at once, at most 4 per SM, but no
  // block with fewer queries than threads
  const int per_sm =
      smem ? std::max(1, std::min<int>(4, lim.smem_per_sm /
                                              static_cast<int>(bytes + 1024)))
           : 4;
  const int q_blocks = std::max(
      1, std::min(cdiv(per_sm * lim.sms, chunks), cdiv(q, threads)));
  const int q_per_block = cdiv(q, q_blocks);
  const dim3 grid(cdiv(q, q_per_block), chunks);
  if (smem) {
    auto* kernel = &bwd_kernel<D, C, true>;
    err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, bytes, stream>>>(g, points, dcells, n, geom, q,
                                             cells_per_chunk, q_per_block, p);
  } else {
    bwd_kernel<D, C, false><<<grid, threads, 0, stream>>>(
        g, points, dcells, n, geom, q, cells_per_chunk, q_per_block, p);
  }
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace csm
