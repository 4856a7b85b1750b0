// The fused rows of one query, in 2D and 3D, and the kernels built from
// them: fused2w's and fused3w's blends (value, jacobian, diagonal
// Hessian, summed over the multicell ensemble), shared with the mega2w
// train-step kernel, whose splat adds their transpose (splat_query,
// splat_query_range).  The corner walk serves every fused kernel.
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

// The most channels whose rows a fused or mega2w thread keeps in
// registers at once: a stack of more channels is walked in groups of at
// most this many (fused::dispatch_groups).
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

// The per-axis floors and weights of the query at pt in cell ni.
template <int D>
__device__ __forceinline__ void corner_tables(const CellGeom<D>& g,
                                              const float (&pt)[D], int ni,
                                              int n, const SamplerParams& p,
                                              AxisTable (&a)[D]) {
  const float off = cell_offset(ni, n, p);
#pragma unroll
  for (int i = 0; i < D; ++i) a[i] = axis_table(pt[i], g.size[i], off, p);
}

// Calls f(ci, flat texel index, wr) for every in-bounds corner of the
// tables a (corner_tables), ci[i] being the corner's index on grid axis i
// and wr[r] its weight in row r.  Corners run with axis 0 fastest; a
// corner out of bounds (zeros padding) is dropped.
template <int D, typename F>
__device__ __forceinline__ void for_each_table_corner(const CellGeom<D>& g,
                                                      const AxisTable (&a)[D],
                                                      F&& f) {
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    int idx = 0, stride = 1;
    int ci[D];
    bool ok = true;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      ci[i] = a[i].i0 + ((k >> i) & 1);
      ok = ok && ci[i] >= 0 && ci[i] < g.size[i];
      idx += ci[i] * stride;
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
    f(ci, idx, wr);
  }
}

// Calls f(ci, flat texel index, wr) for every in-bounds corner of the
// query at pt in cell ni (for_each_table_corner of its corner_tables).
template <int D, typename F>
__device__ __forceinline__ void for_each_corner_axes(const CellGeom<D>& g,
                                                     const float (&pt)[D],
                                                     int ni, int n,
                                                     const SamplerParams& p,
                                                     F&& f) {
  AxisTable a[D];
  corner_tables<D>(g, pt, ni, n, p, a);
  for_each_table_corner<D>(g, a, f);
}

// for_each_corner_axes calling f(flat texel index, wr).
template <int D, typename F>
__device__ __forceinline__ void for_each_corner(const CellGeom<D>& g,
                                                const float (&pt)[D], int ni,
                                                int n, const SamplerParams& p,
                                                F&& f) {
  for_each_corner_axes<D>(
      g, pt, ni, n, p,
      [&](const int (&)[D], int idx, const float (&wr)[kRows<D>]) {
        f(idx, wr);
      });
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

// The channel-looped kernels of csrc/staged_cells.cuh (fused2d, fused3d)
// take any channel count: grid axis z walks groups of at most kGroupChannels
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

// Channels: up to kMaxChannels a blend thread keeps all C channels' rows
// in registers (ONE: the whole stack is one group, C == G, as
// compile-time constants).  Above it a grid axis walks channel groups of
// at most kBlendGroup channels (C = 12: two of 6; C = 16: two of 8),
// each redoing the per-(query, cell) coordinate math.  mega2w's wide
// splat (csrc/mega2w.cu) adds into shared chunks in groups of at most
// kBwdGroup (C = 16: four of 4), whose cotangent registers and chunks
// are half as wide.  fused2w's and fused3w's bwds are
// csrc/texel_scatter.cuh's scatter (fused_scatter_bwd), not this file's.
constexpr int kBlendGroup = kMaxChannels;
constexpr int kBwdGroup = 4;

// One thread per query: its 1 + 2D rows over all n cells, in registers,
// for channels [by * G, by * G + cg) of c.
template <int D, int G, bool ONE>
__global__ void __launch_bounds__(kBlendThreads)
    blend_kernel(const float* __restrict__ cells,
                 const float* __restrict__ points, float* __restrict__ out,
                 int n, int c, CellGeom<D> g, int q, SamplerParams p) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  float pt[D];
#pragma unroll
  for (int i = 0; i < D; ++i) pt[i] = points[D * qi + i];
  float acc[kRows<D>][G];
  if constexpr (ONE) {
    blend_query<D, G>(cells, g, n, pt, p, acc);
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j)
        out[static_cast<int64_t>(r * G + j) * q + qi] = acc[r][j];
  } else {
    const int c0 = blockIdx.y * G;
    const int cg = min(G, c - c0);
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j) acc[r][j] = 0.0f;
    blend_query_range<D, G>(cells + static_cast<int64_t>(c0) * g.texels,
                            static_cast<int64_t>(c) * g.texels, g, 0, n, n,
                            cg, pt, p, acc);
#pragma unroll
    for (int r = 0; r < kRows<D>; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < cg)
          out[static_cast<int64_t>(r * c + c0 + j) * q + qi] = acc[r][j];
  }
}

template <int D, int G, bool ONE>
cudaError_t launch_blend(const float* cells, const float* points, float* out,
                         int n, int c, const CellGeom<D>& g, int q,
                         const SamplerParams& p, cudaStream_t stream) {
  if (q == 0) return cudaGetLastError();
  const dim3 grid(cdiv(q, kBlendThreads),
                  ONE ? 1 : channel_groups(c, kBlendGroup));
  blend_kernel<D, G, ONE><<<grid, kBlendThreads, 0, stream>>>(
      cells, points, out, n, c, g, q, p);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, G>, std::bool_constant<ONE>)
// for the blend of c channels: c <= kMaxChannels as one group (G = c,
// ONE), more as groups of group_width(c, kBlendGroup), which is over
// kBlendGroup / 2 for c > kBlendGroup.
template <typename F>
cudaError_t dispatch_groups(int c, F&& launch) {
  if (c <= kMaxChannels) {
    return dispatch_channels(c, [&](auto cc) {
      return launch(cc, std::true_type{});
    });
  }
  return dispatch_channels(
      group_width(c, kBlendGroup), [&](auto gw) -> cudaError_t {
        constexpr int G = decltype(gw)::value;
        if constexpr (G > kBlendGroup / 2 && G <= kBlendGroup)
          return launch(gw, std::false_type{});
        else
          return cudaErrorInvalidValue;
      });
}

}  // namespace fused
}  // namespace csm
