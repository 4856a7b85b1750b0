// The corner walk of one (cell, query) pair at per-axis derivative orders,
// shared by the blend_o/splat_o, percell and slab kernels.
//
// Grid axis i addresses spatial axis d-1-i (x -> W, y -> H, z -> D); the
// weights are ops/generic.py's, built from csrc/sampler_math.cuh, so every
// kernel over this walk gives blend_o's numbers for the same pair.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "sampler_math.cuh"

namespace csm {

struct PairShape {
  int n, c, q;
  int grid_batch;  // 1 (shared queries) or n
  int size[3];     // per grid axis: W, H, D
  int stride[3];   // flat texel stride per grid axis: 1, W, H*W
  int order[3];
  int texels;      // prod(S)
};

// d is ignored for dim == 2.
inline PairShape make_pair_shape(int dim, int n, int c, int d, int h, int w,
                                 int q, int grid_batch, int ox, int oy,
                                 int oz) {
  PairShape s;
  s.n = n;
  s.c = c;
  s.q = q;
  s.grid_batch = grid_batch;
  s.size[0] = w;
  s.size[1] = h;
  s.size[2] = dim == 3 ? d : 1;
  s.stride[0] = 1;
  s.stride[1] = w;
  s.stride[2] = h * w;
  s.order[0] = ox;
  s.order[1] = oy;
  s.order[2] = dim == 3 ? oz : 0;
  s.texels = h * w * (dim == 3 ? d : 1);
  return s;
}

inline bool bad_pair_args(int dim, int grid_batch, int n, int ox, int oy,
                          int oz) {
  return (dim != 2 && dim != 3) || (grid_batch != 1 && grid_batch != n) ||
         ox < 0 || oy < 0 || oz < 0;
}

// The grid coordinates of query qi as cell ni sees them.
template <int D>
__device__ __forceinline__ const float* pair_coords(const PairShape& s,
                                                    const float* grid, int ni,
                                                    int qi) {
  return grid +
         (static_cast<int64_t>(s.grid_batch == 1 ? 0 : ni) * s.q + qi) * D;
}

// The per-axis floor corners and weights of one (cell, query) pair.
template <int D>
__device__ __forceinline__ void pair_axes(const PairShape& s,
                                          const float* grid, int ni, int qi,
                                          const SamplerParams& p,
                                          AxisWeights a[D]) {
  const float offset = cell_offset(ni, s.n, p);
  const float* g = pair_coords<D>(s, grid, ni, qi);
#pragma unroll
  for (int i = 0; i < D; ++i)
    a[i] = axis_weights(g[i], s.size[i], offset, s.order[i], p);
}

// Whether corner k takes axis i's ceil corner: corner bit D-1-i, the
// itertools.product order.
template <int D>
__device__ __forceinline__ int corner_up(int k, int i) {
  return (k >> (D - 1 - i)) & 1;
}

// The weight of corner k: the axes' weights multiplied in axis order.
template <int D>
__device__ __forceinline__ float corner_weight(const AxisWeights a[D],
                                               int k) {
  float w = 1.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float wi = corner_up<D>(k, i) ? a[i].w1 : a[i].w0;
    w = i == 0 ? wi : w * wi;
  }
  return w;
}

// Corner offsets (flat texel index) and weights of one (cell, query) pair;
// an out-of-bounds corner gets weight 0 and offset 0.
template <int D>
__device__ __forceinline__ void pair_corners(const PairShape& s,
                                             const float* grid, int ni,
                                             int qi, const SamplerParams& p,
                                             int off[1 << D],
                                             float wgt[1 << D]) {
  AxisWeights a[D];
  pair_axes<D>(s, grid, ni, qi, p, a);
#pragma unroll
  for (int k = 0; k < (1 << D); ++k) {
    int idx = 0;
    bool ok = true;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int ci = a[i].i0 + corner_up<D>(k, i);
      ok = ok && ci >= 0 && ci < s.size[i];
      idx += ci * s.stride[i];
    }
    off[k] = ok ? idx : 0;
    wgt[k] = ok ? corner_weight<D>(a, k) : 0.0f;
  }
}

// The floor corner of grid axis `axis` for one pair, clamped to
// [-2, size + 1] as axis_weights clamps it: the same integer, without the
// interpolant's weights.
template <int D>
__device__ __forceinline__ int pair_floor(const PairShape& s,
                                          const float* grid, int ni, int qi,
                                          int axis, const SamplerParams& p) {
  const float offset = cell_offset(ni, s.n, p);
  float mult;
  const float x = source_coord(pair_coords<D>(s, grid, ni, qi)[axis],
                               s.size[axis], offset, p, &mult);
  return static_cast<int>(
      fminf(fmaxf(floorf(x), -2.0f), s.size[axis] + 1.0f));
}

}  // namespace csm
