// Binned per-cell blend_o / splat_o for 3D volumes too large to stay on
// chip, for NVIDIA Hopper (sm_90a).
//
// percell_blend replaces the TPU kernel
//   ops/pallas/percell.py::_blend_pc_kernel of the JAX package
// percell_splat replaces
//   ops/pallas/percell.py::_splat_pc_kernel
//
// Contract (the blend_o / splat_o contract of csrc/blend_splat.cu, 3D):
//   input (N, C, D, H, W) f32, grid (G, Q, 3) f32 with G = N or G = 1 (a
//   cloud shared by all cells), per-axis derivative orders, and the pair
//   plan's perm (N * Q,) int32: the pair index n * Q + q of each slot,
//   sorted by (cell, z row) (ops/cuda/percell.py make_plan).
//   The sort keys each pair by its cell first, so the slots of cell n are
//   n * Q to n * Q + Q - 1.
//   percell_blend: -> out (N, C, Q) f32 in each cell's slot order: the
//                  pair of slot n * Q + j at out[n, :, j].  The wrapper
//                  gathers it back to query order (one pass over a 26 MB
//                  output at the nested 128^3 volume); the values equal
//                  blend_o's for the same pairs bit for bit.
//   percell_blend_query_order: the same values written straight to query
//                  order, out[n, :, q]: the other output order, slower
//                  (scattered stores; PERF.md section 6), kept to time
//                  against the first (chip_smoke.py).
//   percell_splat: gout (N, C, Q) f32 -> out (N, C, D, H, W) f32, the
//                  transpose; out must be zeroed.
//
// What bounds them on the H100, and the design:
// * A 4-channel 128^3 cell is 33.5 MB, and the 16 cells of the nested 3D
//   trainer 537 MB, ten times the 50 MB L2.  blend_o / splat_o take the
//   pairs in (cell, query) order, so a warp's gathers and atomics land
//   anywhere in a cell (and splat_o's global-atomics branch walks all N
//   cells for each query).  Here the plan sorts the pairs by cell and z
//   slab, so the 32 pairs of a warp read and add into one (cell, z window)
//   of a few hundred KB, and consecutive blocks walk the volume slab by
//   slab: the traffic stays in L2 and each sector comes from device
//   memory about once.
// * One thread per plan slot, the per-pair corner walk of
//   csrc/pair_corners.cuh.  The blend writes its C channels in slot order
//   (coalesced stores); the splat adds each corner's C values with global
//   atomics, which the sort makes L2-local.  No shared-memory window is built: a 4-channel z row of a
//   128^2 cell is 256 KB, over a block's 227 KB, and a per-block
//   accumulator would still flush most of its atomics (fused3b's finding,
//   scripts/count_brick_flush.py).
// * The TPU kernels' window DMA chain, z front pad, sublane-multiple
//   window rows and one-hot MXU contractions exist for VMEM and are not
//   carried over; the sort is.
// * f32 atomics: the splat is not deterministic.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "pair_corners.cuh"

namespace {

constexpr int kThreads = 256;

// kQueryOrder: write out[n, :, q] instead of out[n, :, j] for slot n*Q + j
template <bool kQueryOrder>
__global__ void __launch_bounds__(kThreads)
    percell_blend_kernel(const float* __restrict__ input,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         float* __restrict__ out, csm::PairShape s,
                         csm::SamplerParams p) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= s.n * s.q) return;
  const int pair = __ldg(perm + slot);
  const int ni = pair / s.q;
  const int qi = pair - ni * s.q;
  int off[8];
  float wgt[8];
  csm::pair_corners<3>(s, grid, ni, qi, p, off, wgt);
  const float* cell = input + static_cast<int64_t>(ni) * s.c * s.texels;
  float* dst = out + static_cast<int64_t>(ni) * s.c * s.q +
               (kQueryOrder ? qi : slot - ni * s.q);
  for (int c = 0; c < s.c; ++c) {
    const float* src = cell + static_cast<int64_t>(c) * s.texels;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(wgt[k], __ldg(src + off[k]), acc);
    dst[static_cast<int64_t>(c) * s.q] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    percell_splat_kernel(const float* __restrict__ gout,
                         const float* __restrict__ grid,
                         const int* __restrict__ perm,
                         float* __restrict__ out, csm::PairShape s,
                         csm::SamplerParams p) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= s.n * s.q) return;
  const int pair = __ldg(perm + slot);
  const int ni = pair / s.q;
  const int qi = pair - ni * s.q;
  int off[8];
  float wgt[8];
  csm::pair_corners<3>(s, grid, ni, qi, p, off, wgt);
  const float* g = gout + static_cast<int64_t>(ni) * s.c * s.q + qi;
  float* cell = out + static_cast<int64_t>(ni) * s.c * s.texels;
  for (int c = 0; c < s.c; ++c) {
    const float gv = __ldg(g + static_cast<int64_t>(c) * s.q);
    float* dst = cell + static_cast<int64_t>(c) * s.texels;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (wgt[k] != 0.0f) atomicAdd(dst + off[k], wgt[k] * gv);
  }
}

template <typename K>
int launch(K kernel, const void* src, const void* grid, const void* perm,
           void* out, int dim, int n, int c, int d, int h, int w, int q,
           int grid_batch, int ox, int oy, int oz, int kernel_id,
           int padding, int align, int multicell, int strict,
           float off_step, float off_stop, void* stream) {
  if (dim != 3 || csm::bad_pair_args(3, grid_batch, n, ox, oy, oz))
    return cudaErrorInvalidValue;
  const csm::PairShape s =
      csm::make_pair_shape(3, n, c, d, h, w, q, grid_batch, ox, oy, oz);
  const csm::SamplerParams p = csm::make_params(
      kernel_id, padding, align, multicell, strict, off_step, off_stop);
  const int pairs = n * q;
  if (pairs == 0 || c == 0) return cudaGetLastError();
  kernel<<<csm::cdiv(pairs, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(grid),
      static_cast<const int*>(perm), static_cast<float*>(out), s, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dim must be 3; orders (ox, oy, oz) per grid axis; out (N, C, Q) in each
// cell's slot order.
int percell_blend(const void* input, const void* grid, const void* perm,
                  void* out, int dim, int n, int c, int d, int h, int w, int q,
                  int grid_batch, int ox, int oy, int oz, int kernel,
                  int padding, int align, int multicell, int strict,
                  float off_step, float off_stop, void* stream) {
  return launch(percell_blend_kernel<false>, input, grid, perm, out, dim, n,
                c, d, h, w, q, grid_batch, ox, oy, oz, kernel, padding, align,
                multicell, strict, off_step, off_stop, stream);
}

// out (N, C, Q) in query order.
int percell_blend_query_order(const void* input, const void* grid,
                              const void* perm, void* out, int dim, int n,
                              int c, int d, int h, int w, int q,
                              int grid_batch, int ox, int oy, int oz,
                              int kernel, int padding, int align,
                              int multicell, int strict, float off_step,
                              float off_stop, void* stream) {
  return launch(percell_blend_kernel<true>, input, grid, perm, out, dim, n, c,
                d, h, w, q, grid_batch, ox, oy, oz, kernel, padding, align,
                multicell, strict, off_step, off_stop, stream);
}

// out (N, C, D, H, W) must be zeroed.
int percell_splat(const void* gout, const void* grid, const void* perm,
                  void* out, int dim, int n, int c, int d, int h, int w, int q,
                  int grid_batch, int ox, int oy, int oz, int kernel,
                  int padding, int align, int multicell, int strict,
                  float off_step, float off_stop, void* stream) {
  return launch(percell_splat_kernel, gout, grid, perm, out, dim, n, c, d, h,
                w, q, grid_batch, ox, oy, oz, kernel, padding, align, multicell,
                strict, off_step, off_stop, stream);
}

}  // extern "C"
