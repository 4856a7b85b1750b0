// Bricked 3D fused blend and its transpose over the kernel-layout volume,
// for NVIDIA Hopper (sm_90a).
//
// fused3b_blend replaces the TPU kernel
//   ops/pallas/fused3b.py::_fused3b_blend_kernel of the JAX package
// fused3b_bwd replaces
//   ops/pallas/fused3b.py::_fused3b_bwd_kernel of the JAX package
//
// Contract (the JAX package's pallas_fused3b_blend_vol / _bwd_vol):
//   vol    (D, H, W, N, C) f32: the cells (N, C, D, H, W) permuted
//          (ops/cuda/fused3b.py cells_to_vol), no pad slots;
//   pts_p  (QP, 3) f32, occ (QP,) f32, hasv (QP / 128,) int32: the brick
//          plan's slot-ordered points, real-slot mask and per-block flag.
//   blend: -> out (7, C, QP) f32 in slot order, rows value, d/dx, d/dy,
//          d/dz, d2/dx2, d2/dy2, d2/dz2 summed over the N cells; zeros in
//          slots with occ == 0.
//   bwd:   g (7, C, QP) f32 -> dvol (D, H, W, N, C), the transpose; slots
//          with occ == 0 add nothing.  dvol must be zeroed.
// All three padding modes and interpolants, multicell on and off, both
// align_corners, any C; a corner out of bounds reads zero and is never
// written.
//
// What bounds them on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * At BASELINE config 5 (16 x 4 x 128^3, 1M points) the f32 volume is
//   537 MB, ten times the 50 MB L2.  Queries in API order gather from and
//   add into all of it at random; the brick plan sorts them so that the
//   128 slots of one block share one (z slab, y group) brick and
//   consecutive blocks walk the volume slab by slab.  The sort is the
//   only part of the TPU kernels carried over: their one-hot MXU
//   contractions, 128-lane W padding, super-brick DMA chain and
//   serialized read-modify-write grid exist because the TPU has no gather
//   and no atomics.
// * The layout keeps one texel's N * C values together, so a query reads
//   a cell's C channels at a corner as one 16-byte load at C = 4 (and adds
//   them back with one vector atomic in the bwd).
// * Channels: grid axis y walks channel groups of at most 8
//   (fused_rows.cuh channel_groups / group_width, as csrc/fused.cu), whose
//   rows a thread keeps in registers; one group, the whole stack, up to 8
//   channels.  A group of a multiple of 4 channels in a stack of a
//   multiple of 4 starts 16-byte aligned and keeps the vector loads and
//   atomics (C = 16: two groups of 8).
// * blend: one CUDA block per plan block, one thread per slot, looping
//   over the N cells with the per-query corner walk of fused_rows.cuh in
//   its FMA order (the slot's rows equal fused3w_blend's for the same
//   point).  1M x 16 x 8 corners x 4 ch x 7 rows FMAs: bound by
//   operations near 0.1 ms; the volume read once is 0.16 ms.
// * bwd: the same walk, each corner's C sums added to global memory with
//   one float4 atomicAdd (sm_90) at C % 4 == 0, scalar atomics otherwise.
//   A shared-memory brick accumulator saves few of them here: a bin is
//   one z slab thick while its window spans three, and at 3.8
//   contributions per (cell, texel) a block's flush of the entries it
//   touched would still be 64% of the direct atomics (a z slab's, 50%;
//   scripts/count_brick_flush.py), after as many shared-memory atomics
//   and a zeroed 3 x 4 x W x N window per block.  f32 atomics: not
//   deterministic.
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"

namespace {

// the plan's q_block: one CUDA block of this many threads per plan block
constexpr int kQBlock = 128;

// v[k] = src[k], k < cg (cg <= G); 16-byte loads when the group is
// full and G and the stack's channel count are multiples of 4 (the offset
// (texel * N + cell) * C + c0 is then 16-byte aligned).
template <int G>
__device__ __forceinline__ void load_channels(const float* __restrict__ src,
                                              bool vec, int cg,
                                              float (&v)[G]) {
  if constexpr (G % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < G; k += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + k));
        v[k] = q.x;
        v[k + 1] = q.y;
        v[k + 2] = q.z;
        v[k + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) v[k] = k < cg ? __ldg(src + k) : 0.0f;
}

// dst[k] += v[k], k < cg, atomically; vector atomics where load_channels
// loads vectors.
template <int G>
__device__ __forceinline__ void add_channels(float* dst, bool vec, int cg,
                                             const float (&v)[G]) {
  if constexpr (G % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < G; k += 4)
        atomicAdd(reinterpret_cast<float4*>(dst + k),
                  make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k)
    if (k < cg) atomicAdd(dst + k, v[k]);
}

// Block (bx, by): plan block bx, channels [by * G, by * G + cg) of c.
// ONE: c == G, one group (C <= 8), whose channel count, width and vector
// loads are compile-time constants.
template <int G, bool ONE>
__global__ void __launch_bounds__(kQBlock)
    blend_kernel(const float* __restrict__ vol, const float* __restrict__ pts,
                 const float* __restrict__ occ, const int* __restrict__ hasv,
                 float* __restrict__ out, int n, int c, csm::CellGeom<3> g,
                 int qp, csm::SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  const int slot = blockIdx.x * kQBlock + threadIdx.x;
  const int cs = ONE ? G : c;
  const int c0 = ONE ? 0 : blockIdx.y * G;
  const int cg = ONE ? G : min(G, c - c0);
  const bool vec = ONE ? G % 4 == 0 : cg == G && c % 4 == 0;
  float acc[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[r][j] = 0.0f;
  if (hasv[blockIdx.x] != 0 && occ[slot] != 0.0f) {
    const float pt[3] = {pts[3 * slot], pts[3 * slot + 1], pts[3 * slot + 2]};
    for (int ni = 0; ni < n; ++ni) {
      csm::for_each_corner<3>(
          g, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
            float v[G];
            load_channels<G>(
                vol + (static_cast<int64_t>(idx) * n + ni) * cs + c0, vec, cg,
                v);
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
              for (int r = 0; r < R; ++r)
                acc[r][j] = fmaf(wr[r], v[j], acc[r][j]);
          });
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < cg)
        out[static_cast<int64_t>(r * cs + c0 + j) * qp + slot] = acc[r][j];
}

template <int G, bool ONE>
__global__ void __launch_bounds__(kQBlock)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ pts,
               const float* __restrict__ occ, const int* __restrict__ hasv,
               float* __restrict__ dvol, int n, int c, csm::CellGeom<3> geom,
               int qp, csm::SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  const int slot = blockIdx.x * kQBlock + threadIdx.x;
  if (hasv[blockIdx.x] == 0 || occ[slot] == 0.0f) return;
  const int cs = ONE ? G : c;
  const int c0 = ONE ? 0 : blockIdx.y * G;
  const int cg = ONE ? G : min(G, c - c0);
  const bool vec = ONE ? G % 4 == 0 : cg == G && c % 4 == 0;
  float gv[R][G];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j)
      gv[r][j] =
          j < cg ? __ldg(g + static_cast<int64_t>(r * cs + c0 + j) * qp + slot)
                 : 0.0f;
  const float pt[3] = {pts[3 * slot], pts[3 * slot + 1], pts[3 * slot + 2]};
  for (int ni = 0; ni < n; ++ni) {
    csm::for_each_corner<3>(
        geom, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
          float v[G];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int r = 0; r < R; ++r) s = fmaf(wr[r], gv[r][j], s);
            v[j] = s;
          }
          add_channels<G>(
              dvol + (static_cast<int64_t>(idx) * n + ni) * cs + c0, vec, cg,
              v);
        });
  }
}

}  // namespace

extern "C" {

int fused3b_blend(const void* vol, const void* pts, const void* occ,
                  const void* hasv, void* out, int n, int c, int d, int h,
                  int w, int qp, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (qp == 0 || c == 0) return cudaGetLastError();
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const dim3 grid(qp / kQBlock, csm::channel_groups(c));
  return csm::dispatch_channels(csm::group_width(c), [&](auto gw) {
    constexpr int G = decltype(gw)::value;
    auto* kernel_fn = c == G ? &blend_kernel<G, true>
                             : &blend_kernel<G, false>;
    kernel_fn<<<grid, kQBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vol), static_cast<const float*>(pts),
        static_cast<const float*>(occ), static_cast<const int*>(hasv),
        static_cast<float*>(out), n, c, csm::cell_geom3(d, h, w), qp, p);
    return cudaGetLastError();
  });
}

// dvol (D, H, W, N, C) must be zeroed.
int fused3b_bwd(const void* g, const void* pts, const void* occ,
                const void* hasv, void* dvol, int n, int c, int d, int h,
                int w, int qp, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  if (qp % kQBlock != 0) return cudaErrorInvalidValue;
  if (qp == 0 || n == 0 || c == 0) return cudaGetLastError();
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  const dim3 grid(qp / kQBlock, csm::channel_groups(c));
  return csm::dispatch_channels(csm::group_width(c), [&](auto gw) {
    constexpr int G = decltype(gw)::value;
    auto* kernel_fn = c == G ? &bwd_kernel<G, true>
                             : &bwd_kernel<G, false>;
    kernel_fn<<<grid, kQBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(g), static_cast<const float*>(pts),
        static_cast<const float*>(occ), static_cast<const int*>(hasv),
        static_cast<float*>(dvol), n, c, csm::cell_geom3(d, h, w), qp, p);
    return cudaGetLastError();
  });
}

}  // extern "C"
