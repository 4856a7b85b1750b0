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
// * Blocks: (table block, channel group).  The rows go back to query
//   order through perm.
// * bwd: each corner adds to the cells with global f32 atomics (not
//   deterministic).
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"

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

// dcells must be zeroed.
__global__ void __launch_bounds__(kQBlock)
    bwd_kernel(const float* __restrict__ g, const float* __restrict__ points,
               const int* __restrict__ perm, const int* __restrict__ table,
               float* __restrict__ dcells, int n, int c, int cw,
               CellGeom<3> geom, int q, SamplerParams p) {
  constexpr int R = csm::kRows<3>;
  const Block b = block_of(table);
  if (static_cast<int>(threadIdx.x) >= b.count) return;
  const int c0 = blockIdx.y * cw;
  const int cg = min(cw, c - c0);
  const int qi = perm[b.first + threadIdx.x];
  float gv[R][kGroupChannels];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kGroupChannels; ++j)
      gv[r][j] = j < cg
                     ? __ldg(g + static_cast<int64_t>(r * c + c0 + j) * q + qi)
                     : 0.0f;
  const float pt[3] = {points[3 * qi], points[3 * qi + 1],
                       points[3 * qi + 2]};
  for (int ni = 0; ni < n; ++ni) {
    float* cell = dcells + (static_cast<int64_t>(ni) * c + c0) * geom.texels;
    csm::for_each_corner<3>(
        geom, pt, ni, n, p, [&](int idx, const float (&wr)[R]) {
#pragma unroll
          for (int j = 0; j < kGroupChannels; ++j) {
            if (j < cg) {
              float v = 0.0f;
#pragma unroll
              for (int r = 0; r < R; ++r) v = fmaf(wr[r], gv[r][j], v);
              atomicAdd(cell + idx + j * geom.texels, v);
            }
          }
        });
  }
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

// dcells (N, C, D, H, W) must be zeroed.
int fused3s_bwd(const void* g, const void* points, const void* perm,
                const void* table, void* dcells, int n, int c, int d, int h,
                int w, int q, int nb, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  if (q == 0 || n == 0 || c == 0 || nb == 0 || d * h * w == 0)
    return cudaGetLastError();
  const SamplerParams p = csm::make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
  const int cw = csm::group_width(c);
  const dim3 grid(nb, csm::channel_groups(c));
  bwd_kernel<<<grid, kQBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<const int*>(perm), static_cast<const int*>(table),
      static_cast<float*>(dcells), n, c, cw, csm::cell_geom3(d, h, w), q, p);
  return cudaGetLastError();
}

}  // extern "C"
