// Fused 2D multicell sampling with first and pure second derivatives, and
// its transpose to the cells, for NVIDIA Hopper (sm_90a).
//
// fused2w_blend replaces the TPU kernel
//   ops/pallas/fused2w.py::_fused2w_blend_kernel of the JAX package
// fused2w_bwd replaces
//   ops/pallas/fused2w.py::_fused2w_bwd_kernel of the JAX package
// (with its host-side overlap-add _scatter_windows2, which has no
// counterpart here).
//
// Contract (the JAX package's fused op, generic.blend per row, summed over
// the N cells):
//   blend: cells (N, C, H, W) f32, points (Q, 2) f32 in [-1, 1] shared by
//          all cells -> out (5, C, Q) f32, rows value, d/dx, d/dy, d2/dx2,
//          d2/dy2 with respect to the normalized coordinates.
//   bwd:   g (5, C, Q) f32 -> dcells (N, C, H, W) f32, the exact transpose.
// All three padding modes, all three interpolants, multicell on and off,
// both align_corners; the strict-reference reflection span.
//
// What bounds them on the H100, and the design:
// * The TPU kernels bin queries by y row, cut per-bin windows of the grid
//   and gather through one-hot MXU contractions, because the TPU has no
//   per-lane gather and no atomics.  Hopper has both, so none of that
//   survives: no binning, no windows, no slot layout.
// * blend: one thread per query loops over the N cells and keeps the 5*C
//   sums in registers; it reads 4 corners x C channels per cell straight
//   from global memory.  The f32 cell stack of the main path (96 x 4 x
//   16 x 16, 393 KB) exceeds a block's 227 KB of shared memory but sits in
//   the 50 MB L2, and the threads of a warp walk the cells in lockstep, so
//   the gathers of one step fall in one 4 KB cell.  It is bound by those
//   L1/L2 gathers and the per-(query, cell) coordinate math (two sincospif),
//   not by DRAM bytes (it writes 5*C*Q floats once).
// * bwd: the naive form, one global atomicAdd per (query, cell, corner,
//   channel), is 100k * 96 * 4 * 4 = 154 M float atomics onto 98 k
//   addresses: contention-bound.  Here each block owns a chunk of cells
//   whose cotangent fits in 48 KB of shared memory, accumulates one slice
//   of the queries into it with shared-memory atomics, and flushes the
//   chunk once with global atomicAdd.  Grids whose single cell does not fit
//   fall back to global atomics directly.
// * The TPU backward was deterministic (a sequential read-modify-write
//   chain).  This one is not: f32 atomics add in an order that changes from
//   run to run, so results agree with the plain version to rounding, not
//   bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sampler_math.cuh"

namespace {

constexpr int kBlendThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kBwdSmemBytes = 48 * 1024;  // no opt-in attribute needed

template <int C>
__global__ void __launch_bounds__(kBlendThreads)
    fused2w_blend_kernel(const float* __restrict__ cells,
                         const float* __restrict__ points,
                         float* __restrict__ out, int n, int h, int w, int q,
                         csm::SamplerParams p) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  const float px = points[2 * qi];
  const float py = points[2 * qi + 1];
  const int hw = h * w;
  float acc[5][C];
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

  for (int ni = 0; ni < n; ++ni) {
    const float off = csm::cell_offset(ni, n, p);
    // grid axis 0 (x) addresses W, axis 1 (y) addresses H
    const csm::AxisTable ax = csm::axis_table(px, w, off, p);
    const csm::AxisTable ay = csm::axis_table(py, h, off, p);
    const float* cell = cells + static_cast<int64_t>(ni) * C * hw;
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      const int iy = ay.i0 + cy;
      if (iy < 0 || iy >= h) continue;  // zeros padding drops the corner
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int ix = ax.i0 + cx;
        if (ix < 0 || ix >= w) continue;
        float wr[5];
        csm::row_weights(ax, ay, cx, cy, wr);
        const float* src = cell + iy * w + ix;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float v = __ldg(src + c * hw);
#pragma unroll
          for (int r = 0; r < 5; ++r) acc[r][c] = fmaf(wr[r], v, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[static_cast<int64_t>(r * C + c) * q + qi] = acc[r][c];
}

// Block (bx, by) accumulates queries [bx * q_per_block, ...) into cells
// [by * cells_per_chunk, ...).  SMEM: in shared memory, flushed once at the
// end; otherwise straight into dcells.  dcells must be zeroed.
template <int C, bool SMEM>
__global__ void __launch_bounds__(kBwdThreads)
    fused2w_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ points,
                       float* __restrict__ dcells, int n, int h, int w, int q,
                       int cells_per_chunk, int q_per_block,
                       csm::SamplerParams p) {
  extern __shared__ float sacc[];
  const int hw = h * w;
  const int n0 = blockIdx.y * cells_per_chunk;
  const int n1 = min(n, n0 + cells_per_chunk);
  const int chunk_elems = (n1 - n0) * C * hw;
  float* chunk_out = dcells + static_cast<int64_t>(n0) * C * hw;
  float* acc = SMEM ? sacc : chunk_out;
  if (SMEM) {
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) sacc[e] = 0.0f;
    __syncthreads();
  }

  const int q0 = blockIdx.x * q_per_block;
  const int q1 = min(q, q0 + q_per_block);
  for (int qi = q0 + threadIdx.x; qi < q1; qi += blockDim.x) {
    float gv[5][C];
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c)
        gv[r][c] = __ldg(g + static_cast<int64_t>(r * C + c) * q + qi);
    const float px = points[2 * qi];
    const float py = points[2 * qi + 1];
    for (int ni = n0; ni < n1; ++ni) {
      const float off = csm::cell_offset(ni, n, p);
      const csm::AxisTable ax = csm::axis_table(px, w, off, p);
      const csm::AxisTable ay = csm::axis_table(py, h, off, p);
      float* cell = acc + (ni - n0) * C * hw;
#pragma unroll
      for (int cy = 0; cy < 2; ++cy) {
        const int iy = ay.i0 + cy;
        if (iy < 0 || iy >= h) continue;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int ix = ax.i0 + cx;
          if (ix < 0 || ix >= w) continue;
          float wr[5];
          csm::row_weights(ax, ay, cx, cy, wr);
          float* dst = cell + iy * w + ix;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float v = 0.0f;
#pragma unroll
            for (int r = 0; r < 5; ++r) v = fmaf(wr[r], gv[r][c], v);
            atomicAdd(dst + c * hw, v);
          }
        }
      }
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
      const float v = sacc[e];
      if (v != 0.0f) atomicAdd(chunk_out + e, v);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

csm::SamplerParams make_params(int kernel, int padding, int align,
                               int multicell, int strict, float off_step,
                               float off_stop) {
  csm::SamplerParams p;
  p.kernel = kernel;
  p.padding = padding;
  p.align = align != 0;
  p.multicell = multicell != 0;
  p.strict = strict != 0;
  p.off_step = off_step;
  p.off_stop = off_stop;
  return p;
}

template <int C>
cudaError_t launch_blend(const float* cells, const float* points, float* out,
                         int n, int h, int w, int q, csm::SamplerParams p,
                         cudaStream_t stream) {
  if (q == 0) return cudaGetLastError();
  fused2w_blend_kernel<C><<<cdiv(q, kBlendThreads), kBlendThreads, 0, stream>>>(
      cells, points, out, n, h, w, q, p);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const float* g, const float* points, float* dcells,
                       int n, int h, int w, int q, csm::SamplerParams p,
                       cudaStream_t stream) {
  if (q == 0 || n == 0 || h == 0 || w == 0) return cudaGetLastError();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  const int cell_bytes = C * h * w * static_cast<int>(sizeof(float));
  const bool smem = cell_bytes <= kBwdSmemBytes;
  const int cells_per_chunk =
      smem ? std::min(n, kBwdSmemBytes / cell_bytes) : n;
  const int chunks = cdiv(n, cells_per_chunk);
  // enough blocks for ~4 per SM, but no block with fewer queries than threads
  const int q_blocks =
      std::max(1, std::min(cdiv(4 * sms, chunks), cdiv(q, kBwdThreads)));
  const int q_per_block = cdiv(q, q_blocks);
  const dim3 grid(cdiv(q, q_per_block), chunks);
  if (smem) {
    const size_t bytes = static_cast<size_t>(cells_per_chunk) * cell_bytes;
    fused2w_bwd_kernel<C, true><<<grid, kBwdThreads, bytes, stream>>>(
        g, points, dcells, n, h, w, q, cells_per_chunk, q_per_block, p);
  } else {
    fused2w_bwd_kernel<C, false><<<grid, kBwdThreads, 0, stream>>>(
        g, points, dcells, n, h, w, q, cells_per_chunk, q_per_block, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Maximum channel count the kernels are instantiated for.
int fused2w_max_channels() { return 8; }

int fused2w_blend(const void* cells, const void* points, void* out, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const csm::SamplerParams p = make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
#define CSM_BLEND(C)                                                        \
  launch_blend<C>(static_cast<const float*>(cells),                         \
                  static_cast<const float*>(points), static_cast<float*>(out), \
                  n, h, w, q, p, static_cast<cudaStream_t>(stream))
  switch (c) {
    case 1: return CSM_BLEND(1);
    case 2: return CSM_BLEND(2);
    case 3: return CSM_BLEND(3);
    case 4: return CSM_BLEND(4);
    case 5: return CSM_BLEND(5);
    case 6: return CSM_BLEND(6);
    case 7: return CSM_BLEND(7);
    case 8: return CSM_BLEND(8);
    default: return cudaErrorInvalidValue;
  }
#undef CSM_BLEND
}

int fused2w_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int h, int w, int q, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  const csm::SamplerParams p = make_params(kernel, padding, align, multicell,
                                           strict, off_step, off_stop);
#define CSM_BWD(C)                                                          \
  launch_bwd<C>(static_cast<const float*>(g),                               \
                static_cast<const float*>(points),                          \
                static_cast<float*>(dcells), n, h, w, q, p,                 \
                static_cast<cudaStream_t>(stream))
  switch (c) {
    case 1: return CSM_BWD(1);
    case 2: return CSM_BWD(2);
    case 3: return CSM_BWD(3);
    case 4: return CSM_BWD(4);
    case 5: return CSM_BWD(5);
    case 6: return CSM_BWD(6);
    case 7: return CSM_BWD(7);
    case 8: return CSM_BWD(8);
    default: return cudaErrorInvalidValue;
  }
#undef CSM_BWD
}

const char* csm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
