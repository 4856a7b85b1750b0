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
//   in the card's opted-in shared memory take global atomics directly.
// * The TPU backward was deterministic (a sequential read-modify-write
//   chain).  This one is not: f32 atomics add in an order that changes from
//   run to run, so results agree with the plain version to rounding, not
//   bit for bit.
// The kernels are the D = 2 instances of csrc/fused_rows.cuh, which
// fused3w (csrc/fused3w.cu) and mega2w (csrc/mega2w.cu) share.
#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

csm::CellGeom<2> geom2(int h, int w) {
  csm::CellGeom<2> g;
  g.size[0] = w;
  g.size[1] = h;
  g.texels = h * w;
  return g;
}

}  // namespace

extern "C" {

// Maximum channel count the fused and mega2w kernels are instantiated for.
int fused2w_max_channels() { return csm::kMaxChannels; }

int fused2w_blend(const void* cells, const void* points, void* out, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::dispatch_channels(c, [&](auto cc) {
    return csm::fused::launch_blend<2, decltype(cc)::value>(
        static_cast<const float*>(cells), static_cast<const float*>(points),
        static_cast<float*>(out), n, geom2(h, w), q, p,
        static_cast<cudaStream_t>(stream));
  });
}

// dcells (N, C, H, W) must be zeroed.
int fused2w_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int h, int w, int q, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::dispatch_channels(c, [&](auto cc) {
    return csm::fused::launch_bwd<2, decltype(cc)::value>(
        static_cast<const float*>(g), static_cast<const float*>(points),
        static_cast<float*>(dcells), n, geom2(h, w), q, p,
        static_cast<cudaStream_t>(stream));
  });
}

const char* csm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
