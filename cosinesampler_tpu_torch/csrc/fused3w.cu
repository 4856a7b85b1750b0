// Fused 3D multicell sampling with first and pure second derivatives, and
// its transpose to the cells, for NVIDIA Hopper (sm_90a).
//
// fused3w_blend replaces the TPU kernel
//   ops/pallas/fused3w.py::_fused3w_blend_kernel of the JAX package
// fused3w_bwd replaces
//   ops/pallas/fused3w.py::_fused3w_bwd_kernel of the JAX package
//
// Contract (the JAX package's fused op at dim 3, generic.blend per row,
// summed over the N cells):
//   blend: cells (N, C, D, H, W) f32, points (Q, 3) f32 shared by all cells
//          -> out (7, C, Q) f32, rows value, d/dx, d/dy, d/dz, d2/dx2,
//          d2/dy2, d2/dz2; grid axis 0 (x) addresses W, 2 (z) D.
//   bwd:   g (7, C, Q) f32 -> dcells (N, C, D, H, W) f32, the transpose.
// All three padding modes and interpolants, multicell on and off, both
// align_corners.
//
// What bounds them on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * The TPU kernels bin queries by (z, y), cut per-bin windows and gather
//   through one-hot MXU contractions, because the TPU has no per-lane
//   gather and no atomics.  None of that is carried over.
// * blend: one thread per query loops over the N cells, reads 8 corners x
//   C channels per cell from global memory (the 50 x 4 x 16^3 f32 stack,
//   3.3 MB, sits in L2) and keeps the 7*C sums in registers.  At the 3D
//   main path it does 50 x 100 000 x 8 x 4 x 7 FMAs (~0.033 ms at the f32
//   peak): bound by operations and the per-(query, cell) coordinate math
//   (three sincospif).
// * bwd: shared-memory atomics per chunk of cells, flushed once with
//   global atomicAdd, as fused2w_bwd.  A 4 x 16^3 f32 cell is 64 KiB, over
//   the 48 KB a block gets without opting in, so a block opts in to the
//   card's limit (227 KB on the H100: 3 cells per chunk) and runs 512
//   threads, one block per SM.  A cell above the limit (4 x 32^3) takes
//   global atomics directly.  f32 atomics: not deterministic.
// The kernels are the D = 3 instances of csrc/fused_rows.cuh.
#include <cuda_runtime.h>

#include "fused_rows.cuh"

extern "C" {

int fused3w_blend(const void* cells, const void* points, void* out, int n,
                  int c, int d, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::dispatch_channels(c, [&](auto cc) {
    return csm::fused::launch_blend<3, decltype(cc)::value>(
        static_cast<const float*>(cells), static_cast<const float*>(points),
        static_cast<float*>(out), n, csm::cell_geom3(d, h, w), q, p,
        static_cast<cudaStream_t>(stream));
  });
}

// dcells (N, C, D, H, W) must be zeroed.
int fused3w_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int d, int h, int w, int q, int kernel, int padding,
                int align, int multicell, int strict, float off_step,
                float off_stop, void* stream) {
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::dispatch_channels(c, [&](auto cc) {
    return csm::fused::launch_bwd<3, decltype(cc)::value>(
        static_cast<const float*>(g), static_cast<const float*>(points),
        static_cast<float*>(dcells), n, csm::cell_geom3(d, h, w), q, p,
        static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
