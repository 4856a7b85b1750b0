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
// * blend: the first design, a thread a query over its N cells reading
//   8 corners x C channels a cell from the planar cells, one 4-byte load
//   a (query, cell, corner, channel): 160 M loads at the 3D main path
//   (50 x 4 x 16^3, 100 000 points), a warp's scattered queries touching
//   ~31 sectors of a 16 KB plane each.  A probe of it (PERF.md section
//   6) put the loads at ~0.077 of its 0.23 ms and the walk at 0.15.  Now
//   it is fused2w_blend's design (csrc/fused2w.cu): texel_gather.cuh's
//   gather through fused_gather_blend over a texel-major (D, H, W, N, C)
//   copy (3.3 MB, in L2), a few cell lanes a query holding all C
//   channels, 40 M float4 loads, the (7, C, Q) rows stored directly; the
//   cells read in place (planar) where a call reads few cell values for
//   the stack's size.  At the 3D main path it does 50 x 100 000 x 8 x 4 x
//   7 FMAs (~0.033 ms at the f32 peak): bound by operations and the
//   per-(query, cell) coordinate math (three sincospif).
// * bwd: the first design added into chunks of cells in shared memory
//   (a 4 x 16^3 cell is 64 KiB: 3 cells a chunk, 17 chunks, 512 threads
//   and one block an SM), 160 M shared f32 adds a call at the main path,
//   each an ATOMS.CAST.SPIN compare-and-swap loop (PERF.md section 6).
//   Now it is fused2w_bwd's design (csrc/fused2w.cu): texel_scatter.cuh's
//   scatter through fused_scatter_bwd (csrc/fused.cu), a warp's lanes
//   over 32 of a query's cells adding one float4 a corner into a zeroed
//   texel-major (D, H, W, N, C) scratch (3.3 MB, in L2): 40 M float4
//   reductions, no shared-memory atomics; the tiled transpose writes the
//   (N, C, D, H, W) cotangent.  Below a measured number of points a
//   texel (ops/cuda/fused2w.py bwd_geometry) the scatter adds scalars
//   into the zeroed cotangent in place (planar).  f32 atomics: not
//   deterministic.
// * Channels: above 8, the blend takes the v1 blend's layout (lanes of up
//   to 8 interleaved channels, channel blocks on a grid axis), as
//   fused2w's (csrc/fused2w.cu); the bwd's groups of 4 over the lanes
//   (ops/cuda/scatter.py).
// Both kernels walk each (query, cell)'s corners with csrc/fused_rows.cuh.
#include <cuda_runtime.h>

#include "fused_rows.cuh"
#include "texel_gather.cuh"
#include "texel_scatter.cuh"

extern "C" {

// cells (N, C, D, H, W), points, vol (the texel-major (D, H, W, N, C)
// copy; unused where planar), out (7, C, Q); n, c, d, h, w, q; the launch
// layout of ops/cuda/v1.py blend_geometry (width, groups, cell lanes,
// threads, planar); then the sampler arguments as fused2w_blend's.
int fused3w_blend(const void* cells, const void* points, void* vol,
                  void* out, int n, int c, int d, int h, int w, int q,
                  int width, int groups, int cell_lanes, int threads,
                  int planar, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  return csm::fused_gather_blend<3>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(vol), static_cast<float*>(out), n, c,
      csm::cell_geom3(d, h, w), q,
      csm::GatherLayout{width, groups, cell_lanes}, threads, planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// g (7, C, Q), points, scratch (texel-major (D, H, W, N, C), zeroed; not
// used where planar), dcells (N, C, D, H, W), zeroed where planar; n, c,
// d, h, w, q; the launch layout of ops/cuda/fused2w.py bwd_geometry
// (width, block groups, lane groups, lanes, threads, planar); then the
// sampler arguments as fused3w_blend's.
int fused3w_bwd(const void* g, const void* points, void* scratch,
                void* dcells, int n, int c, int d, int h, int w, int q,
                int width, int block_groups, int lane_groups, int lanes,
                int threads, int planar, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  return csm::fused_scatter_bwd<3>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(scratch), static_cast<float*>(dcells), n, c,
      csm::cell_geom3(d, h, w), q,
      csm::ScatterLayout{width, block_groups, lane_groups, lanes}, threads,
      planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
