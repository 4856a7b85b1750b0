// The small-cloud fused 3D blend and its transpose to the cells, for
// NVIDIA Hopper (sm_90a): value, d/dx, d/dy, d/dz, d2/dx2, d2/dy2, d2/dz2
// summed over the multicell ensemble, served from chunks of the cell stack
// staged in shared memory.
//
// fused3d_blend replaces the TPU kernel
//   ops/pallas/fused3d.py::_fused3_blend_kernel of the JAX package
// fused3d_bwd replaces
//   ops/pallas/fused3d.py::_fused3_bwd_kernel of the JAX package
//
// Contract (fused3w's: the JAX package's fused op at dim 3):
//   blend: cells (N, C, D, H, W) f32, points (Q, 3) f32 shared by all
//          cells -> out (7, C, Q) f32.
//   bwd:   g (7, C, Q) f32 -> dcells (N, C, D, H, W) f32, the exact
//          transpose.
// Zeros, border and reflection padding (the JAX kernels' wide set), every
// interpolant, multicell on and off, both align_corners; any C, a channel
// group of one cell (at most 8 channels) within a block's opted-in shared
// memory (4 x 16^3 is 64 KB; 4 x 32^3, 512 KB, is refused).
//
// What bounds it on the H100 SXM (67 TFLOP/s f32, 3.35 TB/s at 700 W):
// at the reference's 50 x 4 x 16^3 stack (3.3 MB, in L2) and a few hundred
// points, neither: the work is 7 rows x 8 corners x C FMAs per (query,
// cell) pair, microseconds of it, and what costs is spreading it over 132
// SMs.
//
// Design:
// * The TPU kernels keep the whole stack in VMEM and gather each query's
//   shared 3x3x3 (4x4x4 with reflection) texel patch through 27 (64)
//   one-hot MXU contractions against the flattened volume.  Hopper
//   gathers per lane, so the patch and the one-hot panels go: a thread per
//   query walks its own corners (fused_rows.cuh, per cell
//   floor(base + offset), so reflection's 4-wide patch needs nothing
//   extra).
// * fused3w runs one thread per query over all cells: at 200 points that
//   is two blocks for 132 SMs.  Here the cells are split over blocks too:
//   block (bx, by, bz) serves queries [bx * q_per_block, ...) from a chunk
//   of cells of channel group bz staged in shared memory (one 64 KB cell
//   at 4 x 16^3, three blocks to an SM), and adds its partial rows into
//   the zeroed output with f32 atomics (not bit-deterministic).
// * bwd: the block accumulates its queries' cotangent into a zeroed shared
//   copy of its chunk with shared atomics and flushes the nonzero entries
//   once with global atomicAdd.  f32 atomics: not deterministic.
// * The body is staged_cells.cuh's, shared with fused2d.cu (D = 2).
#include <cuda_runtime.h>

#include "staged_cells.cuh"

extern "C" {

int fused3d_blend(const void* cells, const void* points, void* out, int n,
                  int c, int d, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  return csm::staged::launch_blend<3>(
      cells, points, out, n, c, csm::cell_geom3(d, h, w), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// dcells (N, C, D, H, W) must be zeroed.
int fused3d_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int d, int h, int w, int q, int kernel, int padding,
                int align, int multicell, int strict, float off_step,
                float off_stop, void* stream) {
  return csm::staged::launch_bwd<3>(
      g, points, dcells, n, c, csm::cell_geom3(d, h, w), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
