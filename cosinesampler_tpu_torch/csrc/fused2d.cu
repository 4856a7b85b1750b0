// The small-cloud fused 2D blend and its transpose to the cells, for
// NVIDIA Hopper (sm_90a): value, d/dx, d/dy, d2/dx2, d2/dy2 summed over the
// multicell ensemble, served from a copy of the cell stack staged in shared
// memory.
//
// fused2d_blend replaces the TPU kernel
//   ops/pallas/fused2d.py::_fused2_blend_kernel of the JAX package
// fused2d_bwd replaces
//   ops/pallas/fused2d.py::_fused2_bwd_kernel of the JAX package
//
// Contract (fused2w's: the JAX package's fused op at dim 2):
//   blend: cells (N, C, H, W) f32, points (Q, 2) f32 shared by all cells ->
//          out (5, C, Q) f32.
//   bwd:   g (5, C, Q) f32 -> dcells (N, C, H, W) f32, the exact transpose.
// Zeros, border and reflection padding (the JAX kernels' wide set), every
// interpolant, multicell on and off, both align_corners; any C, a channel
// group of one cell (at most 8 channels) within a block's opted-in shared
// memory.
//
// Design:
// * The TPU kernels keep the whole stack in VMEM and gather each query's
//   shared 3x3 (4x4 with reflection) texel patch through nine one-hot MXU
//   contractions.  Hopper gathers per lane, so the patch and the one-hot
//   panels go: a thread per query walks its corners in a shared-memory copy
//   of the cells.
// * Small clouds (the JAX route: fewer than 2048 queries) give few query
//   blocks, so the cells are split too: block (bx, by, bz) serves queries
//   [bx * 128, ...) from a chunk of cells [by * cells_per_chunk, ...) of
//   channel group bz, staged once with coalesced loads.  The 96 x 4 x 16^2
//   stack is 393 KB, over the 227 KB a block gets, and a chunk of 4 cells
//   (16 KB) leaves room for several blocks an SM.  With more than one
//   chunk the blocks add their partial rows into the zeroed output with
//   f32 atomics, so the blend is not bit-deterministic.
// * bwd: the block accumulates its queries' cotangent into a zeroed shared
//   copy of its chunk with shared atomics and flushes it once with global
//   atomicAdd.  f32 atomics: not deterministic.
// * The body is staged_cells.cuh's.
#include <cuda_runtime.h>

#include "staged_cells.cuh"

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

int fused2d_blend(const void* cells, const void* points, void* out, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  return csm::staged::launch_blend<2>(
      cells, points, out, n, c, geom2(h, w), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// dcells (N, C, H, W) must be zeroed.
int fused2d_bwd(const void* g, const void* points, void* dcells, int n,
                int c, int h, int w, int q, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  return csm::staged::launch_bwd<2>(
      g, points, dcells, n, c, geom2(h, w), q,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
