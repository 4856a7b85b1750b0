// The small-cloud fused 2D blend and its transpose to the cells, for
// NVIDIA Hopper (sm_90a): value, d/dx, d/dy, d2/dx2, d2/dy2 summed over the
// multicell ensemble, for many cells at few points.
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
// interpolant, multicell on and off, both align_corners, strict
// reference; any C, in channel groups of at most 8; cells of any size the
// 32-bit indexing takes.
//
// What bounds it on the H100 SXM (67 TFLOP/s f32, 3.35 TB/s at 700 W):
// at the reference's 96 x 4 x 16^2 stack (393 KB, in L2) and a few
// hundred to two thousand points, neither: the work is 5 rows x 4
// corners x C FMAs per (query, cell) pair, under a microsecond of the
// card's rate, and what costs is spreading it over 132 SMs and the
// latency of each lane's walk.
//
// Design:
// * The TPU kernels keep the whole stack in VMEM and gather each query's
//   shared 3x3 (4x4 with reflection) texel patch through nine one-hot MXU
//   contractions.  Hopper gathers per lane, so the patch and the one-hot
//   panels go: a lane walks one (query, cell) pair's corners
//   (fused_rows.cuh, per cell floor(base + offset), so reflection's
//   4-wide patch needs nothing extra).
// * Why lanes over cells: fused2w's blocks serve 128 queries in order, a
//   few lanes a query, so 1 024 points make 8 blocks for 132 SMs.  The
//   design before split the cells over blocks instead, each staging a
//   chunk of 4 cells in shared memory, adding its partial rows into a
//   zeroed output with f32 atomics (24 chunks into every row at path
//   (b): not bit-deterministic), and its bwd accumulating into a zeroed
//   shared copy of the chunk with shared compare-and-swap adds, scanned
//   and flushed with global atomics.  Now both kernels are fused2w's
//   bodies through its launchers (csrc/fused.cu fused_gather_blend /
//   fused_scatter_bwd) with blocks of a few queries: a warp's 32 lanes
//   over one query's cells (ops/cuda/small_cloud.py), 4 queries a
//   128-thread block, so 1 024 points make 256 blocks and a lane walks 3
//   of the 96 cells.
// * blend: texel_gather.cuh's gather, the cells read in place (planar)
//   where the layout says so, or through the tiled transpose's
//   texel-major copy; each lane holds all C <= 8 channels of its cells'
//   rows in registers, the cell lanes add them by warp shuffles in a
//   fixed order and one lane stores the query's rows once into (5, C,
//   Q): no staging, no output fill, no atomics, bit-deterministic.
// * bwd: texel_scatter.cuh's scatter, a lane a (query, cell, channel
//   group), adding each corner's values straight into the zeroed
//   cotangent (planar: scalar reductions) or into a zeroed texel-major
//   scratch (float4 reductions at C a multiple of 4) that the tiled
//   transpose writes out, by the layout.  No shared-memory atomics, no
//   staged chunk to zero and scan.  f32 atomics: not deterministic.
#include <cuda_runtime.h>

#include "fused_rows.cuh"
#include "texel_gather.cuh"
#include "texel_scatter.cuh"

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

// cells (N, C, H, W), points, vol (the texel-major (H, W, N, C) copy;
// unused where planar), out (5, C, Q); n, c, h, w, q; the launch layout
// of ops/cuda/small_cloud.py (width, groups, cell lanes, threads, queries
// a block, planar); kernel, padding, align, multicell, strict; the offset
// lattice's step and stop; the stream.
int fused2d_blend(const void* cells, const void* points, void* vol,
                  void* out, int n, int c, int h, int w, int q, int width,
                  int groups, int cell_lanes, int threads, int queries,
                  int planar, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  return csm::fused_gather_blend<2>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(vol), static_cast<float*>(out), n, c, geom2(h, w),
      q, csm::GatherLayout{width, groups, cell_lanes}, threads, planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream), queries);
}

// g (5, C, Q), points, scratch (texel-major (H, W, N, C), zeroed; not
// used where planar), dcells (N, C, H, W), zeroed where planar; n, c, h,
// w, q; the launch layout of ops/cuda/small_cloud.py (width, block
// groups, lane groups, lanes, threads, queries a block, planar); then the
// sampler arguments as fused2d_blend's.
int fused2d_bwd(const void* g, const void* points, void* scratch,
                void* dcells, int n, int c, int h, int w, int q, int width,
                int block_groups, int lane_groups, int lanes, int threads,
                int queries, int planar, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  return csm::fused_scatter_bwd<2>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(scratch), static_cast<float*>(dcells), n, c,
      geom2(h, w), q,
      csm::ScatterLayout{width, block_groups, lane_groups, lanes}, threads,
      planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream), queries);
}

}  // extern "C"
