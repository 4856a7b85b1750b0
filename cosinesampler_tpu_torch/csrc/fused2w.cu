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
//   addresses.  The first design added them into chunks of cells in
//   shared memory, flushed once with global atomics; but every shared f32
//   add is an ATOMS.CAST.SPIN compare-and-swap loop, and those took most
//   of the kernel (PERF.md section 6).  Now the bwd is
//   csrc/texel_scatter.cuh's scatter through fused_scatter_bwd, the v1
//   bwd's launcher (csrc/fused.cu): blocks of 128 queries in order stage
//   their points and cotangents once; a warp's 32 lanes take 32 of a
//   query's cells, compute each cell's axis tables once and add one
//   float4 a corner into a zeroed texel-major (H, W, N, C) scratch (393 KB
//   at the main path, in L2), so that a warp's reductions cover
//   contiguous runs of a texel's N * C record and share 32-byte sectors:
//   38.4 M float4 reductions where there were 153.6 M shared adds.  The
//   tiled transpose writes the (N, C, H, W) cotangent.  Below a measured
//   number of points a texel (ops/cuda/fused2w.py bwd_geometry) the
//   scatter adds scalars into the zeroed cotangent in place (planar),
//   where the scratch's fill and transpose would cost more.  No
//   shared-memory atomics.
// * Channels: up to 8 a blend thread keeps all 5*C rows in registers;
//   above it a grid axis walks channel groups of at most 8, each redoing
//   the per-(query, cell) coordinate math (fused_rows.cuh
//   dispatch_groups).  The bwd takes groups of 4 channels over the lanes
//   (ops/cuda/scatter.py), scalar groups of at most 8 at other counts.
//   So any C takes these kernels as JAX's fused2w takes any C within
//   VMEM.
// * The TPU backward was deterministic (a sequential read-modify-write
//   chain).  This one is not: f32 atomics add in an order that changes from
//   run to run, so results agree with the plain version to rounding, not
//   bit for bit.
// The blend is the D = 2 instance of csrc/fused_rows.cuh, which fused3w
// (csrc/fused3w.cu) and mega2w (csrc/mega2w.cu) share.
#include <cuda_runtime.h>

#include "fused_rows.cuh"
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

int fused2w_blend(const void* cells, const void* points, void* out, int n,
                  int c, int h, int w, int q, int kernel, int padding,
                  int align, int multicell, int strict, float off_step,
                  float off_stop, void* stream) {
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::fused::dispatch_groups(
      c, [&](auto gw, auto one) {
    return csm::fused::launch_blend<2, decltype(gw)::value,
                                     decltype(one)::value>(
        static_cast<const float*>(cells), static_cast<const float*>(points),
        static_cast<float*>(out), n, c, geom2(h, w), q, p,
        static_cast<cudaStream_t>(stream));
  });
}

// g (5, C, Q), points, scratch (texel-major (H, W, N, C), zeroed; not
// used where planar), dcells (N, C, H, W), zeroed where planar; n, c, h,
// w, q; the launch layout of ops/cuda/fused2w.py bwd_geometry (width,
// block groups, lane groups, lanes, threads, planar); then the sampler
// arguments as fused2w_blend's.
int fused2w_bwd(const void* g, const void* points, void* scratch,
                void* dcells, int n, int c, int h, int w, int q, int width,
                int block_groups, int lane_groups, int lanes, int threads,
                int planar, int kernel, int padding, int align, int multicell,
                int strict, float off_step, float off_stop, void* stream) {
  return csm::fused_scatter_bwd<2>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(scratch), static_cast<float*>(dcells), n, c,
      geom2(h, w), q,
      csm::ScatterLayout{width, block_groups, lane_groups, lanes}, threads,
      planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

const char* csm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
