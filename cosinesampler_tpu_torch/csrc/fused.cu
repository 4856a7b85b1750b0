// The v1 fused value/jacobian/diagonal-Hessian blend and its transpose to
// the cells, in 2D and 3D and at any channel count, for NVIDIA Hopper
// (sm_90a): a route of the fused op above 8 channels, beside fused2w /
// fused3w's channel groups (ops/cuda/route.py fused_rule).
//
// fused_v1_blend2 / fused_v1_blend3 replace the TPU kernel
//   ops/pallas/fused.py::_fused_blend_kernel of the JAX package
// fused_v1_bwd2 / fused_v1_bwd3 replace
//   ops/pallas/fused.py::_fused_bwd_kernel of the JAX package
//
// Contract (the JAX package's fused op, generic.blend per row, summed over
// the N cells):
//   blend: cells (N, C, *S) f32, points (Q, D) f32 shared by all cells ->
//          out (1 + 2D, C, Q) f32, rows value, d/dx_i, d2/dx_i2 in
//          all_orders order; grid axis 0 (x) addresses W, 1 H, 2 D.
//   bwd:   g (1 + 2D, C, Q) f32 -> dcells (N, C, *S) f32, the exact
//          transpose.
// Every padding mode and interpolant, multicell on and off, both
// align_corners, the strict-reference reflection span; any C.  Each
// cell's floor is taken as floor(base + offset) (fused_rows.cuh).
//
// What bounds it on the H100 (67 TFLOP/s f32, 3.35 TB/s at 700 W): the
// FMAs, 2 x (1 + 2D) x 2^D per (query, cell, channel) (0.092 ms at
// 96 x 16 x 16^2, 0.134 at 50 x 16 x 16^3, Q = 100 000).  The design
// before (a thread a (query, channel group of 8) over the planar cells,
// the bwd adding into shared chunks with one f32 atomicAdd a (query, cell,
// corner, channel)) spent its time elsewhere (a probe of it, PERF.md
// section 6): the blend on the walk (tables, corner weights and FMAs,
// 0.36 of 0.61 ms in 2D) and on 4-byte loads from a channel plane each
// (0.92 of 1.40 ms in 3D); the bwd on the shared adds, each an
// ATOMS.CAST.SPIN loop (1.2 of 1.77 ms in 2D, 2.4 of 3.2 in 3D).
//
// Design (the TPU kernels' VMEM-resident stack and one-hot MXU
// contractions are not carried over):
// * blend: a tiled transpose copies the cells into a texel-major
//   (*S, N, C) temporary (1.6 MB at 96 x 16 x 16^2, 13 MB at
//   50 x 16 x 16^3: the L2 holds both), and texel_gather.cuh's gather
//   serves blocks of 128 queries in order with a few lanes a query
//   (ops/cuda/v1.py): in 2D at C = 16 four lanes over the cells, each
//   holding all 16 channels, so that each (query, cell) is walked once
//   and the four lanes' 64-byte records of one texel make two whole
//   lines; in 3D two lanes of 8 interleaved channels.  The cell lanes
//   add by warp shuffles and store the (1 + 2D, C, Q) rows directly: the
//   queries come in order, so a warp's stores cover whole sectors (a
//   (Q, 1 + 2D, C) temporary and a second transpose, fused3s_blend's
//   store for its scattered queries, took 0.46 against 0.43 ms in 2D and
//   0.69 against 0.65 in 3D; PERF.md section 6).  Below a measured number
//   of points a texel the gather reads the cells in place (planar), as
//   fused3s_blend does.  That launcher, fused_gather_blend (declared in
//   csrc/texel_gather.cuh), is also fused2w_blend's and fused3w_blend's
//   (up to 8 channels a lane holds all of them, a few lanes over a
//   query's cells; ops/cuda/v1.py).  Staging chunks of cells in
//   shared memory lost in 2D (0.50-0.56 ms against 0.45, the walk alone
//   slower in the staged kernel), as did splitting a (query, cell)'s
//   axis tables over its lanes by shuffles (3D 1.06 against 0.67 ms):
//   the walk, not the loads, is most of the time (2D: 0.32 of 0.45 ms).
// * bwd: texel_scatter.cuh's scatter, a block per 128 queries staging
//   their points and cotangents once, a warp's lanes over (query, cell,
//   channel group of 4) adding float4 records into a zeroed texel-major
//   (*S, N, C) scratch (in L2 at path (a)), so that a warp's reductions
//   reach L2 in shared sectors; the tiled transpose writes the
//   (N, C, *S) cotangent.  No shared-memory atomics.  That launcher,
//   fused_scatter_bwd (declared in csrc/texel_scatter.cuh), is also
//   fused2w_bwd's and fused3w_bwd's, which can add into the cotangent in
//   place (planar) below a measured number of points a texel; the v1
//   bwd never does.
// f32 atomics are not deterministic: the bwd's sums change in the last
// bits from run to run; they agree with the plain version to 1e-4 of
// the largest value (chip_smoke.py).  The plain versions
// (ops/cuda/fused2w.py) are the oracle and the CPU path.
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_rows.cuh"
#include "texel_gather.cuh"
#include "texel_scatter.cuh"
#include "texel_transpose.cuh"

namespace {

using csm::CellGeom;
using csm::kRows;
using csm::SamplerParams;

template <int D>
CellGeom<D> geom_of(const int* sizes) {  // sizes: W, H(, D)
  CellGeom<D> g;
  g.texels = 1;
  for (int i = 0; i < D; ++i) {
    g.size[i] = sizes[i];
    g.texels *= sizes[i];
  }
  return g;
}

// Block (bx, by): queries [bx * qblock, ...) (qblock <= kGatherQueries:
// the v1, fused2w and fused3w blends take 128, fused2d and fused3d
// fewer), channels [by * groups * G, ...) of c, gathered from the
// texel-major vol (*S, N, C), or where PLANAR from the cells (N, C, *S)
// themselves (csrc/texel_gather.cuh), into out (1 + 2D, C, Q).
template <int D, int G, bool VEC, int THREADS, bool PLANAR>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* __restrict__ vol,
                  const float* __restrict__ points, float* __restrict__ out,
                  int n, int c, CellGeom<D> geom, int q, int qblock,
                  csm::GatherLayout lay, SamplerParams p) {
  const int t = threadIdx.x;
  const int qi = static_cast<int>(blockIdx.x) * qblock + t;
  csm::gather_block<D, G, VEC, false, PLANAR>(
      csm::GatherQuery{t < qblock && qi < q, qi}, points, vol, out, q, n, c,
      lay, geom, p);
}

// Block (bx, by): queries [bx * qblock, ...) (as gather_kernel's),
// channel groups [by * block_groups, ...) of c (csrc/texel_scatter.cuh),
// into the zeroed texel-major scratch (*S, N, C), or where PLANAR the
// zeroed cells cotangent (N, C, *S); VEC: scatter_vec.
template <int D, int G, bool VEC, bool PLANAR>
__global__ void __launch_bounds__(csm::kScatterMaxThreads)
    scatter_kernel(const float* __restrict__ g,
                   const float* __restrict__ points,
                   float* __restrict__ scratch, int n, int c,
                   CellGeom<D> geom, int q, int qblock,
                   csm::ScatterLayout lay, SamplerParams p) {
  const int t = threadIdx.x;
  const int qi = static_cast<int>(blockIdx.x) * qblock + t;
  csm::scatter_block<D, G, VEC, PLANAR>(
      csm::ScatterQuery{t < qblock && qi < q, qi}, g, q, points, scratch, n,
      c, lay, geom, p);
}

}  // namespace

namespace csm {

template <int D>
cudaError_t fused_gather_blend(const float* cells, const float* points,
                               float* vol, float* out, int n, int c,
                               const CellGeom<D>& geom, int q,
                               const GatherLayout& lay, int threads,
                               bool planar, const SamplerParams& p,
                               cudaStream_t s, int qblock) {
  if (qblock < 1 || qblock > kGatherQueries) return cudaErrorInvalidValue;
  if (q == 0 || c == 0) return cudaGetLastError();
  const size_t out_bytes = static_cast<size_t>(kRows<D>) * c * q * 4;
  if (n == 0 || geom.texels == 0) return cudaMemsetAsync(out, 0, out_bytes, s);
  if (!planar) {
    const cudaError_t err = transpose(
        cells, vol, static_cast<int64_t>(n) * c, geom.texels, 4, s);
    if (err != cudaSuccess) return err;
  }
  // planar cells take scalar loads whatever the channel count
  const auto pick = [planar](auto gw, auto vec, auto th) {
    constexpr int G = decltype(gw)::value;
    constexpr int T = decltype(th)::value;
    return planar ? &gather_kernel<D, G, false, T, true>
                  : &gather_kernel<D, G, decltype(vec)::value, T, false>;
  };
  return launch_gather<D == 2 ? 16 : kMaxChannels>(
      lay, c, threads, cdiv(q, qblock), s, pick, planar ? cells : vol,
      points, out, n, c, geom, q, qblock, lay, p);
}

template cudaError_t fused_gather_blend<2>(const float*, const float*,
                                           float*, float*, int, int,
                                           const CellGeom<2>&, int,
                                           const GatherLayout&, int, bool,
                                           const SamplerParams&,
                                           cudaStream_t, int);
template cudaError_t fused_gather_blend<3>(const float*, const float*,
                                           float*, float*, int, int,
                                           const CellGeom<3>&, int,
                                           const GatherLayout&, int, bool,
                                           const SamplerParams&,
                                           cudaStream_t, int);

template <int D>
cudaError_t fused_scatter_bwd(const float* g, const float* points,
                              float* scratch, float* out, int n, int c,
                              const CellGeom<D>& geom, int q,
                              const ScatterLayout& lay, int threads,
                              bool planar, const SamplerParams& p,
                              cudaStream_t s, int qblock) {
  if (qblock < 1 || qblock > kScatterQueries) return cudaErrorInvalidValue;
  if (n == 0 || c == 0 || geom.texels == 0) return cudaGetLastError();
  if (q > 0) {
    const auto scatter = [&](auto pick, float* dst) {
      return launch_scatter<D>(lay, c, threads, cdiv(q, qblock), s, pick, g,
                               points, dst, n, c, geom, q, qblock, lay, p);
    };
    // planar cells take scalar reductions whatever the channel count
    const cudaError_t err =
        planar ? scatter(
                     [](auto gw, auto) {
                       return &scatter_kernel<D, decltype(gw)::value, false,
                                              true>;
                     },
                     out)
               : scatter(
                     [](auto gw, auto vec) {
                       return &scatter_kernel<D, decltype(gw)::value,
                                              decltype(vec)::value, false>;
                     },
                     scratch);
    if (err != cudaSuccess) return err;
  }
  if (planar) return cudaGetLastError();
  return transpose(scratch, out, geom.texels, static_cast<int64_t>(n) * c, 4,
                   s);
}

template cudaError_t fused_scatter_bwd<2>(const float*, const float*, float*,
                                          float*, int, int,
                                          const CellGeom<2>&, int,
                                          const ScatterLayout&, int, bool,
                                          const SamplerParams&, cudaStream_t,
                                          int);
template cudaError_t fused_scatter_bwd<3>(const float*, const float*, float*,
                                          float*, int, int,
                                          const CellGeom<3>&, int,
                                          const ScatterLayout&, int, bool,
                                          const SamplerParams&, cudaStream_t,
                                          int);

}  // namespace csm

extern "C" {

// The blends: cells, points, vol (the texel-major copy; unused where
// planar), out (1 + 2D, C, Q); n, c, the sizes, q; the launch layout of
// ops/cuda/v1.py blend_geometry (width, groups, cell lanes, threads,
// planar); then fused2w's sampler arguments.  fused2w_blend and
// fused3w_blend take the same.
int fused_v1_blend2(const void* cells, const void* points, void* vol,
                    void* out, int n, int c, int h, int w, int q, int width,
                    int groups, int cell_lanes, int threads, int planar,
                    int kernel, int padding, int align, int multicell,
                    int strict, float off_step, float off_stop,
                    void* stream) {
  const int sizes[2] = {w, h};
  return csm::fused_gather_blend<2>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(vol), static_cast<float*>(out), n, c,
      geom_of<2>(sizes), q, csm::GatherLayout{width, groups, cell_lanes},
      threads, planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

int fused_v1_blend3(const void* cells, const void* points, void* vol,
                    void* out, int n, int c, int d, int h, int w, int q,
                    int width, int groups, int cell_lanes, int threads,
                    int planar, int kernel, int padding, int align,
                    int multicell, int strict, float off_step,
                    float off_stop, void* stream) {
  const int sizes[3] = {w, h, d};
  return csm::fused_gather_blend<3>(
      static_cast<const float*>(cells), static_cast<const float*>(points),
      static_cast<float*>(vol), static_cast<float*>(out), n, c,
      geom_of<3>(sizes), q, csm::GatherLayout{width, groups, cell_lanes},
      threads, planar != 0,
      csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

// The bwds: g (1 + 2D, C, Q), points, scratch (texel-major (*S, N, C),
// zeroed), out (N, C, *S); n, c, the sizes, q; the scatter layout of
// ops/cuda/v1.py (width, block groups, lane groups, lanes, threads); then
// fused2w's sampler arguments.
int fused_v1_bwd2(const void* g, const void* points, void* scratch,
                  void* out, int n, int c, int h, int w, int q, int width,
                  int block_groups, int lane_groups, int lanes, int threads,
                  int kernel, int padding, int align, int multicell,
                  int strict, float off_step, float off_stop, void* stream) {
  const int sizes[2] = {w, h};
  return csm::fused_scatter_bwd<2>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(scratch), static_cast<float*>(out), n, c,
      geom_of<2>(sizes), q,
      csm::ScatterLayout{width, block_groups, lane_groups, lanes}, threads,
      false, csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

int fused_v1_bwd3(const void* g, const void* points, void* scratch,
                  void* out, int n, int c, int d, int h, int w, int q,
                  int width, int block_groups, int lane_groups, int lanes,
                  int threads, int kernel, int padding, int align,
                  int multicell, int strict, float off_step, float off_stop,
                  void* stream) {
  const int sizes[3] = {w, h, d};
  return csm::fused_scatter_bwd<3>(
      static_cast<const float*>(g), static_cast<const float*>(points),
      static_cast<float*>(scratch), static_cast<float*>(out), n, c,
      geom_of<3>(sizes), q,
      csm::ScatterLayout{width, block_groups, lane_groups, lanes}, threads,
      false, csm::make_params(kernel, padding, align, multicell, strict, off_step,
                       off_stop),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
