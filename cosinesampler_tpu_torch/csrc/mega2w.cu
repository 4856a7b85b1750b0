// The whole 2D PINN train-step gradient in one launch, for NVIDIA Hopper
// (sm_90a).
//
// mega2w_step replaces the TPU kernel
//   ops/pallas/mega2w.py::_mega2w_kernel of the JAX package.
//
// Contract (the JAX kernel's, pinned there by tests/test_mega2w.py): the
// value and gradient of the fused PINN loss
//   loss = sum_q r_q^2 / Q,  r = allen_cahn or helmholtz residual of
//   u = w2 . tanh(W1^T f + b1) + b2 and its derivatives, f = the (5, C)
//   fused rows of query q summed over the N cells (csrc/fused_rows.cuh),
// with respect to the cells (N, C, H, W), w1 (C, Hd), b1 (Hd), w2 (Hd, 1)
// and b2 (1).  Equal to torch.autograd of pinn.loss_fused_slots up to f32
// summation order.
//
// The TPU kernel gets the MLP's cotangents from an in-kernel jax.vjp; here
// they are derived by hand, per query, with d1 = 1 - h^2, d2 = -2 h d1,
// d3 = (6 h^2 - 2) d1 and a_k = W1^T f_k, b_k = W1^T f_kk:
//   g_pre = w2 (g_u d1 + sum_k g_uk d2 a_k + g_ukk (d3 a_k^2 + d2 b_k))
//   g_a_k = w2 (g_uk d1 + 2 g_ukk d2 a_k),  g_b_k = w2 g_ukk d1
//   dw2  += g_u h + sum_k g_uk d1 a_k + g_ukk (d2 a_k^2 + d1 b_k)
//   db1  += g_pre,  dW1 += f g_pre + sum_k f_k g_a_k + f_kk g_b_k
//   g_f = W1 g_pre, g_f_k = W1 g_a_k, g_f_kk = W1 g_b_k
// and plain_mega2w_step (ops/cuda/mega2w.py) repeats them in PyTorch, held
// to torch.autograd in f64 by the CPU tests.  tanhf is the accurate libm
// one (no --use_fast_math): tanh saturates to +-1 and d1 to 0, so large
// pre-activations stay finite.
//
// What bounds it on the H100 SXM (its data sheet's peaks at the 700 W
// power limit: 67 TFLOP/s f32, 3.35 TB/s), and the design:
// * The work is the fused2w blend and splat (96 x 100 000 x 4 corners x 4
//   channels x 5 rows FMAs each at the main path, ~0.023 ms each at the
//   f32 peak) and a small MLP: bound by operations.  What the TPU kernel
//   keeps out of HBM, the (5C, Q) feature block, is 8 MB here (~2.4 us):
//   what one launch saves on this card is the launches and eager
//   operations of the two-kernel step around it.
// * Block b owns queries [b * tile, (b + 1) * tile), tile chosen so that
//   the blocks fill the SMs once, 512 threads each.  Stage 1: a thread
//   blends its query over all cells into 5C registers (as fused2w_blend).
//   Stage 2: the MLP forward, the residual and the backward above, in
//   registers; the MLP gradients and the loss are summed over each warp
//   with shuffles and over the block with shared-memory atomics.  The
//   query's feature cotangent goes to shared memory.  Stage 3: the block
//   splats its cotangents into the cells one chunk of cells at a time,
//   with shared-memory atomics, flushing each chunk with global atomicAdd
//   (fused2w_bwd's scheme with the chunk loop inside the block).  The
//   block's gradient row is added into the output with global atomicAdd.
// * Shared memory: the MLP and its gradient row, the block's 5C x tile
//   cotangents (at most half of the opted-in 227 KB) and the chunk.  A
//   cell larger than what is left takes global atomics directly.
// * A thread-block cluster whose blocks' shared memory together hold the
//   whole 393 KB cotangent of the main path would flush once per cluster
//   instead of once per block; that is a later design.
// * f32 atomics (shared and global): not deterministic; results agree with
//   the plain version to rounding.
#include <cuda_runtime.h>

#include "fused_rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxHidden = 32;
enum Pde : int { kAllenCahn = 0, kHelmholtz = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Adds the warp's sum of v into *dst (shared memory).
__device__ __forceinline__ void block_add(float* dst, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

// Gradient row layout (floats): dW1 (C, Hd) row-major, db1 (Hd), dw2 (Hd),
// db2, loss.  The MLP is staged in shared memory in the same order.
__host__ __device__ inline int row_len(int c, int hidden) {
  return (c + 2) * hidden + 2;
}

template <int C, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1)
    mega2w_kernel(const float* __restrict__ cells,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ points, float* __restrict__ dcells,
                  float* __restrict__ grads, int n, csm::CellGeom<2> geom,
                  int q, int hidden, int pde, int tile, int cells_per_chunk,
                  csm::SamplerParams p) {
  extern __shared__ float smem[];
  const int len = row_len(C, hidden);
  float* s_w1 = smem;                 // (C, Hd)
  float* s_b1 = s_w1 + C * hidden;
  float* s_w2 = s_b1 + hidden;
  const float bias2 = __ldg(b2);
  float* s_grad = smem + len;         // gradient row
  float* s_dw1 = s_grad;
  float* s_db1 = s_dw1 + C * hidden;
  float* s_dw2 = s_db1 + hidden;
  float* s_db2 = s_dw2 + hidden;
  float* s_loss = s_db2 + 1;
  float* s_gf = smem + 2 * len;       // (5 * C, tile) feature cotangents
  float* s_chunk = s_gf + 5 * C * tile;

  for (int i = threadIdx.x; i < C * hidden; i += blockDim.x) s_w1[i] = w1[i];
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    s_b1[i] = b1[i];
    s_w2[i] = w2[i];
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) s_grad[i] = 0.0f;
  __syncthreads();

  const int q0 = blockIdx.x * tile;
  const int nq = min(q, q0 + tile) - q0;
  const float inv_q = 1.0f / static_cast<float>(q);

  // stages 1 and 2; every thread runs every round (the warp sums need all
  // lanes), a lane past the block's queries with a zero cotangent
  for (int s = threadIdx.x; s - static_cast<int>(threadIdx.x) < tile;
       s += blockDim.x) {
    const bool valid = s < nq;
    float f[5][C];
    float pt[2] = {0.0f, 0.0f};
    if (valid) {
      pt[0] = points[2 * (q0 + s)];
      pt[1] = points[2 * (q0 + s) + 1];
      csm::blend_query<2, C>(cells, geom, n, pt, p, f);
    } else {
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) f[r][c] = 0.0f;
    }

    // forward: u, u_k, u_kk (k = x, y)
    float u = bias2, ud[2] = {0.0f, 0.0f}, udd[2] = {0.0f, 0.0f};
    for (int j = 0; j < hidden; ++j) {
      float pre = s_b1[j], a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float wc = s_w1[c * hidden + j];
        pre = fmaf(wc, f[0][c], pre);
        a[0] = fmaf(wc, f[1][c], a[0]);
        a[1] = fmaf(wc, f[2][c], a[1]);
        b[0] = fmaf(wc, f[3][c], b[0]);
        b[1] = fmaf(wc, f[4][c], b[1]);
      }
      const float h = tanhf(pre);
      const float d1 = 1.0f - h * h;
      const float d2 = -2.0f * h * d1;
      const float w2j = s_w2[j];
      u += w2j * h;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        ud[k] += w2j * (d1 * a[k]);
        udd[k] += w2j * (d2 * a[k] * a[k] + d1 * b[k]);
      }
    }

    // residual and its cotangents
    float r, gu, gud[2] = {0.0f, 0.0f}, gudd[2];
    if (pde == kAllenCahn) {
      r = 2.0f * ud[1] + 5.0f * u * u * u - 5.0f * u - 1e-4f * udd[0];
    } else {
      r = udd[0] + udd[1] + u;
    }
    const float gr = valid ? 2.0f * r * inv_q : 0.0f;
    if (pde == kAllenCahn) {
      gu = gr * (15.0f * u * u - 5.0f);
      gud[1] = 2.0f * gr;
      gudd[0] = -1e-4f * gr;
      gudd[1] = 0.0f;
    } else {
      gu = gr;
      gudd[0] = gr;
      gudd[1] = gr;
    }

    // backward through the MLP
    float gf[5][C];
#pragma unroll
    for (int rr = 0; rr < 5; ++rr)
#pragma unroll
      for (int c = 0; c < C; ++c) gf[rr][c] = 0.0f;
    for (int j = 0; j < hidden; ++j) {
      float pre = s_b1[j], a[2] = {0.0f, 0.0f}, b[2] = {0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float wc = s_w1[c * hidden + j];
        pre = fmaf(wc, f[0][c], pre);
        a[0] = fmaf(wc, f[1][c], a[0]);
        a[1] = fmaf(wc, f[2][c], a[1]);
        b[0] = fmaf(wc, f[3][c], b[0]);
        b[1] = fmaf(wc, f[4][c], b[1]);
      }
      const float h = tanhf(pre);
      const float d1 = 1.0f - h * h;
      const float d2 = -2.0f * h * d1;
      const float d3 = (6.0f * h * h - 2.0f) * d1;
      const float w2j = s_w2[j];
      float inner = gu * d1, dw2 = gu * h, ga[2], gb[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        inner += gud[k] * d2 * a[k] + gudd[k] * (d3 * a[k] * a[k] + d2 * b[k]);
        dw2 += gud[k] * d1 * a[k] + gudd[k] * (d2 * a[k] * a[k] + d1 * b[k]);
        ga[k] = w2j * (gud[k] * d1 + 2.0f * gudd[k] * d2 * a[k]);
        gb[k] = w2j * (gudd[k] * d1);
      }
      const float gpre = w2j * inner;
      block_add(s_db1 + j, gpre);
      block_add(s_dw2 + j, dw2);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float wc = s_w1[c * hidden + j];
        block_add(s_dw1 + c * hidden + j,
                  f[0][c] * gpre + f[1][c] * ga[0] + f[2][c] * ga[1] +
                      f[3][c] * gb[0] + f[4][c] * gb[1]);
        gf[0][c] = fmaf(wc, gpre, gf[0][c]);
        gf[1][c] = fmaf(wc, ga[0], gf[1][c]);
        gf[2][c] = fmaf(wc, ga[1], gf[2][c]);
        gf[3][c] = fmaf(wc, gb[0], gf[3][c]);
        gf[4][c] = fmaf(wc, gb[1], gf[4][c]);
      }
    }
    block_add(s_db2, gu);
    block_add(s_loss, valid ? r * r * inv_q : 0.0f);
    if (valid) {
#pragma unroll
      for (int rr = 0; rr < 5; ++rr)
#pragma unroll
        for (int c = 0; c < C; ++c) s_gf[(rr * C + c) * tile + s] = gf[rr][c];
    }
  }
  __syncthreads();

  // stage 3: splat the block's feature cotangents, one chunk of cells at a
  // time
  const int cell_elems = C * geom.texels;
  for (int n0 = 0; n0 < n; n0 += cells_per_chunk) {
    const int n1 = min(n, n0 + cells_per_chunk);
    const int chunk_elems = (n1 - n0) * cell_elems;
    float* chunk_out = dcells + static_cast<int64_t>(n0) * cell_elems;
    float* acc = SMEM ? s_chunk : chunk_out;
    if (SMEM) {
      for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x)
        s_chunk[e] = 0.0f;
      __syncthreads();
    }
    for (int s = threadIdx.x; s < nq; s += blockDim.x) {
      float gv[5][C];
#pragma unroll
      for (int rr = 0; rr < 5; ++rr)
#pragma unroll
        for (int c = 0; c < C; ++c) gv[rr][c] = s_gf[(rr * C + c) * tile + s];
      const float pt[2] = {points[2 * (q0 + s)], points[2 * (q0 + s) + 1]};
      csm::splat_query<2, C>(acc, geom, n0, n1, n, pt, p, gv);
    }
    if (SMEM) {
      __syncthreads();
      for (int e = threadIdx.x; e < chunk_elems; e += blockDim.x) {
        const float v = s_chunk[e];
        if (v != 0.0f) atomicAdd(chunk_out + e, v);
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < len; i += blockDim.x)
    atomicAdd(grads + i, s_grad[i]);
}

template <int C>
cudaError_t launch(const float* cells, const float* w1, const float* b1,
                   const float* w2, const float* b2, const float* points,
                   float* dcells, float* grads, int n, int h, int w, int q,
                   int hidden, int pde, const csm::SamplerParams& p,
                   cudaStream_t stream) {
  if (q == 0 || n == 0 || h == 0 || w == 0) return cudaGetLastError();
  csm::DeviceLimits lim;
  cudaError_t err = csm::device_limits(&lim);
  if (err != cudaSuccess) return err;
  csm::CellGeom<2> geom;
  geom.size[0] = w;
  geom.size[1] = h;
  geom.texels = h * w;

  const int64_t head = 2 * static_cast<int64_t>(row_len(C, hidden)) * 4;
  const int64_t per_query = 5 * C * 4;
  // one block per SM, each at least one round of threads, its cotangent
  // tile within half of the opted-in shared memory
  const int max_tile =
      static_cast<int>((lim.smem_optin / 2 - head) / per_query);
  const int tile =
      std::min(max_tile, std::max(csm::cdiv(q, lim.sms), kThreads));
  const int blocks = csm::cdiv(q, tile);
  const int64_t space = lim.smem_optin - head - tile * per_query;
  const int64_t cell_bytes = static_cast<int64_t>(C) * geom.texels * 4;
  const bool smem = cell_bytes <= space;
  const int cells_per_chunk =
      smem ? static_cast<int>(std::min<int64_t>(n, space / cell_bytes)) : n;
  const size_t bytes = static_cast<size_t>(
      head + tile * per_query + (smem ? cells_per_chunk * cell_bytes : 0));
  if (smem) {
    auto* kernel = &mega2w_kernel<C, true>;
    err = csm::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, bytes, stream>>>(
        cells, w1, b1, w2, b2, points, dcells, grads, n, geom, q, hidden, pde,
        tile, cells_per_chunk, p);
  } else {
    auto* kernel = &mega2w_kernel<C, false>;
    err = csm::allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, bytes, stream>>>(
        cells, w1, b1, w2, b2, points, dcells, grads, n, geom, q, hidden, pde,
        tile, cells_per_chunk, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dcells (N, C, H, W) and grads ((C + 2) * Hd + 2 floats: dW1 (C, Hd),
// db1, dw2, db2, loss) must be zeroed.
int mega2w_step(const void* cells, const void* w1, const void* b1,
                const void* w2, const void* b2, const void* points,
                void* dcells, void* grads, int n, int c, int h, int w, int q,
                int hidden, int pde, int kernel, int padding, int align,
                int multicell, int strict, float off_step, float off_stop,
                void* stream) {
  if (hidden < 1 || hidden > kMaxHidden || (pde != kAllenCahn &&
                                            pde != kHelmholtz))
    return cudaErrorInvalidValue;
  const csm::SamplerParams p = csm::make_params(
      kernel, padding, align, multicell, strict, off_step, off_stop);
  return csm::dispatch_channels(c, [&](auto cc) {
    return launch<decltype(cc)::value>(
        static_cast<const float*>(cells), static_cast<const float*>(w1),
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<const float*>(points),
        static_cast<float*>(dcells), static_cast<float*>(grads), n, h, w, q,
        hidden, pde, p, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
