// A counting sort of the (cell, query) pairs of one grid by a per-cell key,
// on the card with no host sync, shared by the slab bins (csrc/slab.cu,
// key: the floor row of the leading axis) and the percell plan
// (csrc/percell.cu, key: the z tile and y band of the floor corner).
//
// Output: perm (N * Q,) int32, the pair n * Q + q of each slot, ordered by
// (cell, key), and starts (N * K + 1,) int32, the first slot of each
// (cell, key) and the pair count last.  Three kernels:
// * count: each block counts kQueries (2048) queries of one cell in a
//   shared-memory histogram of the cell's K keys (the atomics' return
//   values rank each pair within the block) and adds each key's count to
//   the global one once (the return value is the block's base); one global
//   atomic a pair took most of the build's time;
// * scan: one block's exclusive scan of the N * K counts;
// * scatter: perm[starts[key] + rank] = pair.
// The order within a key is that of the atomics: not deterministic.
//
// A key functor has `int keys` (K, at most the shared-memory histogram's
// room) and `__device__ int operator()(const PairShape&, const float* grid,
// int ni, int qi, const SamplerParams&) const` in [0, K); it takes its
// floors from csrc/pair_corners.cuh's pair_floor, the kernels' own, so a
// pair's bin holds its corners.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "pair_corners.cuh"

namespace csm {
namespace bins {

constexpr int kThreads = 256;
// queries of one cell a count block takes, kPerThread a thread
constexpr int kPerThread = 8;
constexpr int kQueries = kThreads * kPerThread;
constexpr int kScanThreads = 1024;

// Block b counts queries [(b % qb) * kQueries, ...) of cell b / qb.
template <class Key>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const float* __restrict__ grid, int* __restrict__ key,
                 int* __restrict__ rank, int* __restrict__ counts,
                 PairShape s, SamplerParams p, Key kf, int qb) {
  extern __shared__ int hist[];
  const int ni = blockIdx.x / qb;
  const int q0 = (blockIdx.x - ni * qb) * kQueries + threadIdx.x;
  int* cell_counts = counts + static_cast<int64_t>(ni) * kf.keys;
  for (int k = threadIdx.x; k < kf.keys; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  int kk[kPerThread], local[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int qi = q0 + i * kThreads;
    kk[i] = -1;
    if (qi < s.q) {
      kk[i] = kf(s, grid, ni, qi, p);
      local[i] = atomicAdd(hist + kk[i], 1);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kf.keys; k += blockDim.x) {
    const int c = hist[k];
    if (c != 0) hist[k] = atomicAdd(cell_counts + k, c);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (kk[i] < 0) continue;
    const int pair = ni * s.q + q0 + i * kThreads;
    key[pair] = ni * kf.keys + kk[i];
    rank[pair] = local[i] + hist[kk[i]];
  }
}

// counts[0, m) -> their exclusive prefix sums in place, counts[m] = total:
// one block, each thread over a contiguous chunk
static __global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ counts, int m) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int per = (m + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, m), hi = min(lo + per, m);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (t == kScanThreads - 1) counts[m] = run;
}

static __global__ void __launch_bounds__(kThreads)
    scatter_kernel(const int* __restrict__ key, const int* __restrict__ rank,
                   const int* __restrict__ starts, int* __restrict__ perm,
                   int pairs) {
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= pairs) return;
  perm[__ldg(starts + key[pair]) + rank[pair]] = pair;
}

// key and rank (N * Q,) int32 scratch, starts (N * K + 1,) int32 zeroed,
// perm (N * Q,) int32.  The key count must fit a block's shared memory.
template <class Key>
cudaError_t sort_pairs(const float* grid, int* key, int* rank, int* starts,
                       int* perm, const PairShape& s, const SamplerParams& p,
                       const Key& kf, cudaStream_t stream) {
  if (s.n == 0 || s.q == 0) return cudaGetLastError();
  DeviceLimits lim;
  cudaError_t err = device_limits(&lim);
  if (err != cudaSuccess) return err;
  const int64_t hist_bytes = static_cast<int64_t>(kf.keys) * sizeof(int);
  const int qb = cdiv(s.q, kQueries);
  if (kf.keys < 1 || hist_bytes > lim.smem_optin ||
      static_cast<int64_t>(s.n) * qb > 0x7fffffff)
    return cudaErrorInvalidValue;
  err = allow_smem(&count_kernel<Key>, static_cast<size_t>(hist_bytes));
  if (err != cudaSuccess) return err;
  count_kernel<Key><<<s.n * qb, kThreads, hist_bytes, stream>>>(
      grid, key, rank, starts, s, p, kf, qb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(starts, s.n * kf.keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = s.n * s.q;
  scatter_kernel<<<cdiv(pairs, kThreads), kThreads, 0, stream>>>(
      key, rank, starts, perm, pairs);
  return cudaGetLastError();
}

}  // namespace bins
}  // namespace csm
