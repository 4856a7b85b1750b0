// Per-thread sampler math shared by the fused2w and blend_o/splat_o kernels.
//
// Device counterparts of ops/coords.py and ops/interpolants.py.  The
// coordinate transform uses the round-to-nearest intrinsics (__fadd_rn,
// __fmul_rn) so that nvcc cannot contract `(coord + 1) * scale + offset`
// into an FMA: the source coordinate, and with it the corner floor, stays
// bit-identical to the PyTorch version.  A one-ulp difference there flips
// a corner at exact texel ticks, where the second derivative jumps.
//
// The interpolant uses libm sincospif (correctly rounded to ~1 ulp), never
// the __cosf/__sinf intrinsics, and the sources are never built with
// --use_fast_math: the fast intrinsics repeat the ~1e-3 error of the TPU
// vector unit's trig that the JAX package had to work around.
#pragma once

#include <cuda_runtime.h>

namespace csm {

enum Kernel : int { kCosine = 0, kLinear = 1, kSmoothstep = 2 };
enum Padding : int { kZeros = 0, kBorder = 1, kReflection = 2 };

struct SamplerParams {
  int kernel;       // Kernel
  int padding;      // Padding
  bool align;       // align_corners
  bool multicell;
  bool strict;      // strict_reference (reflection span quirk)
  // multicell shift of cell i < N-1 is i * off_step, of cell N-1 off_stop
  // (ops/coords.py offset_lattice; both zero without multicell)
  float off_step;
  float off_stop;
};

// Floor corner index and the order-0/1/2 corner weights of one axis,
// already scaled by mult**k.  w[k][0] weighs the floor corner, w[k][1]
// the ceil corner.
struct AxisTable {
  int i0;
  float w[3][2];
};

// The per-cell shift, rounded exactly as ops/coords.py multicell_offsets.
__device__ __forceinline__ float cell_offset(int ni, int n,
                                            const SamplerParams& p) {
  return ni == n - 1 ? p.off_stop
                     : __fmul_rn(static_cast<float>(ni), p.off_step);
}

__device__ __forceinline__ float clip_coord(float x, int size, float* mult) {
  const float hi = static_cast<float>(size - 1);
  *mult = (x > 0.0f && x < hi) ? 1.0f : 0.0f;
  return x <= 0.0f ? 0.0f : (x >= hi ? hi : x);
}

__device__ __forceinline__ float reflect_coord(float x, int twice_low,
                                               int twice_high, float* mult) {
  if (twice_low == twice_high) {
    *mult = 0.0f;
    return 0.0f;
  }
  const float mn = 0.5f * static_cast<float>(twice_low);
  const float span = 0.5f * static_cast<float>(twice_high - twice_low);
  const float shifted = __fsub_rn(x, mn);
  const float sign = shifted < 0.0f ? -1.0f : 1.0f;
  const float mag = fabsf(shifted);
  const float extra = fmodf(mag, span);
  const float flips = floorf(__fdiv_rn(mag, span));
  const bool even = fmodf(flips, 2.0f) == 0.0f;
  *mult = even ? sign : -sign;
  return even ? __fadd_rn(extra, mn) : __fadd_rn(__fsub_rn(span, extra), mn);
}

// compute_source_coords: unnormalize -> (clip | reflect + clip).
__device__ __forceinline__ float source_coord(float coord, int size,
                                              float offset,
                                              const SamplerParams& p,
                                              float* mult) {
  float x;
  if (p.align) {
    const int eff = p.multicell ? size - 1 : size;
    const float scale = 0.5f * static_cast<float>(eff - 1);
    x = __fadd_rn(__fmul_rn(__fadd_rn(coord, 1.0f), scale), offset);
    *mult = scale;
  } else {
    const float eff = static_cast<float>(size);
    x = __fadd_rn(
        __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(coord, 1.0f), eff), 1.0f),
                  0.5f),
        offset);
    *mult = 0.5f * eff;
  }
  if (p.padding == kZeros) return x;
  float m;
  if (p.padding == kReflection) {
    const int eff = (p.multicell || p.strict) ? size - 1 : size;
    x = p.align ? reflect_coord(x, 0, 2 * (eff - 1), &m)
                : reflect_coord(x, -1, 2 * size - 1, &m);
    *mult = __fmul_rn(*mult, m);
  }
  x = clip_coord(x, size, &m);
  *mult = __fmul_rn(*mult, m);
  return x;
}

// w^(k)(t) for k = 0, 1, 2.
__device__ __forceinline__ void kernel_weights(int kernel, float t,
                                               float w[3]) {
  if (kernel == kCosine) {
    float s, c;
    sincospif(t, &s, &c);
    const float pi = 3.14159265358979323846f;
    w[0] = 0.5f * (1.0f - c);
    w[1] = 0.5f * pi * s;
    w[2] = 0.5f * pi * pi * c;
  } else if (kernel == kLinear) {
    w[0] = t;
    w[1] = 1.0f;
    w[2] = 0.0f;
  } else {
    w[0] = t * t * (3.0f - 2.0f * t);
    w[1] = 6.0f * t * (1.0f - t);
    w[2] = 6.0f - 12.0f * t;
  }
}

__device__ __forceinline__ AxisTable axis_table(float coord, int size,
                                                float offset,
                                                const SamplerParams& p) {
  float mult;
  const float x = source_coord(coord, size, offset, p, &mult);
  const float fx = floorf(x);
  float w[3];
  kernel_weights(p.kernel, __fsub_rn(x, fx), w);
  AxisTable a;
  a.i0 = static_cast<int>(fx);
  a.w[0][0] = 1.0f - w[0];
  a.w[0][1] = w[0];
  a.w[1][0] = -w[1] * mult;
  a.w[1][1] = w[1] * mult;
  const float mult2 = mult * mult;
  a.w[2][0] = -w[2] * mult2;
  a.w[2][1] = w[2] * mult2;
  return a;
}

// w^(k)(t) for any k >= 0 (ops/interpolants.py kernel_weight).  Cosine:
// w^(k) = -(pi^k / 2) cos(pi t + k pi / 2), expanded by k mod 4 from one
// sincospif; linear is 0 for k >= 2; smoothstep is -12 at k = 3 and 0
// above.  The amplitude 0.5 pi^k is built as 0.5 * pi * pi ... in f32, the
// order kernel_weights uses for k = 1, 2.
__device__ __forceinline__ float kernel_weight(int kernel, float t, int k) {
  if (kernel == kCosine) {
    float s, c;
    sincospif(t, &s, &c);
    if (k == 0) return 0.5f * (1.0f - c);
    const float pi = 3.14159265358979323846f;
    float amp = 0.5f;
    for (int i = 0; i < k; ++i) amp *= pi;
    switch (k & 3) {
      case 1: return amp * s;
      case 2: return amp * c;
      case 3: return -amp * s;
      default: return -amp * c;
    }
  }
  if (kernel == kLinear) return k == 0 ? t : (k == 1 ? 1.0f : 0.0f);
  switch (k) {
    case 0: return t * t * (3.0f - 2.0f * t);
    case 1: return 6.0f * t * (1.0f - t);
    case 2: return 6.0f - 12.0f * t;
    case 3: return -12.0f;
    default: return 0.0f;
  }
}

// One grid axis at derivative order k: the floor corner index and the
// corner weights, (1 - w, w) at order 0 and (-w^(k), w^(k)) * mult^k
// above it (ops/generic.py _per_axis_tables).
struct AxisWeights {
  int i0;
  float w0;  // floor corner
  float w1;  // ceil corner
};

__device__ __forceinline__ AxisWeights axis_weights(float coord, int size,
                                                    float offset, int k,
                                                    const SamplerParams& p) {
  float mult;
  const float x = source_coord(coord, size, offset, p, &mult);
  const float fx = floorf(x);
  const float wk = kernel_weight(p.kernel, __fsub_rn(x, fx), k);
  AxisWeights a;
  // clamped first, as the TPU kernels do: a far out-of-bounds query keeps
  // both corners out of bounds without overflowing the int
  a.i0 = static_cast<int>(fminf(fmaxf(fx, -2.0f), size + 1.0f));
  if (k == 0) {
    a.w0 = 1.0f - wk;
    a.w1 = wk;
  } else {
    float scale = mult;
    for (int i = 1; i < k; ++i) scale *= mult;
    a.w0 = -wk * scale;
    a.w1 = wk * scale;
  }
  return a;
}

// The five fused rows (value, d/dx, d/dy, d2/dx2, d2/dy2) as
// (x order, y order), the row order of the JAX package's fused ops.
__device__ __forceinline__ void row_weights(const AxisTable& ax,
                                            const AxisTable& ay, int cx,
                                            int cy, float wr[5]) {
  wr[0] = ax.w[0][cx] * ay.w[0][cy];
  wr[1] = ax.w[1][cx] * ay.w[0][cy];
  wr[2] = ax.w[0][cx] * ay.w[1][cy];
  wr[3] = ax.w[2][cx] * ay.w[0][cy];
  wr[4] = ax.w[0][cx] * ay.w[2][cy];
}

}  // namespace csm
