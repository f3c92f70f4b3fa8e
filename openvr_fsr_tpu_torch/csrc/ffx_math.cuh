// ffx_math.cuh — the FSR1 per-pixel math of the fused kernel (fsr_fused.cu).
//
// Replaces, for the CUDA port, the device math the TPU kernel
// openvr_fsr_tpu/kernels/fsr.py::build_fsr_fused takes from
// openvr_fsr_tpu/ops/common.py (ffx_a.h intrinsics), ops/easu.py
// (easu_core_split), ops/rcas.py (rcas_core) and ops/bilinear.py. Every
// function is f32 op for op the NumPy oracle (openvr_fsr_tpu/oracle/) and
// the plain torch ops (openvr_fsr_tpu_torch/ops/), so the output bits match
// when the file is built with --fmad=false (no mul+add contraction) and
// without --use_fast_math (IEEE division, no flush to zero).
//
// EASU and RCAS are templates on a working precision P (precision="half",
// the JAX package's dt=bfloat16 cores): P::r(x) is applied to the result of
// every op the JAX half core computes in bf16, and nowhere else.
//   Full  r is the identity: the f32 code, whose instantiation compiles to
//         what the functions compiled to before they were templates.
//   Half  r rounds the f32 result to bf16 (round to nearest even,
//         __float2bfloat16_rn) and widens it back. For bf16 operands the f32
//         add, sub and mul followed by that rounding give the bf16 op's bits
//         (f32 holds more than 2 x 8 + 2 significant bits), which is what the
//         JAX package computes op by op and torch's eager bf16 ops compute
//         (ops/*.py at dt=bf16). The ffx_a.h approximations and rcp run on
//         the f32 value and are rounded after (the JAX package's via_f32);
//         compares, min, max and selects are exact on bf16 values.
// The caller hands the functions their inputs already in P (rounded once).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ffx {

struct Full {
  static constexpr bool kHalf = false;
  static __device__ __forceinline__ float r(float x) { return x; }
  // the FsrEasuTapF / FsrEasuF literals in the working type
  static constexpr float kEasuWB = static_cast<float>(2.0 / 5.0);
  static constexpr float kEasuLob = static_cast<float>((1.0 / 4.0 - 0.04) - 0.5);
};
struct Half {
  static constexpr bool kHalf = true;
  static __device__ __forceinline__ float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static constexpr float kEasuWB = 0.400390625f;   // bf16(2/5)
  static constexpr float kEasuLob = -0.2890625f;   // bf16(0.21 - 0.5)
};

// jnp.minimum / jnp.maximum / torch.minimum: a NaN in either operand
// propagates. CUDA fminf/fmaxf drop it, so they are not used.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// D3D min/max: x < y ? x : y — a NaN in x selects y (ops/common.py:97-104).
__device__ __forceinline__ float hlsl_min(float x, float y) { return x < y ? x : y; }
__device__ __forceinline__ float hlsl_max(float x, float y) { return x > y ? x : y; }
__device__ __forceinline__ float min3(float x, float y, float z) {
  return min_nan(x, min_nan(y, z));
}
__device__ __forceinline__ float max3(float x, float y, float z) {
  return max_nan(x, max_nan(y, z));
}
// ASatF1 with NaN propagation (__saturatef(NaN) would give 0).
__device__ __forceinline__ float sat(float a) { return min_nan(1.0f, max_nan(0.0f, a)); }
// ARcpF1: the correctly rounded reciprocal.
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
// ffx_a.h:1842-1845 magic-constant approximations on the f32 bits.
__device__ __forceinline__ float aprx_lo_rcp(float a) {
  return __uint_as_float(0x7ef07ebbu - __float_as_uint(a));
}
__device__ __forceinline__ float aprx_med_rcp(float a) {
  const float b = __uint_as_float(0x7ef19fffu - __float_as_uint(a));
  return b * (-(b * a) + 2.0f);
}
__device__ __forceinline__ float aprx_lo_rsq(float a) {  // logical shift
  return __uint_as_float(0x5f347d74u - (__float_as_uint(a) >> 1));
}

// UNORM8: clamp, scale, round half to even; the decode multiplies by the
// f32 reciprocal (api/pipeline.py:501-505, utils/frames.py).
constexpr float kInv255 = 1.0f / 255.0f;
__device__ __forceinline__ float unorm8_round(float v) { return rintf(sat(v) * 255.0f); }
__device__ __forceinline__ float unorm8_roundtrip(float v) { return unorm8_round(v) * kInv255; }
// UNORM10 (R10G10B10A2's colour) and UNORM2 (its alpha), the same way.
constexpr float kInv1023 = 1.0f / 1023.0f;
constexpr float kInv3 = 1.0f / 3.0f;
__device__ __forceinline__ float unorm10_round(float v) { return rintf(sat(v) * 1023.0f); }
__device__ __forceinline__ float unorm10_roundtrip(float v) { return unorm10_round(v) * kInv1023; }
__device__ __forceinline__ float unorm2_round(float v) { return rintf(sat(v) * 3.0f); }

// The 12 EASU taps in the FsrEasuF accumulation order (ffx_fsr1.h:423-434;
// ops/easu.py TAP_ORDER): b c i j f e k l h g o n. Tap k's offset + 1 is the
// k-th 2-bit field of a packed constant (scalars fold in unrolled loops,
// where a namespace-scope array would not be visible to device code):
//   dx = 0, 1, -1, 0, 0, -1, 1, 2, 2, 1, 1, 0
//   dy = -1, -1, 1, 1, 0, 0, 1, 1, 0, 0, 2, 2
enum Tap { TB, TC, TI, TJ, TF, TE, TK, TL, TH, TG, TO, TN };
__device__ __forceinline__ int tap_dx(int k) { return static_cast<int>((0x6be149u >> (2 * k)) & 3u) - 1; }
__device__ __forceinline__ int tap_dy(int k) { return static_cast<int>((0xf5a5a0u >> (2 * k)) & 3u) - 1; }

// FsrEasuSetF (ffx_fsr1.h:275-313), in the op order of ops/easu.py. In P
// Half, lenX / lenY turn f32 at sat (the JAX package's f32 literals), and so
// does the length sum after them.
template <class P>
__device__ __forceinline__ void easu_set(float& dir_x, float& dir_y, float& len, float w,
                                         float lA, float lB, float lC, float lD, float lE) {
  const float dc = P::r(lD - lC);
  const float cb = P::r(lC - lB);
  float lenX = P::r(aprx_lo_rcp(max_nan(fabsf(dc), fabsf(cb))));
  const float dirX = P::r(lD - lB);
  dir_x = P::r(dir_x + P::r(dirX * w));
  lenX = sat(P::r(fabsf(dirX) * lenX));
  len = len + (lenX * lenX) * w;
  const float ec = P::r(lE - lC);
  const float ca = P::r(lC - lA);
  float lenY = P::r(aprx_lo_rcp(max_nan(fabsf(ec), fabsf(ca))));
  const float dirY = P::r(lE - lA);
  dir_y = P::r(dir_y + P::r(dirY * w));
  lenY = sat(P::r(fabsf(dirY) * lenY));
  len = len + (lenY * lenY) * w;
}

// FsrEasuF after the gather (ffx_fsr1.h:363-437). t[k][c]: tap k (in
// kTapDx/kTapDy order), channel c, decoded to [0, 1]. ppx/ppy: the
// fractional sample position. t, ppx and ppy in P. Writes the dering-clamped
// RGB (f32 in either P: in Half the stretch and lobe terms, the tap weights
// and the sums are f32, as in the JAX half core).
template <class P>
__device__ __forceinline__ void easu(const float t[12][3], float ppx, float ppy, float out[3]) {
  float L[12];
#pragma unroll
  for (int k = 0; k < 12; ++k)
    L[k] = P::r(P::r(t[k][2] * 0.5f) + P::r(P::r(t[k][0] * 0.5f) + t[k][1]));

  const float nx = P::r(1.0f - ppx), ny = P::r(1.0f - ppy);
  float dir_x = 0.0f, dir_y = 0.0f, len = 0.0f;
  easu_set<P>(dir_x, dir_y, len, P::r(nx * ny), L[TB], L[TE], L[TF], L[TG], L[TJ]);
  easu_set<P>(dir_x, dir_y, len, P::r(ppx * ny), L[TC], L[TF], L[TG], L[TH], L[TK]);
  easu_set<P>(dir_x, dir_y, len, P::r(nx * ppy), L[TF], L[TI], L[TJ], L[TK], L[TN]);
  easu_set<P>(dir_x, dir_y, len, P::r(ppx * ppy), L[TG], L[TJ], L[TK], L[TL], L[TO]);

  float dirR = P::r(P::r(dir_x * dir_x) + P::r(dir_y * dir_y));
  const bool zro = dirR < 1.0f / 32768.0f;
  dirR = P::r(aprx_lo_rsq(dirR));
  dirR = zro ? 1.0f : dirR;
  dir_x = zro ? 1.0f : dir_x;
  dir_x = P::r(dir_x * dirR);
  dir_y = P::r(dir_y * dirR);

  len = len * 0.5f;
  len = len * len;
  const float stretch = P::r(P::r(P::r(dir_x * dir_x) + P::r(dir_y * dir_y)) *
                             P::r(aprx_lo_rcp(max_nan(fabsf(dir_x), fabsf(dir_y)))));
  const float len2_x = 1.0f + P::r(stretch - 1.0f) * len;
  const float len2_y = 1.0f + -0.5f * len;
  const float lob = 0.5f + P::kEasuLob * len;
  const float clp = P::r(aprx_lo_rcp(lob));

  // FsrEasuTapF (ffx_fsr1.h:239-272) with the per-offset products shared:
  // vx = off_x*dir_x + off_y*dir_y, vy = off_x*(-dir_y) + off_y*dir_x.
  const float ndir_y = -dir_y;
  float pvx_x[4], pvx_y[4], pvy_x[4], pvy_y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float offx = P::r(static_cast<float>(i - 1) - ppx);
    const float offy = P::r(static_cast<float>(i - 1) - ppy);
    pvx_x[i] = P::r(offx * dir_x);
    pvx_y[i] = P::r(offy * dir_y);
    pvy_x[i] = P::r(offx * ndir_y);
    pvy_y[i] = P::r(offy * dir_x);
  }

  float aC[3] = {0.0f, 0.0f, 0.0f};
  float aW = 0.0f;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int ix = tap_dx(k) + 1, iy = tap_dy(k) + 1;
    float vx = P::r(pvx_x[ix] + pvx_y[iy]);
    float vy = P::r(pvy_x[ix] + pvy_y[iy]);
    vx = vx * len2_x;
    vy = vy * len2_y;
    const float d2 = min_nan(vx * vx + vy * vy, clp);
    float wB = P::kEasuWB * d2 + -1.0f;
    float wA = lob * d2 + -1.0f;
    wB = wB * wB;
    wA = wA * wA;
    wB = static_cast<float>(25.0 / 16.0) * wB + static_cast<float>(-(25.0 / 16.0 - 1.0));
    const float w = wB * wA;
#pragma unroll
    for (int c = 0; c < 3; ++c) aC[c] = aC[c] + t[k][c] * w;
    aW = aW + w;
  }
  const float inv_w = P::r(rcp(aW));  // the resolve is aC * (1/aW) (ffx_fsr1.h:434)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = min_nan(min3(t[TF][c], t[TK][c], t[TJ][c]), t[TG][c]);
    const float mx4 = max_nan(max3(t[TF][c], t[TK][c], t[TJ][c]), t[TG][c]);
    out[c] = min_nan(mx4, max_nan(mn4, aC[c] * inv_w));
  }
}

// The out-of-radius linear-clamp fallback (fsr_easu.hlsl:33-36) in the lerp
// form of ops/bilinear.py:51-53: x first, then y.
__device__ __forceinline__ float bilerp(float c00, float c10, float c01, float c11,
                                        float fx, float fy) {
  const float top = c00 * (1.0f - fx) + c10 * fx;
  const float bot = c01 * (1.0f - fx) + c11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// FsrRcasF (ffx_fsr1.h:684-769; ops/rcas.py:38-86) on the five cross taps
// b (up), d (left), e (centre), f (right), h (down), in P; sharp in P (the
// host rounds it). Writes the result in P.
template <class P>
__device__ __forceinline__ void rcas(const float b[3], const float d[3], const float e[3],
                                     const float f[3], const float h[3], float sharp,
                                     float out[3]) {
  float lobe_c[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = min_nan(min3(b[c], d[c], f[c]), h[c]);
    const float mx4 = max_nan(max3(b[c], d[c], f[c]), h[c]);
    const float hit_min = P::r(mn4 * P::r(rcp(P::r(4.0f * mx4))));
    const float hit_max = P::r(P::r(1.0f - mx4) * P::r(rcp(P::r(P::r(4.0f * mn4) + -4.0f))));
    lobe_c[c] = hlsl_max(-hit_min, hit_max);
  }
  // In flat regions hit_min/hit_max are 0*inf = NaN: max3 carries the NaN
  // and the hlsl_min select swallows it (ops/rcas.py:64-72).
  constexpr float kRcasLimit = 0.25f - 1.0f / 16.0f;
  const float lobe =
      P::r(hlsl_max(-kRcasLimit, hlsl_min(max3(lobe_c[0], lobe_c[1], lobe_c[2]), 0.0f)) * sharp);
  const float rcp_l = P::r(aprx_med_rcp(P::r(P::r(4.0f * lobe) + 1.0f)));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = P::r(P::r(lobe * b[c]) + P::r(lobe * d[c]));
    acc = P::r(acc + P::r(lobe * h[c]));
    acc = P::r(acc + P::r(lobe * f[c]));
    out[c] = P::r(P::r(acc + e[c]) * rcp_l);
  }
}

}  // namespace ffx
