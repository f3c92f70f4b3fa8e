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
#pragma once

#include <cstdint>

namespace ffx {

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

// FsrEasuSetF (ffx_fsr1.h:275-313), in the op order of ops/easu.py.
__device__ __forceinline__ void easu_set(float& dir_x, float& dir_y, float& len, float w,
                                         float lA, float lB, float lC, float lD, float lE) {
  const float dc = lD - lC;
  const float cb = lC - lB;
  float lenX = aprx_lo_rcp(max_nan(fabsf(dc), fabsf(cb)));
  const float dirX = lD - lB;
  dir_x = dir_x + dirX * w;
  lenX = sat(fabsf(dirX) * lenX);
  len = len + (lenX * lenX) * w;
  const float ec = lE - lC;
  const float ca = lC - lA;
  float lenY = aprx_lo_rcp(max_nan(fabsf(ec), fabsf(ca)));
  const float dirY = lE - lA;
  dir_y = dir_y + dirY * w;
  lenY = sat(fabsf(dirY) * lenY);
  len = len + (lenY * lenY) * w;
}

// FsrEasuF after the gather (ffx_fsr1.h:363-437). t[k][c]: tap k (in
// kTapDx/kTapDy order), channel c, decoded to [0, 1]. ppx/ppy: the
// fractional sample position. Writes the dering-clamped RGB.
__device__ __forceinline__ void easu(const float t[12][3], float ppx, float ppy, float out[3]) {
  float L[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) L[k] = t[k][2] * 0.5f + (t[k][0] * 0.5f + t[k][1]);

  float dir_x = 0.0f, dir_y = 0.0f, len = 0.0f;
  easu_set(dir_x, dir_y, len, (1.0f - ppx) * (1.0f - ppy), L[TB], L[TE], L[TF], L[TG], L[TJ]);
  easu_set(dir_x, dir_y, len, ppx * (1.0f - ppy), L[TC], L[TF], L[TG], L[TH], L[TK]);
  easu_set(dir_x, dir_y, len, (1.0f - ppx) * ppy, L[TF], L[TI], L[TJ], L[TK], L[TN]);
  easu_set(dir_x, dir_y, len, ppx * ppy, L[TG], L[TJ], L[TK], L[TL], L[TO]);

  float dirR = dir_x * dir_x + dir_y * dir_y;
  const bool zro = dirR < 1.0f / 32768.0f;
  dirR = aprx_lo_rsq(dirR);
  dirR = zro ? 1.0f : dirR;
  dir_x = zro ? 1.0f : dir_x;
  dir_x = dir_x * dirR;
  dir_y = dir_y * dirR;

  len = len * 0.5f;
  len = len * len;
  const float stretch =
      (dir_x * dir_x + dir_y * dir_y) * aprx_lo_rcp(max_nan(fabsf(dir_x), fabsf(dir_y)));
  const float len2_x = 1.0f + (stretch - 1.0f) * len;
  const float len2_y = 1.0f + -0.5f * len;
  const float lob = 0.5f + static_cast<float>((1.0 / 4.0 - 0.04) - 0.5) * len;
  const float clp = aprx_lo_rcp(lob);

  // FsrEasuTapF (ffx_fsr1.h:239-272) with the per-offset products shared:
  // vx = off_x*dir_x + off_y*dir_y, vy = off_x*(-dir_y) + off_y*dir_x.
  const float ndir_y = -dir_y;
  float pvx_x[4], pvx_y[4], pvy_x[4], pvy_y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float offx = static_cast<float>(i - 1) - ppx;
    const float offy = static_cast<float>(i - 1) - ppy;
    pvx_x[i] = offx * dir_x;
    pvx_y[i] = offy * dir_y;
    pvy_x[i] = offx * ndir_y;
    pvy_y[i] = offy * dir_x;
  }

  float aC[3] = {0.0f, 0.0f, 0.0f};
  float aW = 0.0f;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int ix = tap_dx(k) + 1, iy = tap_dy(k) + 1;
    float vx = pvx_x[ix] + pvx_y[iy];
    float vy = pvy_x[ix] + pvy_y[iy];
    vx = vx * len2_x;
    vy = vy * len2_y;
    const float d2 = min_nan(vx * vx + vy * vy, clp);
    float wB = static_cast<float>(2.0 / 5.0) * d2 + -1.0f;
    float wA = lob * d2 + -1.0f;
    wB = wB * wB;
    wA = wA * wA;
    wB = static_cast<float>(25.0 / 16.0) * wB + static_cast<float>(-(25.0 / 16.0 - 1.0));
    const float w = wB * wA;
#pragma unroll
    for (int c = 0; c < 3; ++c) aC[c] = aC[c] + t[k][c] * w;
    aW = aW + w;
  }
  const float inv_w = rcp(aW);  // the resolve is aC * (1/aW) (ffx_fsr1.h:434)
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
// b (up), d (left), e (centre), f (right), h (down).
__device__ __forceinline__ void rcas(const float b[3], const float d[3], const float e[3],
                                     const float f[3], const float h[3], float sharp,
                                     float out[3]) {
  float lobe_c[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = min_nan(min3(b[c], d[c], f[c]), h[c]);
    const float mx4 = max_nan(max3(b[c], d[c], f[c]), h[c]);
    const float hit_min = mn4 * rcp(4.0f * mx4);
    const float hit_max = (1.0f - mx4) * rcp(4.0f * mn4 + -4.0f);
    lobe_c[c] = hlsl_max(-hit_min, hit_max);
  }
  // In flat regions hit_min/hit_max are 0*inf = NaN: max3 carries the NaN
  // and the hlsl_min select swallows it (ops/rcas.py:64-72).
  constexpr float kRcasLimit = 0.25f - 1.0f / 16.0f;
  const float lobe =
      hlsl_max(-kRcasLimit, hlsl_min(max3(lobe_c[0], lobe_c[1], lobe_c[2]), 0.0f)) * sharp;
  const float rcp_l = aprx_med_rcp(4.0f * lobe + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = (lobe * b[c] + lobe * d[c] + lobe * h[c] + lobe * f[c] + e[c]) * rcp_l;
}

}  // namespace ffx
