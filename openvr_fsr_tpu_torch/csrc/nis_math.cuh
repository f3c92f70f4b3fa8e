// nis_math.cuh — the NVIDIA Image Scaling per-pixel math of the NVSharpen
// (nis_sharpen.cu) and NVScaler (nis_scaler.cu) kernels.
//
// Replaces, for the CUDA port, the device math the TPU kernels
// openvr_fsr_tpu/kernels/nis.py::build_nvsharpen and build_nvscaler take
// from openvr_fsr_tpu/ops/nis.py (getY, the edge map, EvalPoly6, CalcLTI,
// EvalUSM, CalcLTIFast). Every function is f32 op for op the NumPy oracle
// (openvr_fsr_tpu/oracle/nis.py) and the plain torch ops
// (openvr_fsr_tpu_torch/ops/nis.py), so the output bits match when built
// with --fmad=false and without --use_fast_math (IEEE division and sqrtf).
// Minimum and maximum are the NaN-propagating ffx::min_nan / max_nan of
// torch.minimum / torch.maximum.
//
// The filters (lerp, EvalPoly6 with CalcLTI, EvalUSM with CalcLTIFast) are
// templates on the working precision P of ffx_math.cuh (ffx::Full,
// ffx::Half: the JAX package's dt=bfloat16 cores eval_poly6_core,
// _calc_lti_jax, _eval_usm_jax and _calc_lti_fast_jax): P::r on every op
// they compute in bf16, the division in IEEE f32 then P::r, their literals
// Lit<P>'s. The caller hands them taps, coefficients and the constants of
// the dt(cfg.k...) literals already in P (kernels/nis.py::_consts rounds
// those on the host). getY, the edge map and the combine stay f32.
#pragma once

#include <cstdint>

#include "ffx_math.cuh"

namespace nis {

// The NisConfig constants the kernels read (core/constants.py::
// nvscaler_update_config), computed on the host in f32 and passed in this
// order (kernels/nis.py::_consts).
struct Consts {
  float detect_ratio, detect_thres, min_contrast_ratio, ratio_norm, contrast_boost;
  float eps;          // kEps (CalcLTI)
  float eps_fast;     // kEps * f32(1/255) (CalcLTIFast)
  float sharp_start_y, sharp_scale_y, sharp_strength_min, sharp_strength_scale;
  float sharp_limit_min, sharp_limit_scale;
  float scaler_hdr_eps;   // NVScaler linear-HDR correction: f32(1e-4)
  float scaler_hdr_norm;  // 1 / (255 * kHDRCompressionFactor)
  float sharpen_hdr_eps;  // NVSharpen linear-HDR correction: 1e-4 * k * k
};
constexpr int kNumConsts = 16;
static_assert(sizeof(Consts) == kNumConsts * sizeof(float), "Consts is 16 packed floats");

constexpr float kHdrCompression = 0.282842712f;  // kHDRCompressionFactor (NIS_Scaler.h:118)

// The filters' literals in the working type: 1/255 and the USM profile
// taps 0.6001, 1.2002, as f32 (Full) or rounded to bf16 (Half, the JAX
// package's dt(1.0 / 255), dt(0.6001), dt(1.2002)).
template <class P>
struct Lit {
  static constexpr float inv255 = ffx::kInv255, usm_side = 0.6001f, usm_centre = 1.2002f;
};
template <>
struct Lit<ffx::Half> {
  static constexpr float inv255 = 0.003936767578125f, usm_side = 0.6015625f,
                         usm_centre = 1.203125f;
};

// HLSL lerp in its exact form a + s*(b-a).
template <class P = ffx::Full>
__device__ __forceinline__ float lerp(float a, float b, float s) {
  return P::r(a + P::r(s * P::r(b - a)));
}

// getYLinear (NIS_Scaler.h:171-174): BT.709 luma.
__device__ __forceinline__ float get_y_linear(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// getY (NIS_Scaler.h:160-169): 0 SDR BT.709, 1 linear HDR sqrt(luma)*k,
// 2 PQ with the Rec.2020 weights.
__device__ __forceinline__ float get_y(float r, float g, float b, int hdr_mode) {
  if (hdr_mode == 2) return 0.262f * r + 0.678f * g + 0.0593f * b;
  if (hdr_mode == 1) return sqrtf(get_y_linear(r, g, b)) * kHdrCompression;
  return get_y_linear(r, g, b);
}

__device__ __forceinline__ float min3(float a, float b, float c) {
  return ffx::min_nan(ffx::min_nan(a, b), c);
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  return ffx::max_nan(ffx::max_nan(a, b), c);
}

// GetEdgeMap (NIS_Scaler.h:176-293) on a 3x3 luma neighbourhood p[row][col]:
// the gradient sums in the reference's f32 order, then the weights
// w = {w0, w90, w45, w135}. The 0/90 ratio divides by a denominator that
// can be 0; it is computed anyway and selected away, as in the oracle.
__device__ __forceinline__ void edge_map(const float p[3][3], const Consts& k, float w[4]) {
  const float g0 = fabsf(p[0][0] + p[0][1] + p[0][2] - p[2][0] - p[2][1] - p[2][2]);
  const float g45 = fabsf(p[1][0] + p[0][0] + p[0][1] - p[2][1] - p[2][2] - p[1][2]);
  const float g90 = fabsf(p[0][0] + p[1][0] + p[2][0] - p[0][2] - p[1][2] - p[2][2]);
  const float g135 = fabsf(p[1][0] + p[2][0] + p[2][1] - p[0][1] - p[0][2] - p[1][2]);

  const float g090mx = ffx::max_nan(g0, g90), g090mn = ffx::min_nan(g0, g90);
  const float g45mx = ffx::max_nan(g45, g135), g45mn = ffx::min_nan(g45, g135);
  const float denom = g090mx + g45mx;
  const float ratio = g090mx / denom;
  const bool nonzero = denom != 0.0f;
  const float e090 = nonzero ? ffx::min_nan(ratio, 1.0f) : 0.0f;
  const float e45 = nonzero ? 1.0f - e090 : 0.0f;

  const bool c1 = g090mx > g090mn * k.detect_ratio && g090mx > k.detect_thres && g090mx > g45mn;
  const bool is0 = g090mx == g0;
  const float edge0 = (c1 && is0) ? 1.0f : 0.0f;
  const float edge90 = (c1 && !is0) ? 1.0f : 0.0f;
  const bool c2 = g45mx > g45mn * k.detect_ratio && g45mx > k.detect_thres && g45mx > g090mn;
  const bool is45 = g45mx == g45;
  const float edge45 = (c2 && is45) ? 1.0f : 0.0f;
  const float edge135 = (c2 && !is45) ? 1.0f : 0.0f;

  const float total = edge0 + edge90 + edge45 + edge135;
  const bool ge2 = total >= 2.0f, ge1 = total >= 1.0f;
  const bool e0_is1 = edge0 == 1.0f, e45_is1 = edge45 == 1.0f;
  w[0] = ge2 ? (e0_is1 ? e090 : 0.0f) : (ge1 ? edge0 : 0.0f);
  w[1] = ge2 ? (e0_is1 ? 0.0f : e090) : (ge1 ? edge90 : 0.0f);
  w[2] = ge2 ? (e45_is1 ? e45 : 0.0f) : (ge1 ? edge45 : 0.0f);
  w[3] = ge2 ? (e45_is1 ? 0.0f : e45) : (ge1 ? edge135 : 0.0f);
}

// The tail CalcLTI and CalcLTIFast share: contrast ratio of the two 3-tap
// windows -> local-transient weight.
template <class P>
__device__ __forceinline__ float lti_tail(float a_cont, float b_cont, float eps, const Consts& k) {
  const float ratio =
      P::r(ffx::max_nan(a_cont, b_cont) / P::r(ffx::min_nan(a_cont, b_cont) + eps));
  return P::r(P::r(1.0f - ffx::sat(P::r(P::r(ratio - k.min_contrast_ratio) * k.ratio_norm))) *
              k.contrast_boost);
}

// CalcLTI (NIS_Scaler.h:343-375): the 5-tap window starts at tap 0 when the
// phase is <= 32 (lo), else at tap 1.
template <class P>
__device__ __forceinline__ float calc_lti(const float p6[6], bool lo, const Consts& k) {
  float y[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = lo ? p6[i] : p6[i + 1];
  const float a_cont = P::r(max3(y[0], y[1], y[2]) - min3(y[0], y[1], y[2]));
  const float b_cont = P::r(max3(y[2], y[3], y[4]) - min3(y[2], y[3], y[4]));
  return lti_tail<P>(a_cont, b_cont, k.eps, k);
}

// EvalPoly6 (NIS_Scaler.h:399-434): px the 6 scaled lumas along one
// direction; cs / cu the COEF_SCALE / COEF_USM rows at the phase.
template <class P>
__device__ __forceinline__ float eval_poly6(const float px[6], const float* cs, const float* cu,
                                            bool lo, const Consts& k) {
  float y = P::r(cs[0] * px[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) y = P::r(y + P::r(cs[i] * px[i]));
  float y_usm = P::r(cu[0] * px[0]);
#pragma unroll
  for (int i = 1; i < 6; ++i) y_usm = P::r(y_usm + P::r(cu[i] * px[i]));
  const float y_scale = P::r(
      1.0f - ffx::sat(P::r(P::r(P::r(y * Lit<P>::inv255) - k.sharp_start_y) * k.sharp_scale_y)));
  const float y_sharpness = P::r(P::r(y_scale * k.sharp_strength_scale) + k.sharp_strength_min);
  y_usm = P::r(y_usm * y_sharpness);
  const float y_limit = P::r(P::r(P::r(y_scale * k.sharp_limit_scale) + k.sharp_limit_min) * y);
  y_usm = ffx::min_nan(y_limit, ffx::max_nan(-y_limit, y_usm));
  y_usm = P::r(y_usm * calc_lti<P>(px, lo, k));
  return P::r(y + y_usm);
}

// CalcLTIFast (NIS_Scaler.h:790-803) on 5 unscaled lumas.
template <class P>
__device__ __forceinline__ float calc_lti_fast(const float y[5], const Consts& k) {
  const float a_cont = P::r(max3(y[0], y[1], y[2]) - min3(y[0], y[1], y[2]));
  const float b_cont = P::r(max3(y[2], y[3], y[4]) - min3(y[2], y[3], y[4]));
  return lti_tail<P>(a_cont, b_cont, k.eps_fast, k);
}

// EvalUSM (NIS_Scaler.h:805-817): the fixed [-0.6001, 1.2002, -0.6001]
// profile, limited and LTI-weighted.
template <class P>
__device__ __forceinline__ float eval_usm(const float y[5], float strength, float limit,
                                          const Consts& k) {
  float y_usm = P::r(P::r(P::r(-Lit<P>::usm_side * y[1]) + P::r(Lit<P>::usm_centre * y[2])) -
                     P::r(Lit<P>::usm_side * y[3]));
  y_usm = P::r(y_usm * strength);
  y_usm = ffx::min_nan(limit, ffx::max_nan(-limit, y_usm));
  return P::r(y_usm * calc_lti_fast<P>(y, k));
}

}  // namespace nis
