// cas_math.cuh — the FFX CAS per-pixel math of cas_upscale.cu and
// cas_sharpen.cu.
//
// Replaces, for the CUDA port, the device math the TPU kernels
// openvr_fsr_tpu/kernels/cas.py::build_cas_upscale / build_cas_sharpen take
// from openvr_fsr_tpu/ops/cas.py (cas_upscale_core, cas_core). Every
// function is f32 op for op the NumPy oracle (openvr_fsr_tpu/oracle/cas.py)
// and the plain torch ops (openvr_fsr_tpu_torch/ops/cas.py), so the output
// bits match when built with --fmad=false and without --use_fast_math.
#pragma once

#include <cstdint>

#include "ffx_math.cuh"

namespace cas {

using ffx::max3;
using ffx::max_nan;
using ffx::min3;
using ffx::min_nan;
using ffx::sat;

// APrxLoSqrtF1 (ffx_a.h:1455): bitcast((bits(a) >> 1) + 0x1fbc4639), the
// shift logical.
__device__ __forceinline__ float aprx_lo_sqrt(float a) {
  return __uint_as_float((__float_as_uint(a) >> 1) + 0x1fbc4639u);
}

// CasFilter noScaling (ffx_cas.h:430-552; ops/cas.py::cas_core) with
// CAS_BETTER_DIAGONALS, green-coefficient weights and the maxColorDelta
// clamp. t[r][q][c]: the 3x3 taps, row r = dy + 1, column q = dx + 1,
// channel c, out-of-image taps 0. Writes the RGB.
__device__ __forceinline__ void sharpen(const float t[3][3][3], float sharp, float mcd,
                                        float out[3]) {
  constexpr int G = 1;
  const float a = t[0][0][G], b = t[0][1][G], c = t[0][2][G];
  const float d = t[1][0][G], e = t[1][1][G], f = t[1][2][G];
  const float g = t[2][0][G], h = t[2][1][G], i = t[2][2][G];
  float mn = min_nan(min3(d, e, f), min_nan(b, h));
  mn = mn + min_nan(min3(mn, a, c), min_nan(g, i));
  float mx = max_nan(max3(d, e, f), max_nan(b, h));
  mx = mx + max_nan(max3(mx, a, c), max_nan(g, i));
  const float amp = aprx_lo_sqrt(sat(min_nan(mn, 2.0f - mx) * ffx::aprx_lo_rcp(mx)));
  const float w = amp * sharp;
  const float rcp_weight = ffx::aprx_med_rcp(1.0f + 4.0f * w);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ec = t[1][1][ch];
    const float pix =
        sat((t[0][1][ch] * w + t[1][0][ch] * w + t[1][2][ch] * w + t[2][1][ch] * w + ec) *
            rcp_weight);
    out[ch] = min_nan(max_nan(pix, ec - mcd), ec + mcd);
  }
}

// The green 5-tap cross soft min / max of the scaling path.
__device__ __forceinline__ void soft_g(float up, float lf, float ce, float rt, float dn, float& mn,
                                       float& mx) {
  mn = min_nan(min3(up, lf, ce), min_nan(rt, dn));
  mx = max_nan(max3(up, lf, ce), max_nan(rt, dn));
}

__device__ __forceinline__ float weight(float mn, float mx, float sharp) {
  return aprx_lo_sqrt(sat(min_nan(mn, 1.0f - mx) * ffx::aprx_lo_rcp(mx))) * sharp;
}

// CasFilter scaling (ffx_cas.h:552-892; ops/cas.py::cas_upscale_core) with
// the mod's upscale flags: no CAS_BETTER_DIAGONALS, no maxColorDelta clamp.
// p[r][q][c]: the 4x4 window around floor(pp), row r = dy + 1, column
// q = dx + 1 (dx, dy in -1..2), channel c, out-of-image taps 0; the corners
// are not read. ppx / ppy: the fractions of pp. Writes the RGB.
__device__ __forceinline__ void upscale(const float p[4][4][3], float ppx, float ppy, float sharp,
                                        float out[3]) {
  constexpr int G = 1;
  // the letters of ffx_cas.h:573-587 (rows abcd / efgh / ijkl / mnop)
  const float(&b)[3] = p[0][1], (&c)[3] = p[0][2];
  const float(&e)[3] = p[1][0], (&f)[3] = p[1][1], (&g)[3] = p[1][2], (&h)[3] = p[1][3];
  const float(&i)[3] = p[2][0], (&j)[3] = p[2][1], (&k)[3] = p[2][2], (&l)[3] = p[2][3];
  const float(&n)[3] = p[3][1], (&o)[3] = p[3][2];

  float mnf, mxf, mng, mxg, mnj, mxj, mnk, mxk;
  soft_g(b[G], e[G], f[G], g[G], j[G], mnf, mxf);
  soft_g(c[G], f[G], g[G], h[G], k[G], mng, mxg);
  soft_g(f[G], i[G], j[G], k[G], n[G], mnj, mxj);
  soft_g(g[G], j[G], k[G], l[G], o[G], mnk, mxk);
  const float wf = weight(mnf, mxf, sharp), wg = weight(mng, mxg, sharp);
  const float wj = weight(mnj, mxj, sharp), wk = weight(mnk, mxk, sharp);

  float s = (1.0f - ppx) * (1.0f - ppy);
  float t = ppx * (1.0f - ppy);
  float u = (1.0f - ppx) * ppy;
  float v = ppx * ppy;
  constexpr float kThin = 1.0f / 32.0f;
  s = s * ffx::aprx_lo_rcp(kThin + (mxf - mnf));
  t = t * ffx::aprx_lo_rcp(kThin + (mxg - mng));
  u = u * ffx::aprx_lo_rcp(kThin + (mxj - mnj));
  v = v * ffx::aprx_lo_rcp(kThin + (mxk - mnk));

  const float qbe = wf * s;
  const float qch = wg * t;
  const float qf = wg * t + wj * u + s;
  const float qg = wf * s + wk * v + t;
  const float qj = wf * s + wk * v + u;
  const float qk = wg * t + wj * u + v;
  const float qin = wj * u;
  const float qlo = wk * v;
  const float rcp_w = ffx::aprx_med_rcp(2.0f * qbe + 2.0f * qch + 2.0f * qin + 2.0f * qlo + qf +
                                        qg + qj + qk);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = sat((b[ch] * qbe + e[ch] * qbe + c[ch] * qch + h[ch] * qch + i[ch] * qin +
                   n[ch] * qin + l[ch] * qlo + o[ch] * qlo + f[ch] * qf + g[ch] * qg +
                   j[ch] * qj + k[ch] * qk) *
                  rcp_w);
}

}  // namespace cas
