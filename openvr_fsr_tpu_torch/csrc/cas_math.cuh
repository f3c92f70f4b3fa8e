// cas_math.cuh — the FFX CAS per-pixel math of cas_upscale.cu and
// cas_sharpen.cu.
//
// Replaces, for the CUDA port, the device math the TPU kernels
// openvr_fsr_tpu/kernels/cas.py::build_cas_upscale / build_cas_sharpen take
// from openvr_fsr_tpu/ops/cas.py (cas_upscale_core, cas_core). Every
// function is f32 op for op the NumPy oracle (openvr_fsr_tpu/oracle/cas.py)
// and the plain torch ops (openvr_fsr_tpu_torch/ops/cas.py), so the output
// bits match when built with --fmad=false and without --use_fast_math.
// Both filters are templates on the working precision P of ffx_math.cuh
// (ffx::Full, ffx::Half: the JAX package's dt=bfloat16 cas_core and
// cas_upscale_core, P::r on every op they compute in bf16); the caller hands
// them taps, fractions and constants already in P.
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
// channel c, out-of-image taps 0. Writes the RGB, in P.
template <class P>
__device__ __forceinline__ void sharpen(const float t[3][3][3], float sharp, float mcd,
                                        float out[3]) {
  constexpr int G = 1;
  const float a = t[0][0][G], b = t[0][1][G], c = t[0][2][G];
  const float d = t[1][0][G], e = t[1][1][G], f = t[1][2][G];
  const float g = t[2][0][G], h = t[2][1][G], i = t[2][2][G];
  float mn = min_nan(min3(d, e, f), min_nan(b, h));
  mn = P::r(mn + min_nan(min3(mn, a, c), min_nan(g, i)));
  float mx = max_nan(max3(d, e, f), max_nan(b, h));
  mx = P::r(mx + max_nan(max3(mx, a, c), max_nan(g, i)));
  const float amp = P::r(
      aprx_lo_sqrt(sat(P::r(min_nan(mn, P::r(2.0f - mx)) * P::r(ffx::aprx_lo_rcp(mx))))));
  const float w = P::r(amp * sharp);
  const float rcp_weight = P::r(ffx::aprx_med_rcp(P::r(1.0f + P::r(4.0f * w))));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ec = t[1][1][ch];
    float acc = P::r(P::r(t[0][1][ch] * w) + P::r(t[1][0][ch] * w));
    acc = P::r(acc + P::r(t[1][2][ch] * w));
    acc = P::r(acc + P::r(t[2][1][ch] * w));
    const float pix = sat(P::r(P::r(acc + ec) * rcp_weight));
    out[ch] = min_nan(max_nan(pix, P::r(ec - mcd)), P::r(ec + mcd));
  }
}

// The green 5-tap cross soft min / max of the scaling path.
__device__ __forceinline__ void soft_g(float up, float lf, float ce, float rt, float dn, float& mn,
                                       float& mx) {
  mn = min_nan(min3(up, lf, ce), min_nan(rt, dn));
  mx = max_nan(max3(up, lf, ce), max_nan(rt, dn));
}

template <class P>
__device__ __forceinline__ float weight(float mn, float mx, float sharp) {
  return P::r(
      P::r(aprx_lo_sqrt(sat(P::r(min_nan(mn, P::r(1.0f - mx)) * P::r(ffx::aprx_lo_rcp(mx)))))) *
      sharp);
}

// CasFilter scaling (ffx_cas.h:552-892; ops/cas.py::cas_upscale_core) with
// the mod's upscale flags: no CAS_BETTER_DIAGONALS, no maxColorDelta clamp.
// p[r][q][c]: the 4x4 window around floor(pp), row r = dy + 1, column
// q = dx + 1 (dx, dy in -1..2), channel c, out-of-image taps 0; the corners
// are not read. ppx / ppy: the fractions of pp. Writes the RGB, in P.
template <class P>
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
  const float wf = weight<P>(mnf, mxf, sharp), wg = weight<P>(mng, mxg, sharp);
  const float wj = weight<P>(mnj, mxj, sharp), wk = weight<P>(mnk, mxk, sharp);

  const float nx = P::r(1.0f - ppx), ny = P::r(1.0f - ppy);
  float s = P::r(nx * ny);
  float t = P::r(ppx * ny);
  float u = P::r(nx * ppy);
  float v = P::r(ppx * ppy);
  constexpr float kThin = 1.0f / 32.0f;
  s = P::r(s * P::r(ffx::aprx_lo_rcp(P::r(kThin + P::r(mxf - mnf)))));
  t = P::r(t * P::r(ffx::aprx_lo_rcp(P::r(kThin + P::r(mxg - mng)))));
  u = P::r(u * P::r(ffx::aprx_lo_rcp(P::r(kThin + P::r(mxj - mnj)))));
  v = P::r(v * P::r(ffx::aprx_lo_rcp(P::r(kThin + P::r(mxk - mnk)))));

  const float ws = P::r(wf * s), wt = P::r(wg * t), wu = P::r(wj * u), wv = P::r(wk * v);
  const float qbe = ws;
  const float qch = wt;
  const float qf = P::r(P::r(wt + wu) + s);
  const float qg = P::r(P::r(ws + wv) + t);
  const float qj = P::r(P::r(ws + wv) + u);
  const float qk = P::r(P::r(wt + wu) + v);
  const float qin = wu;
  const float qlo = wv;
  float sum = P::r(P::r(2.0f * qbe) + P::r(2.0f * qch));
  sum = P::r(sum + P::r(2.0f * qin));
  sum = P::r(sum + P::r(2.0f * qlo));
  sum = P::r(P::r(P::r(P::r(sum + qf) + qg) + qj) + qk);
  const float rcp_w = P::r(ffx::aprx_med_rcp(sum));
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {   // the sum in the order of ops/cas.py
    float acc = P::r(P::r(b[ch] * qbe) + P::r(e[ch] * qbe));
    acc = P::r(acc + P::r(c[ch] * qch));
    acc = P::r(acc + P::r(h[ch] * qch));
    acc = P::r(acc + P::r(i[ch] * qin));
    acc = P::r(acc + P::r(n[ch] * qin));
    acc = P::r(acc + P::r(l[ch] * qlo));
    acc = P::r(acc + P::r(o[ch] * qlo));
    acc = P::r(acc + P::r(f[ch] * qf));
    acc = P::r(acc + P::r(g[ch] * qg));
    acc = P::r(acc + P::r(j[ch] * qj));
    acc = P::r(acc + P::r(k[ch] * qk));
    out[ch] = sat(P::r(acc * rcp_w));
  }
}

}  // namespace cas
