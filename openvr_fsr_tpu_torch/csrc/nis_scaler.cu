// nis_scaler.cu — NVIDIA Image Scaling NVScaler (NIS upscale) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/nis.py::build_nvscaler
// (pallas_call at :1120): NVScaler (NIS_Scaler.h:589-770) with HDR modes
// 0/1/2. Per output pixel: the 6x6 edge-clamped scaled-luma support around
// the source position, FilterNormal (column sums, then the row sum), the
// four directional EvalPoly6 filters over the 64-phase COEF_SCALE /
// COEF_USM tables with CalcLTI, the edge-map weights of the 2x2 source
// pixels interpolated by the fractions, and the bilinear RGBA tap at
// ((x+0.5)/OW, (y+0.5)/OH) with the additive (SDR, PQ) or multiplicative
// (linear HDR) luma correction; alpha is the tap's. Outside the foveation
// circle (32x24 blocks, NIS_Upscale.hlsl:95-107) the DirectCopy fallback
// writes the bilinear tap at (x/OW, y/OH) times the debug tint with alpha 1
// (api/pipeline.py:428-434). Stored as packed RGBA8.
//
// What bounds it: inside the circle, the per-pixel math (about a thousand
// f32 ops: 4 EvalPoly6 with their LTI, FilterNormal, the interpolation
// trees); outside, the bytes (at the shipped geometry one stereo pair reads
// 25.2 MB and writes 44.7 MB). The simple design follows the reference's
// two phases: one CTA of 256 threads per 32x24 output block and batch entry
// stages the block's luma footprint (sized on the host from the maps) and
// the two tables in shared memory, computes the edge map at the staged
// in-image positions, then each thread evaluates 3 output pixels from
// shared memory; the RGBA taps are read from device memory. A block outside
// the circle only runs the fallback. The circle test is per block, so it is
// uniform in a CTA.
//
// Borders: the luma support clamps to the image, and the edge weight at a
// clamped position is that of the nearest in-image pixel, whose own 3x3 is
// clamped again: clip(clip(p)+-1) (oracle/nis.py:58-74, 250). The edge map
// is therefore computed at in-image positions only and the 2x2 indices are
// clamped into it. The per-column and per-row maps (source floor, phase,
// fraction, both bilinear taps) come from the host (kernels/_maps.py::
// nvscaler_maps). The TPU kernel's one-hot gathers, bf16 splits, circulant
// sandwich and DMA ring have no counterpart. Build with --fmad=false: the
// bits then match the plain torch version (kernels/nis.py::
// nvscaler_reference).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ffx_math.cuh"
#include "nis_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kBW = 32, kBH = 24;     // the 32x24 NIS scaler block (TILE_NIS_SCALER)
constexpr int kInW = 40, kInH = 32;   // staged luma footprint cap (kernels/_maps.py NIS_IN_TILE)
constexpr int kThreads = 256;
constexpr int kPhases = 64, kTaps = 8;  // the (64, 8) filter banks

struct Params {
  const uint32_t* img;      // (B, rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;            // (B, out_h, out_w) packed RGBA8
  const int32_t* col_i;     // (4, out_w): source floor, phase, RGBA-tap x0, fallback x0
  const float* col_f;       // (3, out_w): source fraction, RGBA-tap fx, fallback fx
  const int32_t* row_i;     // (4, out_h): the same per output row
  const float* row_f;       // (3, out_h)
  const int32_t* tile_x0;   // (blocks_x,): first staged input column per block column
  const int32_t* tile_y0;   // (blocks_y,): first staged input row per block row
  const int64_t* centres;   // (B, 5): cx1, cy1, cx2, cy2, radius_sq
  const float* coef;        // (2, 64, 8): COEF_SCALE, COEF_USM
  nis::Consts k;
  int in_h, in_w, rows, pitch, out_h, out_w, hdr_mode;
  float tint;
};

// hi ? lerp(head, up, s) : lerp(head, dn, s): a tail tap of the diagonal
// interpolation trees of GetDirFilters (NIS_Scaler.h:489-583).
__device__ __forceinline__ float tail(bool hi, float head, float up, float dn, float s) {
  return hi ? nis::lerp(head, up, s) : nis::lerp(head, dn, s);
}

// The 45-degree tree (NIS_Scaler.h:489-531) on the 6x6 support q.
__device__ __forceinline__ void diag45(const float q[6][6], float b, float t[7]) {
  const bool hi = b >= 0.5f;
  const float s = hi ? b - 0.5f : 0.5f - b;
  t[1] = nis::lerp(q[2][1], q[1][2], b);
  t[3] = nis::lerp(q[3][2], q[2][3], b);
  t[5] = nis::lerp(q[4][3], q[3][4], b);
  t[0] = tail(hi, q[1][1], q[0][2], q[2][0], s);
  t[2] = tail(hi, q[2][2], q[1][3], q[3][1], s);
  t[4] = tail(hi, q[3][3], q[2][4], q[4][2], s);
  t[6] = tail(hi, q[4][4], q[3][5], q[5][3], s);
}

// The 135-degree tree (NIS_Scaler.h:533-575).
__device__ __forceinline__ void diag135(const float q[6][6], float b, float t[7]) {
  const bool hi = b >= 0.5f;
  const float s = hi ? b - 0.5f : 0.5f - b;
  t[1] = nis::lerp(q[3][1], q[4][2], b);
  t[3] = nis::lerp(q[2][2], q[3][3], b);
  t[5] = nis::lerp(q[1][3], q[2][4], b);
  t[0] = tail(hi, q[4][1], q[5][2], q[3][0], s);
  t[2] = tail(hi, q[3][2], q[4][3], q[2][1], s);
  t[4] = tail(hi, q[2][3], q[3][4], q[1][2], s);
  t[6] = tail(hi, q[1][4], q[2][5], q[0][3], s);
}

__global__ void __launch_bounds__(kThreads) nis_scaler_kernel(Params p) {
  __shared__ float s_y[kInH][kInW];        // unscaled luma of the footprint
  __shared__ float s_w[4][kInH][kInW];     // edge weights w0, w90, w45, w135
  __shared__ float s_coef[2 * kPhases * kTaps];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * kBW, oy0 = blockIdx.y * kBH;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.out_h * p.out_w;
  const int OW = p.out_w, OH = p.out_h;

  if (!rgba8::inside_circle(p.centres + 5 * b, ox0, oy0, kBW, kBH)) {
    // DirectCopy fallback (NIS_Upscale.hlsl:77-90): bilinear at (x/OW,
    // y/OH) times the tint, alpha 1
    for (int i = tid; i < kBW * kBH; i += kThreads) {
      const int ox = ox0 + i % kBW, oy = oy0 + i / kBW;
      if (ox >= OW || oy >= OH) continue;
      float c[4];
      rgba8::bilinear_rgba(img, p.pitch, p.in_h, p.in_w, p.col_i[3 * OW + ox],
                           p.row_i[3 * OH + oy], p.col_f[2 * OW + ox], p.row_f[2 * OH + oy], c);
      out[static_cast<size_t>(oy) * OW + ox] = rgba8::pack(c[0], c[1] * p.tint, c[2] * p.tint, 1.0f);
    }
    return;
  }

  const int tx0 = p.tile_x0[blockIdx.x], ty0 = p.tile_y0[blockIdx.y];
  // 1. the tables and the footprint's luma (rows and columns past the image
  //    repeat its last; the footprint itself lies inside)
  for (int i = tid; i < 2 * kPhases * kTaps; i += kThreads) s_coef[i] = p.coef[i];
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int ly = i / kInW, lx = i % kInW;
    const int sy = min(ty0 + ly, p.in_h - 1), sx = min(tx0 + lx, p.in_w - 1);
    const uint32_t t = img[static_cast<size_t>(sy) * p.pitch + sx];
    s_y[ly][lx] = nis::get_y(rgba8::channel(t, 0), rgba8::channel(t, 1), rgba8::channel(t, 2),
                             p.hdr_mode);
  }
  __syncthreads();

  // 2. the edge map at the staged in-image positions, each from its own
  //    edge-clamped 3x3 (positions whose 3x3 leaves the footprint are never
  //    read; their indices are kept in the tile)
  for (int i = tid; i < kInH * kInW; i += kThreads) {
    const int ly = i / kInW, lx = i % kInW;
    const int y = ty0 + ly, x = tx0 + lx;
    if (y >= p.in_h || x >= p.in_w) continue;
    float q[3][3], w[4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int qy = rgba8::clampi(rgba8::clampi(y + r - 1, 0, p.in_h - 1) - ty0, 0, kInH - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int qx = rgba8::clampi(rgba8::clampi(x + c - 1, 0, p.in_w - 1) - tx0, 0, kInW - 1);
        q[r][c] = s_y[qy][qx];
      }
    }
    nis::edge_map(q, p.k, w);
#pragma unroll
    for (int e = 0; e < 4; ++e) s_w[e][ly][lx] = w[e];
  }
  __syncthreads();

  // 3. the output pixels of the block
  const nis::Consts& k = p.k;
  const float* cs_tab = s_coef;
  const float* cu_tab = s_coef + kPhases * kTaps;
  for (int i = tid; i < kBW * kBH; i += kThreads) {
    const int ox = ox0 + i % kBW, oy = oy0 + i / kBW;
    if (ox >= OW || oy >= OH) continue;
    const int pxi = p.col_i[ox], fx_int = p.col_i[OW + ox];
    const int pyi = p.row_i[oy], fy_int = p.row_i[OH + oy];
    const float fx = p.col_f[ox], fy = p.row_f[oy];

    // the 6x6 scaled-luma support (NIS_SCALE_FLOAT = 255)
    int ri[6], ci[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      ri[j] = rgba8::clampi(pyi + j - 2, 0, p.in_h - 1) - ty0;
      ci[j] = rgba8::clampi(pxi + j - 2, 0, p.in_w - 1) - tx0;
    }
    float q[6][6];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) q[r][c] = s_y[ri[r]][ci[c]] * 255.0f;

    // FilterNormal (NIS_Scaler.h:436-453): column sums, then the row sum
    const float* cy = cs_tab + fy_int * kTaps;
    const float* cx = cs_tab + fx_int * kTaps;
    float pixel_n = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = q[0][c] * cy[0];
#pragma unroll
      for (int r = 1; r < 6; ++r) v = v + q[r][c] * cy[r];
      const float term = v * cx[c];
      pixel_n = c == 0 ? term : pixel_n + term;
    }

    // GetDirFilters (NIS_Scaler.h:455-583)
    float v[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) v[r] = nis::lerp(q[r][2], q[r][3], fx);
    const float f0 = nis::eval_poly6(v, cs_tab + fy_int * kTaps, cu_tab + fy_int * kTaps,
                                     fy_int <= 32, k);
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c] = nis::lerp(q[2][c], q[3][c], fy);
    const float f90 = nis::eval_poly6(v, cs_tab + fx_int * kTaps, cu_tab + fx_int * kTaps,
                                      fx_int <= 32, k);

    float t[7];
    diag45(q, 0.5f + 0.5f * (fx - fy), t);
    float p45 = fx + fy;
    const bool wrap45 = p45 >= 1.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = wrap45 ? t[j + 1] : t[j];
    p45 = wrap45 ? p45 - 1.0f : p45;
    const int ph45 = static_cast<int>(p45 * 64.0f);
    const float f45 = nis::eval_poly6(v, cs_tab + ph45 * kTaps, cu_tab + ph45 * kTaps,
                                      ph45 <= 32, k);

    diag135(q, 0.5f * (fx + fy), t);
    float p135 = 1.0f + (fx - fy);
    const bool wrap135 = p135 >= 1.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = wrap135 ? t[j + 1] : t[j];
    p135 = wrap135 ? p135 - 1.0f : p135;
    const int ph135 = static_cast<int>(p135 * 64.0f);
    const float f135 = nis::eval_poly6(v, cs_tab + ph135 * kTaps, cu_tab + ph135 * kTaps,
                                       ph135 <= 32, k);

    // the edge weights of the 2x2 source pixels, clamped into the image,
    // interpolated by (fx, fy), * 255
    const int ey0 = rgba8::clampi(pyi, 0, p.in_h - 1) - ty0;
    const int ey1 = rgba8::clampi(pyi + 1, 0, p.in_h - 1) - ty0;
    const int ex0 = rgba8::clampi(pxi, 0, p.in_w - 1) - tx0;
    const int ex1 = rgba8::clampi(pxi + 1, 0, p.in_w - 1) - tx0;
    float ws[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h0 = nis::lerp(s_w[e][ey0][ex0], s_w[e][ey0][ex1], fx);
      const float h1 = nis::lerp(s_w[e][ey1][ex0], s_w[e][ey1][ex1], fx);
      ws[e] = nis::lerp(h0, h1, fy) * 255.0f;
    }
    const float op_y = (f0 * ws[0] + f90 * ws[1] + f45 * ws[2] + f135 * ws[3] +
                        pixel_n * (255.0f - ws[0] - ws[1] - ws[2] - ws[3])) *
                       ffx::kInv255;

    // the bilinear RGBA tap at ((x+0.5)/OW, (y+0.5)/OH) and the correction
    float op[4];
    rgba8::bilinear_rgba(img, p.pitch, p.in_h, p.in_w, p.col_i[2 * OW + ox], p.row_i[2 * OH + oy],
                         p.col_f[OW + ox], p.row_f[OH + oy], op);
    if (p.hdr_mode == 1) {  // multiplicative luma fix (NIS_Scaler.h:749-756)
      const float op_yn = ffx::max_nan(op_y, 0.0f) * k.scaler_hdr_norm;
      const float corr = (op_yn * op_yn + k.scaler_hdr_eps) /
                         (ffx::max_nan(nis::get_y_linear(op[0], op[1], op[2]), 0.0f) +
                          k.scaler_hdr_eps);
#pragma unroll
      for (int c = 0; c < 3; ++c) op[c] = op[c] * corr;
    } else {  // SDR and PQ: additive (:758-761)
      const float corr = op_y * ffx::kInv255 - nis::get_y(op[0], op[1], op[2], p.hdr_mode);
#pragma unroll
      for (int c = 0; c < 3; ++c) op[c] = op[c] + corr;
    }
    out[static_cast<size_t>(oy) * OW + ox] = rgba8::pack(op[0], op[1], op[2], op[3]);
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/nis.py) has checked shapes, dtypes and devices, and the
// host maps (kernels/_maps.py::nvscaler_maps) that every block's footprint
// fits kInW x kInH; in_tile_w / in_tile_h must equal them. consts points to
// nis::kNumConsts host floats in nis::Consts order.
extern "C" int nis_scaler_launch(const void* img, void* out, const void* col_i, const void* col_f,
                                 const void* row_i, const void* row_f, const void* tile_x0,
                                 const void* tile_y0, const void* centres, const void* coef,
                                 const float* consts, int n_consts, int batch, int in_h, int in_w,
                                 int rows, int pitch, int out_h, int out_w, int hdr_mode,
                                 float tint, int in_tile_w, int in_tile_h, void* stream) {
  if (n_consts != nis::kNumConsts || in_tile_w != kInW || in_tile_h != kInH || batch <= 0 ||
      out_h <= 0 || out_w <= 0 || in_h > rows || in_w > pitch || hdr_mode < 0 || hdr_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img = static_cast<const uint32_t*>(img);
  p.out = static_cast<uint32_t*>(out);
  p.col_i = static_cast<const int32_t*>(col_i);
  p.col_f = static_cast<const float*>(col_f);
  p.row_i = static_cast<const int32_t*>(row_i);
  p.row_f = static_cast<const float*>(row_f);
  p.tile_x0 = static_cast<const int32_t*>(tile_x0);
  p.tile_y0 = static_cast<const int32_t*>(tile_y0);
  p.centres = static_cast<const int64_t*>(centres);
  p.coef = static_cast<const float*>(coef);
  std::memcpy(&p.k, consts, sizeof(p.k));
  p.in_h = in_h;
  p.in_w = in_w;
  p.rows = rows;
  p.pitch = pitch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.hdr_mode = hdr_mode;
  p.tint = tint;
  const dim3 grid((out_w + kBW - 1) / kBW, (out_h + kBH - 1) / kBH, batch);
  nis_scaler_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
