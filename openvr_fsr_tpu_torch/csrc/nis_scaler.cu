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
// (api/pipeline.py:428-434). Stored in the frame's format: packed RGBA8, or
// R10G10B10A2 as four uint16 (the JAX builder's color_bits=10 branch,
// nis.py:371: only the texel decode and encode change, NIS_SCALE_FLOAT
// stays 255; the codecs of codec.cuh, one instantiation of every kernel
// each, behind nis_scaler_launch and nis_scaler_launch10).
//
// What bounds it: inside the circle, the per-pixel math (about a thousand
// f32 ops: 4 EvalPoly6 with their LTI, FilterNormal, the interpolation
// trees) and the shared-memory words it reads; outside, the bytes (at the
// shipped geometry one stereo pair reads 25.2 MB and writes 44.7 MB in
// RGBA8, 50.3 MB and 89.5 MB in R10G10B10A2).
//
// The design, per CTA output tile of 32x48 pixels (two stacked 32x24
// blocks; the reference's circle test is per block):
//   - the host (kernels/_maps.py::nvscaler_maps) evaluates the circle test
//     once per build and per block and splits the tiles into an inside list
//     (any block inside) and an outside list. No foveation test and no int64
//     arithmetic runs here.
//   - nis_outside_kernel runs the outside list: the shared bilinear pass
//     (bilinear_pass.cuh) on the DirectCopy maps, no shared memory, no
//     barrier.
//   - nis_inside_kernel runs the inside list, one CTA per tile: it stages
//     the tile's luma window (kWinW x kWinH, sized on the host from the
//     maps) and the two tables in shared memory, then computes the edge map
//     only over the extent the tile's 2x2 edge taps read (from the host,
//     about 26x38 of the 40x56 window at rs 0.75). Each warp then takes 6
//     rows of the tile's 32 columns, one column per thread; a warp whose
//     32x24 block lies outside the circle runs DirectCopy from device memory
//     instead. Down a thread's run, the 6x6 scaled-luma support and the 2x2
//     edge weights stay in registers and slide with the source row (a step
//     of one loads one luma row and one edge row, any other step reloads, no
//     step loads nothing); the column's COEF_SCALE / COEF_USM rows at
//     fx_int load once per run; the rows at fy_int, the same for the whole
//     warp, come from constant memory, once per output for both filters
//     that use them (nis_coef.cuh: part of the module image, so no upload
//     and no ordering on any stream). Only the two diagonal phases read
//     their table rows from shared memory per output, from rows padded so
//     that phases 16 apart fall on other banks. The RGBA taps are read from
//     device memory.
//
// Borders: the luma support clamps to the image, and the edge weight at a
// clamped position is that of the nearest in-image pixel, whose own 3x3 is
// clamped again: clip(clip(p)+-1) (oracle/nis.py:58-74, 250). The edge map
// is therefore computed at in-image positions only and the 2x2 indices are
// clamped into it. The per-column and per-row maps (source floor, phase,
// fraction, both bilinear taps) come from the host (kernels/_maps.py::
// nvscaler_maps). The TPU kernel's one-hot gathers, bf16 splits, circulant
// sandwich and DMA ring have no counterpart.
//
// Half precision (the JAX kernel's precision="half", nis.py:373-384,
// 841-1011): nis_half_inside_kernel is the inside kernel's body with
// FilterNormal, the interpolation trees and EvalPoly6 in bf16 op by op
// (nis::eval_poly6<ffx::Half>). The luma plane and the tables stay f32 for
// the edge map; each read is rounded where the JAX kernel casts: the
// scaled-luma taps as they are loaded, the tables' rows as they are staged
// (COEF_SCALE / COEF_USM at fx_int and at the diagonal phases) or read
// from constant memory (at fy_int), the fractions fx, fy and the diagonal
// fractions b and |b - 0.5| where the trees use them. Phases, wraps and
// the b >= 0.5 select compare f32 values; the edge map, the combine, the
// RGBA tap and the correction are f32. The host rounds the constants of
// EvalPoly6 (kernels/nis.py::_consts). The DirectCopy paths are the same.
// One instantiation per codec behind nis_scaler_launch_h and
// nis_scaler_launch10_h.
// Build with --fmad=false: the bits then match the plain torch version
// (kernels/nis.py::nvscaler_reference).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "bilinear_pass.cuh"
#include "codec.cuh"
#include "ffx_math.cuh"
#include "nis_coef.cuh"
#include "nis_math.cuh"

namespace {

constexpr int kBW = 32, kBH = 24;          // the 32x24 NIS scaler block (TILE_NIS_SCALER)
constexpr int kTileW = 32, kTileH = 48;    // CTA output tile (kernels/_maps.py NIS_TILE)
constexpr int kWinW = 40, kWinH = 56;      // staged luma window cap (NIS_IN_TILE)
constexpr int kEdgeW = 36, kEdgeH = 52;    // edge-map extent cap (NIS_EDGE_TILE)
constexpr int kThreads = 256;
constexpr int kRun = kTileW * kTileH / kThreads;   // outputs per thread (6), one column
constexpr int kPhases = 64, kTaps = 8;     // the (64, 8) filter banks
constexpr int kInsideCtasPerSm = 2;        // __launch_bounds__ minimum of the inside kernel
static_assert(kTileW == kBW && kTileH % kBH == 0 && kBH % kRun == 0,
              "a warp's rows lie in one block");

// A table row's offset in shared memory: rows 9 words apart, the second
// half of the phases 8 further, so the four phases 16 apart that a warp's
// columns read at rs 0.75 fall on four banks.
constexpr int kRowStride = kTaps + 1;
constexpr int kTable = kPhases * kRowStride + kTaps;   // one padded table
__device__ __forceinline__ int coef_row(int phase) { return phase * kRowStride + (phase >> 5) * kTaps; }

// c_coef (nis_coef.cuh): COEF_SCALE then COEF_USM, read at the warp-uniform
// fy_int.
static_assert(sizeof(c_coef) == 2 * kPhases * kTaps * sizeof(float), "the (2, 64, 8) tables");

template <class C>
struct Params {
  const typename C::Texel* img;   // (B, rows, pitch) texels
  typename C::Texel* out;         // (B, out_h, out_w) texels
  const int32_t* col_i;     // (4, out_w): source floor, phase, RGBA-tap x0, fallback x0
  const float* col_f;       // (3, out_w): source fraction, RGBA-tap fx, fallback fx
  const int32_t* row_i;     // (4, out_h): the same per output row
  const float* row_f;       // (3, out_h)
  const int32_t* tile_x0;   // (tiles_x,): first staged input column per tile column
  const int32_t* tile_y0;   // (tiles_y,): first staged input row per tile row
  const int32_t* edge_x;    // (2, tiles_x): first and last edge-map column per tile column
  const int32_t* edge_y;    // (2, tiles_y): first and last edge-map row per tile row
  const int32_t* block_cls; // (B, blocks_y, tiles_x): 1 where the block is inside the circle
  const int32_t* tiles;     // the inside list: b * tiles_y * tiles_x + ty * tiles_x + tx
  const float* coef;        // (2, 64, 8): COEF_SCALE, COEF_USM (c_coef's values)
  nis::Consts k;
  int in_h, in_w, rows, pitch, out_h, out_w, hdr_mode, tiles_x, tiles_y, blocks_y;
  float tint;
};

struct Smem {
  float4 w[kEdgeH][kEdgeW];   // edge weights w0, w90, w45, w135 over the extent
  float y[kWinH][kWinW];      // unscaled luma of the window
  float coef[2 * kTable];     // COEF_SCALE, COEF_USM, padded rows (coef_row)
};

// hi ? lerp(head, up, s) : lerp(head, dn, s): a tail tap of the diagonal
// interpolation trees of GetDirFilters (NIS_Scaler.h:489-583).
template <class P>
__device__ __forceinline__ float tail(bool hi, float head, float up, float dn, float s) {
  return hi ? nis::lerp<P>(head, up, s) : nis::lerp<P>(head, dn, s);
}

// The 45-degree tree (NIS_Scaler.h:489-531) on the 6x6 support q; b in f32,
// the fractions the lerps take rounded to P.
template <class P>
__device__ __forceinline__ void diag45(const float q[6][6], float b, float t[7]) {
  const bool hi = b >= 0.5f;
  const float s = P::r(hi ? b - 0.5f : 0.5f - b);
  const float bp = P::r(b);
  t[1] = nis::lerp<P>(q[2][1], q[1][2], bp);
  t[3] = nis::lerp<P>(q[3][2], q[2][3], bp);
  t[5] = nis::lerp<P>(q[4][3], q[3][4], bp);
  t[0] = tail<P>(hi, q[1][1], q[0][2], q[2][0], s);
  t[2] = tail<P>(hi, q[2][2], q[1][3], q[3][1], s);
  t[4] = tail<P>(hi, q[3][3], q[2][4], q[4][2], s);
  t[6] = tail<P>(hi, q[4][4], q[3][5], q[5][3], s);
}

// The 135-degree tree (NIS_Scaler.h:533-575).
template <class P>
__device__ __forceinline__ void diag135(const float q[6][6], float b, float t[7]) {
  const bool hi = b >= 0.5f;
  const float s = P::r(hi ? b - 0.5f : 0.5f - b);
  const float bp = P::r(b);
  t[1] = nis::lerp<P>(q[3][1], q[4][2], bp);
  t[3] = nis::lerp<P>(q[2][2], q[3][3], bp);
  t[5] = nis::lerp<P>(q[1][3], q[2][4], bp);
  t[0] = tail<P>(hi, q[4][1], q[5][2], q[3][0], s);
  t[2] = tail<P>(hi, q[3][2], q[4][3], q[2][1], s);
  t[4] = tail<P>(hi, q[2][3], q[3][4], q[1][2], s);
  t[6] = tail<P>(hi, q[1][4], q[2][5], q[0][3], s);
}

// Rows j of the 6x6 scaled-luma support at source row pyi: luma rows
// clip(pyi + j - 2) at the window columns ci (NIS_SCALE_FLOAT = 255), in P.
template <class C, class P>
__device__ __forceinline__ void load_luma_row(const Smem& s, const Params<C>& p, int ty0, int pyi,
                                              int j, const int ci[6], float row[6]) {
  const int ri = rgba8::clampi(pyi + j - 2, 0, p.in_h - 1) - ty0;
#pragma unroll
  for (int c = 0; c < 6; ++c) row[c] = P::r(s.y[ri][ci[c]] * 255.0f);
}

// One inside tile (the CTA's of the list) in the working precision P
// (ffx::Full, ffx::Half).
template <class C, class P>
__device__ __forceinline__ void inside_tile(const Params<C>& p) {
  using Texel = typename C::Texel;
  __shared__ Smem s;

  const int tid = threadIdx.x;
  const int id = p.tiles[blockIdx.x];
  const int per = p.tiles_x * p.tiles_y;
  const int b = id / per;
  const int ty = (id - b * per) / p.tiles_x;
  const int tx = id - b * per - ty * p.tiles_x;
  const Texel* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;
  Texel* out = p.out + static_cast<size_t>(b) * p.out_h * p.out_w;
  const int OW = p.out_w, OH = p.out_h;
  const int tx0 = p.tile_x0[tx], ty0 = p.tile_y0[ty];
  const int ex0 = p.edge_x[tx], ey0 = p.edge_y[ty];
  const int enx = p.edge_x[p.tiles_x + tx] - ex0 + 1, eny = p.edge_y[p.tiles_y + ty] - ey0 + 1;

  // 1. the tables and the window's luma (rows and columns past the image
  //    repeat its last; the window's origin lies inside)
  for (int i = tid; i < 2 * kPhases * kTaps; i += kThreads) {
    const int t = i / (kPhases * kTaps), ph = i / kTaps % kPhases;
    s.coef[t * kTable + coef_row(ph) + i % kTaps] = P::r(p.coef[i]);
  }
  for (int i = tid; i < kWinH * kWinW; i += kThreads) {
    const int ly = i / kWinW, lx = i % kWinW;
    const int sy = min(ty0 + ly, p.in_h - 1), sx = min(tx0 + lx, p.in_w - 1);
    const Texel t = img[static_cast<size_t>(sy) * p.pitch + sx];
    s.y[ly][lx] = nis::get_y(C::channel(t, 0), C::channel(t, 1), C::channel(t, 2), p.hdr_mode);
  }
  __syncthreads();

  // 2. the edge map over the extent the 2x2 edge taps read, each position
  //    from its own edge-clamped 3x3
  for (int i = tid; i < enx * eny; i += kThreads) {
    const int ly = i / enx, lx = i - ly * enx;
    const int y = ey0 + ly, x = ex0 + lx;
    float q[3][3], w[4];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int qy = rgba8::clampi(rgba8::clampi(y + r - 1, 0, p.in_h - 1) - ty0, 0, kWinH - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int qx = rgba8::clampi(rgba8::clampi(x + c - 1, 0, p.in_w - 1) - tx0, 0, kWinW - 1);
        q[r][c] = s.y[qy][qx];
      }
    }
    nis::edge_map(q, p.k, w);
    s.w[ly][lx] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();

  // 3. this thread's outputs: column ox, rows oy0 .. oy0 + kRun - 1 (a
  //    warp: 32 columns of the same rows, in one 32x24 block)
  const int warp = tid / 32;
  const int ox = tx * kTileW + tid % 32, oy0 = ty * kTileH + warp * kRun;
  if (ox >= OW || oy0 >= OH) return;
  const int by = ty * (kTileH / kBH) + warp * kRun / kBH;
  if (!p.block_cls[(b * p.blocks_y + by) * p.tiles_x + tx]) {
    // DirectCopy (NIS_Upscale.hlsl:77-90): bilinear at (x/OW, y/OH) times
    // the tint, alpha 1
    const int x0 = p.col_i[3 * OW + ox];
    const float fx = p.col_f[2 * OW + ox];
    const int sx0 = rgba8::clampi(x0, 0, p.in_w - 1), sx1 = rgba8::clampi(x0 + 1, 0, p.in_w - 1);
#pragma unroll 1
    for (int r = 0; r < kRun; ++r) {
      const int oy = oy0 + r;
      if (oy >= OH) break;
      const int y0 = p.row_i[3 * OH + oy];
      const Texel* r0 = img + static_cast<size_t>(rgba8::clampi(y0, 0, p.in_h - 1)) * p.pitch;
      const Texel* r1 = img + static_cast<size_t>(rgba8::clampi(y0 + 1, 0, p.in_h - 1)) * p.pitch;
      out[static_cast<size_t>(oy) * OW + ox] = bilinear_pass::texel<false, C>(
          r0[sx0], r0[sx1], r1[sx0], r1[sx1], fx, p.row_f[2 * OH + oy], p.tint);
    }
    return;
  }

  const nis::Consts& k = p.k;
  const int pxi = p.col_i[ox], fx_int = p.col_i[OW + ox];
  const float fx = p.col_f[ox], fxp = P::r(fx);
  // the column's table rows at fx_int, once per run
  float csx[6], cux[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    csx[j] = s.coef[coef_row(fx_int) + j];
    cux[j] = s.coef[kTable + coef_row(fx_int) + j];
  }
  int ci[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) ci[j] = rgba8::clampi(pxi + j - 2, 0, p.in_w - 1) - tx0;
  const int ew0 = rgba8::clampi(pxi, 0, p.in_w - 1) - ex0;
  const int ew1 = rgba8::clampi(pxi + 1, 0, p.in_w - 1) - ex0;

  float q[6][6];          // the 6x6 scaled-luma support at source row cur
  float4 e[2][2];         // edge weights at rows clip(cur), clip(cur + 1), columns ew0, ew1
  int cur = -0x40000000;  // the source row both hold (none yet)
#pragma unroll 1
  for (int r = 0; r < kRun; ++r) {
    const int oy = oy0 + r;
    if (oy >= OH) break;
    const int pyi = p.row_i[oy];
    if (pyi == cur + 1) {   // one row down: keep five luma rows and one edge row
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int c = 0; c < 6; ++c) q[j][c] = q[j + 1][c];
      load_luma_row<C, P>(s, p, ty0, pyi, 5, ci, q[5]);
      e[0][0] = e[1][0];
      e[0][1] = e[1][1];
      const int er = rgba8::clampi(pyi + 1, 0, p.in_h - 1) - ey0;
      e[1][0] = s.w[er][ew0];
      e[1][1] = s.w[er][ew1];
    } else if (pyi != cur) {
#pragma unroll
      for (int j = 0; j < 6; ++j) load_luma_row<C, P>(s, p, ty0, pyi, j, ci, q[j]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int er = rgba8::clampi(pyi + j, 0, p.in_h - 1) - ey0;
        e[j][0] = s.w[er][ew0];
        e[j][1] = s.w[er][ew1];
      }
    }
    cur = pyi;
    const int fy_int = p.row_i[OH + oy];
    const float fy = p.row_f[oy];
    // the row's table rows at fy_int, the same for the whole warp
    float csy[6], cuy[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      csy[j] = P::r(c_coef[fy_int * kTaps + j]);
      cuy[j] = P::r(c_coef[kPhases * kTaps + fy_int * kTaps + j]);
    }

    // FilterNormal (NIS_Scaler.h:436-453): column sums, then the row sum
    float pixel_n = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float v = P::r(q[0][c] * csy[0]);
#pragma unroll
      for (int j = 1; j < 6; ++j) v = P::r(v + P::r(q[j][c] * csy[j]));
      const float term = P::r(v * csx[c]);
      pixel_n = c == 0 ? term : P::r(pixel_n + term);
    }

    // GetDirFilters (NIS_Scaler.h:455-583)
    float v[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = nis::lerp<P>(q[j][2], q[j][3], fxp);
    const float f0 = nis::eval_poly6<P>(v, csy, cuy, fy_int <= 32, k);
    const float fyp = P::r(fy);
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c] = nis::lerp<P>(q[2][c], q[3][c], fyp);
    const float f90 = nis::eval_poly6<P>(v, csx, cux, fx_int <= 32, k);

    float t[7];
    diag45<P>(q, 0.5f + 0.5f * (fx - fy), t);
    float p45 = fx + fy;
    const bool wrap45 = p45 >= 1.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = wrap45 ? t[j + 1] : t[j];
    p45 = wrap45 ? p45 - 1.0f : p45;
    const int ph45 = static_cast<int>(p45 * 64.0f);
    const float f45 = nis::eval_poly6<P>(v, s.coef + coef_row(ph45),
                                         s.coef + kTable + coef_row(ph45), ph45 <= 32, k);

    diag135<P>(q, 0.5f * (fx + fy), t);
    float p135 = 1.0f + (fx - fy);
    const bool wrap135 = p135 >= 1.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = wrap135 ? t[j + 1] : t[j];
    p135 = wrap135 ? p135 - 1.0f : p135;
    const int ph135 = static_cast<int>(p135 * 64.0f);
    const float f135 = nis::eval_poly6<P>(v, s.coef + coef_row(ph135),
                                          s.coef + kTable + coef_row(ph135), ph135 <= 32, k);

    // the edge weights of the 2x2 source pixels, interpolated by (fx, fy),
    // * 255; f32, as the combine with the P values of the filters
    float ws[4];
    const float w00[4] = {e[0][0].x, e[0][0].y, e[0][0].z, e[0][0].w};
    const float w01[4] = {e[0][1].x, e[0][1].y, e[0][1].z, e[0][1].w};
    const float w10[4] = {e[1][0].x, e[1][0].y, e[1][0].z, e[1][0].w};
    const float w11[4] = {e[1][1].x, e[1][1].y, e[1][1].z, e[1][1].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float h0 = nis::lerp(w00[j], w01[j], fx);
      const float h1 = nis::lerp(w10[j], w11[j], fx);
      ws[j] = nis::lerp(h0, h1, fy) * 255.0f;
    }
    const float op_y = (f0 * ws[0] + f90 * ws[1] + f45 * ws[2] + f135 * ws[3] +
                        pixel_n * (255.0f - ws[0] - ws[1] - ws[2] - ws[3])) *
                       ffx::kInv255;

    // the bilinear RGBA tap at ((x+0.5)/OW, (y+0.5)/OH) and the correction
    float op[4];
    codec::bilinear_rgba<C>(img, p.pitch, p.in_h, p.in_w, p.col_i[2 * OW + ox], p.row_i[2 * OH + oy],
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
    out[static_cast<size_t>(oy) * OW + ox] = C::pack(op[0], op[1], op[2], op[3]);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm) nis_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Full>(p);
}
template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm) nis_half_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Half>(p);
}

// The inside kernel of precision P.
template <class C, class P>
auto inside_kernel() {
  if constexpr (P::kHalf)
    return nis_half_inside_kernel<C>;
  else
    return nis_inside_kernel<C>;
}

// The outside list: the shared bilinear pass on the DirectCopy maps.
template <class C>
__global__ void __launch_bounds__(bilinear_pass::threads(kTileW, kTileH))
    nis_outside_kernel(bilinear_pass::Args<C> a) {
  bilinear_pass::run<kTileW, kTileH, false, C>(a);
}

template <class C, class P>
int occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      outside, nis_outside_kernel<C>, bilinear_pass::threads(kTileW, kTileH), 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, inside_kernel<C, P>(), kThreads,
                                                        0);
  return static_cast<int>(err);
}

template <class C, class P>
int launch(const void* img, void* out, const void* col_i, const void* col_f, const void* row_i,
           const void* row_f, const void* tile_x0, const void* tile_y0, const void* edge_x,
           const void* edge_y, const void* block_cls, const void* coef, const void* inside_tiles,
           int n_inside, const void* outside_tiles, int n_outside, const float* consts,
           int n_consts, int batch, int in_h, int in_w, int rows, int pitch, int out_h,
           int out_w, int hdr_mode, float tint, int tile_w, int tile_h, int win_w, int win_h,
           int edge_w, int edge_h, void* stream) {
  using Texel = typename C::Texel;
  if (n_consts != nis::kNumConsts || tile_w != kTileW || tile_h != kTileH || win_w != kWinW ||
      win_h != kWinH || edge_w != kEdgeW || edge_h != kEdgeH || batch <= 0 || in_h <= 0 ||
      in_w <= 0 || out_h <= 0 || out_w <= 0 || in_h > rows || in_w > pitch || hdr_mode < 0 ||
      hdr_mode > 2 || n_inside < 0 || n_outside < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<C> p;
  p.img = static_cast<const Texel*>(img);
  p.out = static_cast<Texel*>(out);
  p.col_i = static_cast<const int32_t*>(col_i);
  p.col_f = static_cast<const float*>(col_f);
  p.row_i = static_cast<const int32_t*>(row_i);
  p.row_f = static_cast<const float*>(row_f);
  p.tile_x0 = static_cast<const int32_t*>(tile_x0);
  p.tile_y0 = static_cast<const int32_t*>(tile_y0);
  p.edge_x = static_cast<const int32_t*>(edge_x);
  p.edge_y = static_cast<const int32_t*>(edge_y);
  p.block_cls = static_cast<const int32_t*>(block_cls);
  p.tiles = static_cast<const int32_t*>(inside_tiles);
  p.coef = static_cast<const float*>(coef);
  std::memcpy(&p.k, consts, sizeof(p.k));
  p.in_h = in_h;
  p.in_w = in_w;
  p.rows = rows;
  p.pitch = pitch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.hdr_mode = hdr_mode;
  p.tiles_x = (out_w + kTileW - 1) / kTileW;
  p.tiles_y = (out_h + kTileH - 1) / kTileH;
  p.blocks_y = (out_h + kBH - 1) / kBH;
  p.tint = tint;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_outside > 0) {
    if (!bilinear_pass::offsets_fit(in_h, pitch))
      return static_cast<int>(cudaErrorInvalidValue);
    const bilinear_pass::Args<C> a = {p.img, p.out, p.col_i + 3 * out_w, p.col_f + 2 * out_w,
                                      p.row_i + 3 * out_h, p.row_f + 2 * out_h,
                                      static_cast<const int32_t*>(outside_tiles), in_h, in_w,
                                      rows, pitch, out_h, out_w, tint,
                                      bilinear_pass::Divisor::of(p.tiles_x * p.tiles_y),
                                      bilinear_pass::Divisor::of(p.tiles_x)};
    nis_outside_kernel<C><<<n_outside, bilinear_pass::threads(kTileW, kTileH), 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_inside > 0) {
    const auto kernel = inside_kernel<C, P>();
    kernel<<<n_inside, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// CTAs per SM of the outside and inside kernels on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the inside kernel's
// shared memory per CTA in bytes, for RGBA8 (nis_scaler_occupancy) and
// R10G10B10A2 (nis_scaler_occupancy10). Returns the first non-zero
// cudaError_t.
extern "C" int nis_scaler_occupancy(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Full>(outside, inside, inside_smem);
}
extern "C" int nis_scaler_occupancy10(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Full>(outside, inside, inside_smem);
}
// The same for the half instantiations (nis_scaler_launch_h, _launch10_h).
extern "C" int nis_scaler_occupancy_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Half>(outside, inside, inside_smem);
}
extern "C" int nis_scaler_occupancy10_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Half>(outside, inside, inside_smem);
}

// Launch on `stream`: the outside pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing), on packed
// RGBA8 texels (nis_scaler_launch) or R10G10B10A2 ones
// (nis_scaler_launch10). Returns the first non-zero cudaError_t (0 =
// launched). The caller (kernels/nis.py) has checked shapes, dtypes and
// devices, and the host maps (kernels/_maps.py::nvscaler_maps) that every
// tile's window and edge extent fit their caps and that the lists partition
// the tiles; tile, window and edge must equal
// (kTileW, kTileH), (kWinW, kWinH) and (kEdgeW, kEdgeH). coef is the device
// copy of the (2, 64, 8) tables (the values of c_coef, staged into shared
// memory by coalesced loads); consts points to nis::kNumConsts host floats in
// nis::Consts order.
extern "C" int nis_scaler_launch(const void* img, void* out, const void* col_i, const void* col_f,
                                 const void* row_i, const void* row_f, const void* tile_x0,
                                 const void* tile_y0, const void* edge_x, const void* edge_y,
                                 const void* block_cls, const void* coef,
                                 const void* inside_tiles, int n_inside,
                                 const void* outside_tiles, int n_outside, const float* consts,
                                 int n_consts, int batch, int in_h, int in_w, int rows, int pitch,
                                 int out_h, int out_w, int hdr_mode, float tint, int tile_w,
                                 int tile_h, int win_w, int win_h, int edge_w, int edge_h,
                                 void* stream) {
  return launch<codec::Rgba8, ffx::Full>(
      img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0, edge_x, edge_y, block_cls, coef,
      inside_tiles, n_inside, outside_tiles, n_outside, consts, n_consts, batch, in_h, in_w, rows,
      pitch, out_h, out_w, hdr_mode, tint, tile_w, tile_h, win_w, win_h, edge_w, edge_h, stream);
}
extern "C" int nis_scaler_launch10(const void* img, void* out, const void* col_i, const void* col_f,
                                   const void* row_i, const void* row_f, const void* tile_x0,
                                   const void* tile_y0, const void* edge_x, const void* edge_y,
                                   const void* block_cls, const void* coef,
                                   const void* inside_tiles, int n_inside,
                                   const void* outside_tiles, int n_outside, const float* consts,
                                   int n_consts, int batch, int in_h, int in_w, int rows, int pitch,
                                   int out_h, int out_w, int hdr_mode, float tint, int tile_w,
                                   int tile_h, int win_w, int win_h, int edge_w, int edge_h,
                                   void* stream) {
  return launch<codec::Rgb10a2, ffx::Full>(
      img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0, edge_x, edge_y, block_cls, coef,
      inside_tiles, n_inside, outside_tiles, n_outside, consts, n_consts, batch, in_h, in_w, rows,
      pitch, out_h, out_w, hdr_mode, tint, tile_w, tile_h, win_w, win_h, edge_w, edge_h, stream);
}

// The half instantiations, the same prototype (consts: kernels/nis.py::
// _consts at bf16).
extern "C" int nis_scaler_launch_h(const void* img, void* out, const void* col_i,
                                   const void* col_f, const void* row_i, const void* row_f,
                                   const void* tile_x0, const void* tile_y0, const void* edge_x,
                                   const void* edge_y, const void* block_cls, const void* coef,
                                   const void* inside_tiles, int n_inside,
                                   const void* outside_tiles, int n_outside, const float* consts,
                                   int n_consts, int batch, int in_h, int in_w, int rows,
                                   int pitch, int out_h, int out_w, int hdr_mode, float tint,
                                   int tile_w, int tile_h, int win_w, int win_h, int edge_w,
                                   int edge_h, void* stream) {
  return launch<codec::Rgba8, ffx::Half>(
      img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0, edge_x, edge_y, block_cls, coef,
      inside_tiles, n_inside, outside_tiles, n_outside, consts, n_consts, batch, in_h, in_w, rows,
      pitch, out_h, out_w, hdr_mode, tint, tile_w, tile_h, win_w, win_h, edge_w, edge_h, stream);
}
extern "C" int nis_scaler_launch10_h(const void* img, void* out, const void* col_i,
                                     const void* col_f, const void* row_i, const void* row_f,
                                     const void* tile_x0, const void* tile_y0, const void* edge_x,
                                     const void* edge_y, const void* block_cls, const void* coef,
                                     const void* inside_tiles, int n_inside,
                                     const void* outside_tiles, int n_outside,
                                     const float* consts, int n_consts, int batch, int in_h,
                                     int in_w, int rows, int pitch, int out_h, int out_w,
                                     int hdr_mode, float tint, int tile_w, int tile_h, int win_w,
                                     int win_h, int edge_w, int edge_h, void* stream) {
  return launch<codec::Rgb10a2, ffx::Half>(
      img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0, edge_x, edge_y, block_cls, coef,
      inside_tiles, n_inside, outside_tiles, n_outside, consts, n_consts, batch, in_h, in_w, rows,
      pitch, out_h, out_w, hdr_mode, tint, tile_w, tile_h, win_w, win_h, edge_w, edge_h, stream);
}
