// fsr_fused.cu — the fused FSR1 upscale (EASU -> UNORM8 -> RCAS) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/fsr.py::build_fsr_fused
// (pallas_call at :1019) on the system's main path: per stereo batch, EASU
// (ffx_fsr1.h:315-437) inside the foveation circle and the bilinear
// fallback (fsr_easu.hlsl:33-36) outside, the UNORM8 round trip of the
// reference's intermediate texture (PostProcessor.cpp:527), RCAS
// (ffx_fsr1.h:684-769) with zero out-of-image taps (fsr_rcas.hlsl:18)
// inside the circle and the quantized value times the debug tint outside
// (fsr_rcas.hlsl:46), stored as packed RGBA8 with alpha 255.
//
// What bounds it: bytes moved. At the full main-path size (2 x 1683x1869 ->
// 2 x 2244x2492, u32 in and out) one stereo pair reads about 25 MB and
// writes about 45 MB, while the math is a few hundred f32 ops per output
// pixel. The simple design keeps every intermediate on chip: one CTA per
// 16x16 output tile and batch entry (one thread per output pixel) stages the
// tile's input footprint once from the packed u32 plane into shared memory,
// computes stage 1 for the 18x18 haloed tile into shared memory as quantized
// f32, and runs RCAS from there; device memory sees each input texel about
// once per tile that covers it and each output texel exactly once. The
// one-hot matrix gathers, DMA ring and band machinery of the TPU kernel have
// no counterpart: a GPU thread gathers directly.
//
// The per-column and per-row sample maps (EASU floor and fraction, bilinear
// floor and fraction) and each tile's footprint origin come from the host
// (kernels/_maps.py), so the device evaluates no coordinate math; the
// foveation test is the reference's integer test per 16x16 group
// (fsr_easu.hlsl:41-45; csrc/rgba8.cuh). Build with --fmad=false: the bits
// then match the plain torch version (kernels/fsr.py::fsr_fused_reference).

#include <cuda_runtime.h>

#include <cstdint>

#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kTile = 16;             // output tile edge = the 16x16 foveation group
constexpr int kHalo = kTile + 2;      // stage-1 tile with the RCAS halo
constexpr int kInTile = 24;           // staged input footprint edge (kernels/_maps.py IN_TILE)
constexpr int kThreads = kTile * kTile;

struct Params {
  const uint32_t* img;      // (B, in_rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;            // (B, out_h, out_w) packed RGBA8
  const int32_t* col_i;     // (2, out_w): EASU floor fxi, bilinear x0
  const float* col_f;       // (2, out_w): EASU fraction ppx, bilinear fx
  const int32_t* row_i;     // (2, out_h): EASU floor fyi, bilinear y0
  const float* row_f;       // (2, out_h): EASU fraction ppy, bilinear fy
  const int32_t* tile_x0;   // (tiles_x,): first staged input column per tile column
  const int32_t* tile_y0;   // (tiles_y,): first staged input row per tile row
  const int64_t* centres;   // (B, 5): cx1, cy1, cx2, cy2, radius_sq
  int in_h, in_w, in_rows, pitch, out_h, out_w;
  float sharp, tint;
};

using rgba8::channel;
using rgba8::clampi;

__global__ void __launch_bounds__(kThreads) fsr_fused_kernel(Params p) {
  __shared__ uint32_t s_in[kInTile][kInTile];
  __shared__ float s_q[3][kHalo][kHalo];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int wx0 = p.tile_x0[blockIdx.x], wy0 = p.tile_y0[blockIdx.y];
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.in_rows * p.pitch;
  const int64_t* cen = p.centres + 5 * b;

  // 1. the tile's input footprint, once, from the packed plane
  for (int i = tid; i < kInTile * kInTile; i += kThreads) {
    const int ly = i / kInTile, lx = i % kInTile;
    const int y = wy0 + ly, x = wx0 + lx;
    s_in[ly][lx] = (y < p.in_h && x < p.in_w) ? img[static_cast<size_t>(y) * p.pitch + x] : 0u;
  }
  __syncthreads();

  // 2. stage 1 on the 18x18 haloed tile, quantized to UNORM8; texels outside
  //    the image are 0 (the RCAS Load() rule)
  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int ly = i / kHalo, lx = i % kHalo;
    const int oy = oy0 - 1 + ly, ox = ox0 - 1 + lx;
    float rgb[3] = {0.0f, 0.0f, 0.0f};
    if (oy >= 0 && oy < p.out_h && ox >= 0 && ox < p.out_w) {
      if (rgba8::inside_circle(cen, ox, oy, kTile, kTile)) {
        const int fx = p.col_i[ox], fy = p.row_i[oy];
        float t[12][3];
#pragma unroll
        for (int k = 0; k < 12; ++k) {
          const int sx = clampi(fx + ffx::tap_dx(k), 0, p.in_w - 1) - wx0;
          const int sy = clampi(fy + ffx::tap_dy(k), 0, p.in_h - 1) - wy0;
          const uint32_t texel = s_in[sy][sx];
#pragma unroll
          for (int c = 0; c < 3; ++c) t[k][c] = channel(texel, c);
        }
        ffx::easu(t, p.col_f[ox], p.row_f[oy], rgb);
      } else {
        const int x0 = p.col_i[p.out_w + ox], y0 = p.row_i[p.out_h + oy];
        const int sx0 = clampi(x0, 0, p.in_w - 1) - wx0, sx1 = clampi(x0 + 1, 0, p.in_w - 1) - wx0;
        const int sy0 = clampi(y0, 0, p.in_h - 1) - wy0, sy1 = clampi(y0 + 1, 0, p.in_h - 1) - wy0;
        const float fxw = p.col_f[p.out_w + ox], fyw = p.row_f[p.out_h + oy];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = ffx::bilerp(channel(s_in[sy0][sx0], c), channel(s_in[sy0][sx1], c),
                               channel(s_in[sy1][sx0], c), channel(s_in[sy1][sx1], c), fxw, fyw);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = ffx::unorm8_roundtrip(rgb[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s_q[c][ly][lx] = rgb[c];
  }
  __syncthreads();

  // 3. RCAS inside the circle, tinted pass-through outside; packed store
  const int lx = tid % kTile, ly = tid / kTile;
  const int ox = ox0 + lx, oy = oy0 + ly;
  if (ox >= p.out_w || oy >= p.out_h) return;
  float e[3], res[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) e[c] = s_q[c][ly + 1][lx + 1];
  if (rgba8::inside_circle(cen, ox, oy, kTile, kTile)) {
    float bt[3], dt[3], ft[3], ht[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bt[c] = s_q[c][ly][lx + 1];
      dt[c] = s_q[c][ly + 1][lx];
      ft[c] = s_q[c][ly + 1][lx + 2];
      ht[c] = s_q[c][ly + 2][lx + 1];
    }
    ffx::rcas(bt, dt, e, ft, ht, p.sharp, res);
  } else {
    res[0] = e[0];
    res[1] = e[1] * p.tint;
    res[2] = e[2] * p.tint;
  }
  const uint32_t packed = rgba8::pack(res[0], res[1], res[2], 1.0f);
  p.out[(static_cast<size_t>(b) * p.out_h + oy) * p.out_w + ox] = packed;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/fsr.py) has checked shapes, dtypes, devices and that every
// tile footprint fits kInTile; in_tile must equal kInTile.
extern "C" int fsr_fused_launch(const void* img, void* out, const void* col_i, const void* col_f,
                                const void* row_i, const void* row_f, const void* tile_x0,
                                const void* tile_y0, const void* centres, int batch, int in_h,
                                int in_w, int in_rows, int pitch, int out_h, int out_w,
                                float sharp, float tint, int in_tile, void* stream) {
  if (in_tile != kInTile || batch <= 0 || out_h <= 0 || out_w <= 0 || in_h > in_rows ||
      in_w > pitch)
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
  p.in_h = in_h;
  p.in_w = in_w;
  p.in_rows = in_rows;
  p.pitch = pitch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.sharp = sharp;
  p.tint = tint;
  const dim3 grid((out_w + kTile - 1) / kTile, (out_h + kTile - 1) / kTile, batch);
  fsr_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
