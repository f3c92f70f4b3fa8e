// cas_upscale.cu — FFX CAS sharpen-and-upscale (CasFilter scaling) for
// Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/cas.py::build_cas_upscale
// (pallas_call at :381): per stereo batch, CasFilter with scaling
// (ffx_cas.h:552-892, the mod's cas.upscale.hlsl flags) over 12 taps of the
// 4x4 window around floor(pp), with zero out-of-image taps (CasLoad),
// inside the foveation circle; outside, the bilinear fallback
// (fsr_easu.hlsl:33-36) times the debug tint (kernels/cas.py:345-348); stored
// as packed RGBA8 with alpha 255.
//
// What bounds it: bytes moved. At the full size (2 x 1683x1869 -> 2 x
// 2244x2492, u32 in and out) one stereo pair reads 25.2 MB and writes
// 44.7 MB, while the filter is about a hundred f32 ops per output pixel.
// The simple design: one CTA per 16x16 output tile (the foveation group)
// and batch entry, one thread per output pixel. The tile's input footprint
// (at most 20x20, as out >= in; sized on the host, kernels/_maps.py::
// cas_upscale_maps) is staged once from the packed plane into shared
// memory, with 0 at positions outside the image, so a CAS tap reads the
// window as it is and a bilinear tap clamps its index into the image first.
// The circle test is per tile, so the branch is uniform in a CTA. The TPU
// kernel's one-hot gather matmuls, derived-rows prologue and DMA ring have
// no counterpart. Build with --fmad=false: the bits then match the plain
// torch version (kernels/cas.py::cas_upscale_reference).

#include <cuda_runtime.h>

#include <cstdint>

#include "cas_math.cuh"
#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kTile = 16;     // output tile edge = the 16x16 foveation group
constexpr int kInTile = 20;   // staged input footprint edge (kernels/_maps.py CAS_IN_TILE)
constexpr int kThreads = kTile * kTile;

struct Params {
  const uint32_t* img;      // (B, in_rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;            // (B, out_h, out_w) packed RGBA8
  const int32_t* col_i;     // (2, out_w): CAS floor fx, bilinear x0
  const float* col_f;       // (2, out_w): CAS fraction ppx, bilinear fx
  const int32_t* row_i;     // (2, out_h): CAS floor fy, bilinear y0
  const float* row_f;       // (2, out_h): CAS fraction ppy, bilinear fy
  const int32_t* tile_x0;   // (tiles_x,): first staged input column (may be < 0)
  const int32_t* tile_y0;   // (tiles_y,): first staged input row (may be < 0)
  const int64_t* centres;   // (B, 5): cx1, cy1, cx2, cy2, radius_sq
  int in_h, in_w, in_rows, pitch, out_h, out_w;
  float sharp, tint;
};

using rgba8::channel;
using rgba8::clampi;

__global__ void __launch_bounds__(kThreads) cas_upscale_kernel(Params p) {
  __shared__ uint32_t s_in[kInTile][kInTile];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * kTile, oy0 = blockIdx.y * kTile;
  const int wx0 = p.tile_x0[blockIdx.x], wy0 = p.tile_y0[blockIdx.y];
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.in_rows * p.pitch;

  // the tile's input footprint, once; texels outside the image are 0
  for (int i = tid; i < kInTile * kInTile; i += kThreads) {
    const int ly = i / kInTile, lx = i % kInTile;
    const int y = wy0 + ly, x = wx0 + lx;
    s_in[ly][lx] = (y >= 0 && y < p.in_h && x >= 0 && x < p.in_w)
                       ? img[static_cast<size_t>(y) * p.pitch + x]
                       : 0u;
  }
  __syncthreads();

  const int ox = ox0 + tid % kTile, oy = oy0 + tid / kTile;
  if (ox >= p.out_w || oy >= p.out_h) return;
  float rgb[3];
  if (rgba8::inside_circle(p.centres + 5 * b, ox0, oy0, kTile, kTile)) {
    const int sx = p.col_i[ox] - 1 - wx0, sy = p.row_i[oy] - 1 - wy0;
    float win[4][4][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t texel = s_in[sy + r][sx + q];
#pragma unroll
        for (int c = 0; c < 3; ++c) win[r][q][c] = channel(texel, c);
      }
    cas::upscale(win, p.col_f[ox], p.row_f[oy], p.sharp, rgb);
  } else {
    const int x0 = p.col_i[p.out_w + ox], y0 = p.row_i[p.out_h + oy];
    const int sx0 = clampi(x0, 0, p.in_w - 1) - wx0, sx1 = clampi(x0 + 1, 0, p.in_w - 1) - wx0;
    const int sy0 = clampi(y0, 0, p.in_h - 1) - wy0, sy1 = clampi(y0 + 1, 0, p.in_h - 1) - wy0;
    const float fxw = p.col_f[p.out_w + ox], fyw = p.row_f[p.out_h + oy];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = ffx::bilerp(channel(s_in[sy0][sx0], c), channel(s_in[sy0][sx1], c),
                           channel(s_in[sy1][sx0], c), channel(s_in[sy1][sx1], c), fxw, fyw);
    rgb[1] = rgb[1] * p.tint;
    rgb[2] = rgb[2] * p.tint;
  }
  p.out[(static_cast<size_t>(b) * p.out_h + oy) * p.out_w + ox] =
      rgba8::pack(rgb[0], rgb[1], rgb[2], 1.0f);
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/cas.py) has checked shapes, dtypes, devices and that every
// tile footprint fits kInTile; in_tile must equal kInTile.
extern "C" int cas_upscale_launch(const void* img, void* out, const void* col_i,
                                  const void* col_f, const void* row_i, const void* row_f,
                                  const void* tile_x0, const void* tile_y0, const void* centres,
                                  int batch, int in_h, int in_w, int in_rows, int pitch, int out_h,
                                  int out_w, float sharp, float tint, int in_tile, void* stream) {
  if (in_tile != kInTile || batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
      in_h > in_rows || in_w > pitch)
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
  cas_upscale_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
