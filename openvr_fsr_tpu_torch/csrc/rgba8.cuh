// rgba8.cuh — what every kernel of the port shares: the packed RGBA8 texel
// codec, an integer clamp, and the reference's foveation circle test.
//
// A texel is a uint32 with R in the low byte. The decode multiplies by the
// f32 reciprocal of 255 (utils/frames.py, kernels/_common.py::unpack); the
// encode clamps, scales and rounds half to even per channel
// (kernels/_common.py::pack), so a kernel's output bits equal its plain
// torch version's.
#pragma once

#include <cstdint>

#include "ffx_math.cuh"

namespace rgba8 {

// The reference's per-workgroup circle test (fsr_easu.hlsl:41-45,
// NIS_Upscale.hlsl:95-107, NIS_Sharpen.hlsl:93-105; core/foveation.py::
// tile_mask): the centre of the (tw x th) tile holding (x, y), +(tw/2, th/2),
// against both eye centres of the cbuffer row c = (cx1, cy1, cx2, cy2,
// radius_sq).
__device__ __forceinline__ bool inside_circle(const int64_t* c, int x, int y, int tw, int th) {
  const int64_t gx = (x / tw) * tw + tw / 2;
  const int64_t gy = (y / th) * th + th / 2;
  const int64_t dx1 = c[0] - gx, dy1 = c[1] - gy;
  const int64_t dx2 = c[2] - gx, dy2 = c[3] - gy;
  return dx1 * dx1 + dy1 * dy1 <= c[4] || dx2 * dx2 + dy2 * dy2 <= c[4];
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Channel c (0 R, 1 G, 2 B, 3 A) of a texel, decoded to [0, 1].
__device__ __forceinline__ float channel(uint32_t texel, int c) {
  return static_cast<float>((texel >> (8 * c)) & 255u) * ffx::kInv255;
}

__device__ __forceinline__ uint32_t pack(float r, float g, float b, float a) {
  return static_cast<uint32_t>(ffx::unorm8_round(r)) |
         (static_cast<uint32_t>(ffx::unorm8_round(g)) << 8) |
         (static_cast<uint32_t>(ffx::unorm8_round(b)) << 16) |
         (static_cast<uint32_t>(ffx::unorm8_round(a)) << 24);
}

// Bilinear linear-clamp tap of all four channels (ops/bilinear.py::
// bilinear_gather): floor x0/y0 and fractions fx/fy from the host maps,
// corners clamped to the image, read from device memory.
__device__ __forceinline__ void bilinear_rgba(const uint32_t* img, int pitch, int h, int w, int x0,
                                              int y0, float fx, float fy, float out[4]) {
  const int sx0 = clampi(x0, 0, w - 1), sx1 = clampi(x0 + 1, 0, w - 1);
  const int sy0 = clampi(y0, 0, h - 1), sy1 = clampi(y0 + 1, 0, h - 1);
  const uint32_t c00 = img[static_cast<size_t>(sy0) * pitch + sx0];
  const uint32_t c10 = img[static_cast<size_t>(sy0) * pitch + sx1];
  const uint32_t c01 = img[static_cast<size_t>(sy1) * pitch + sx0];
  const uint32_t c11 = img[static_cast<size_t>(sy1) * pitch + sx1];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[c] = ffx::bilerp(channel(c00, c), channel(c10, c), channel(c01, c), channel(c11, c), fx, fy);
}

}  // namespace rgba8
