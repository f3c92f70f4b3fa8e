// rgba8.cuh — the packed RGBA8 texel codec and an integer clamp, which
// every kernel of the port shares (codec.cuh wraps this codec beside the
// 10-bit one). (The reference's foveation circle test runs on the host:
// kernels/_maps.py::group_classes.)
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

}  // namespace rgba8
