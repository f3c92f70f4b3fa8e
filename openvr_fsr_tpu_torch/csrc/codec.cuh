// codec.cuh — the two texel formats the port's kernels take, as codecs that
// every kernel is templated on, and the bilinear tap over either.
//
// The reference passes the game's format through every stage
// (PostProcessor.cpp:63-74, 527): R8G8B8A8 or R10G10B10A2. The JAX package
// runs the first as packed u32 planes and the second as planar f32 texels
// (openvr_fsr_tpu/kernels/_band.py::io_policy); the port keeps each in its
// frame layout:
//   Rgba8    a uint32, R in the low byte (rgba8.cuh): decode u * f32(1/255),
//            encode clamp, * 255, round half to even;
//   Rgb10a2  four uint16 in 8 bytes (the (B, H, W, 4) uint16 frame), loaded
//            as one uint2: x = R | G << 16, y = B | A << 16. RGB decodes as
//            u * f32(1/1023), alpha as a * f32(1/3) (utils/frames.py::
//            to_planar; the whole 16-bit value, never masked to 10 or 2
//            bits, so an out-of-range value saturates at the encode as it
//            does there); the encode clamps, scales by 1023 (RGB) or 3
//            (alpha) and rounds half to even (utils/frames.py::
//            from_planar).
// Each codec gives the texel type, channel(t, c), pack(r, g, b, a),
// roundtrip(v) (the UNORM store and decode of the reference's intermediate
// texture in the texture's own format), and load4 / store4: four
// neighbouring texels through 16-byte operations (one for Rgba8, two for
// Rgb10a2) at a 16-byte aligned address.
#pragma once

#include <cstdint>

#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace codec {

struct Rgba8 {
  using Texel = uint32_t;
  static __device__ __forceinline__ float channel(Texel t, int c) { return rgba8::channel(t, c); }
  static __device__ __forceinline__ Texel pack(float r, float g, float b, float a) {
    return rgba8::pack(r, g, b, a);
  }
  static __device__ __forceinline__ float roundtrip(float v) { return ffx::unorm8_roundtrip(v); }
  static __device__ __forceinline__ void load4(const Texel* src, Texel v[4]) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store4(Texel* dst, const Texel v[4]) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};

struct Rgb10a2 {
  using Texel = uint2;
  static __device__ __forceinline__ float channel(Texel t, int c) {
    const uint32_t w = c < 2 ? t.x : t.y;
    const uint32_t u = (c & 1) ? w >> 16 : w & 0xffffu;
    return static_cast<float>(u) * (c == 3 ? ffx::kInv3 : ffx::kInv1023);
  }
  static __device__ __forceinline__ Texel pack(float r, float g, float b, float a) {
    return make_uint2(
        static_cast<uint32_t>(ffx::unorm10_round(r)) |
            (static_cast<uint32_t>(ffx::unorm10_round(g)) << 16),
        static_cast<uint32_t>(ffx::unorm10_round(b)) |
            (static_cast<uint32_t>(ffx::unorm2_round(a)) << 16));
  }
  static __device__ __forceinline__ float roundtrip(float v) { return ffx::unorm10_roundtrip(v); }
  static __device__ __forceinline__ void load4(const Texel* src, Texel v[4]) {
    const uint4 a = reinterpret_cast<const uint4*>(src)[0];
    const uint4 b = reinterpret_cast<const uint4*>(src)[1];
    v[0] = make_uint2(a.x, a.y);
    v[1] = make_uint2(a.z, a.w);
    v[2] = make_uint2(b.x, b.y);
    v[3] = make_uint2(b.z, b.w);
  }
  static __device__ __forceinline__ void store4(Texel* dst, const Texel v[4]) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0].x, v[0].y, v[1].x, v[1].y);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[2].x, v[2].y, v[3].x, v[3].y);
  }
};

// Bilinear linear-clamp tap of all four channels (ops/bilinear.py::
// bilinear_gather): floor x0/y0 and fractions fx/fy from the host maps,
// corners clamped to the image, read from device memory.
template <class C>
__device__ __forceinline__ void bilinear_rgba(const typename C::Texel* img, int pitch, int h, int w,
                                              int x0, int y0, float fx, float fy, float out[4]) {
  const int sx0 = rgba8::clampi(x0, 0, w - 1), sx1 = rgba8::clampi(x0 + 1, 0, w - 1);
  const int sy0 = rgba8::clampi(y0, 0, h - 1), sy1 = rgba8::clampi(y0 + 1, 0, h - 1);
  const typename C::Texel c00 = img[static_cast<size_t>(sy0) * pitch + sx0];
  const typename C::Texel c10 = img[static_cast<size_t>(sy0) * pitch + sx1];
  const typename C::Texel c01 = img[static_cast<size_t>(sy1) * pitch + sx0];
  const typename C::Texel c11 = img[static_cast<size_t>(sy1) * pitch + sx1];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[c] = ffx::bilerp(C::channel(c00, c), C::channel(c10, c), C::channel(c01, c),
                         C::channel(c11, c), fx, fy);
}

}  // namespace codec
