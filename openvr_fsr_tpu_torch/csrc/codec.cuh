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
// Rgb10a2) at a 16-byte aligned address; and the exact forms of the first
// three that the bilinear pass takes (exact_channel, exact_roundtrip,
// exact_pack: namespace exact below).
#pragma once

#include <cstdint>

#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace codec {

// The exact forms of the decode, saturate, round and encode, for the
// bilinear pass outside the foveation circle (bilinear_pass.cuh): the bits
// of channel, roundtrip and pack with no conversion instruction (I2F, F2I,
// FRND) and no NaN-carrying select, each an identity on what the pass
// gives it:
//   decode    a channel's integer u < 2^23 permuted into the low bytes of
//             2^23's bits (0x4B000000) is the float 2^23 + u; one FMA
//             (2^23 + u) * inv - 2^23 * inv is u * inv before its single
//             rounding (2^23 * inv is a float: a power of two times one),
//             so it gives the plain decode's product
//             static_cast<float>(u) * inv;
//   saturate  __saturatef is ffx::sat but for a NaN (0, where sat keeps
//             it) and maybe the sign of a zero. The pass holds no NaN:
//             every operand is a decoded integer of at most 65,535, a host
//             table's fraction in [0, 1] or the tint (0.7 or 1), so every
//             value it forms is finite and bounded; a zero of either sign
//             rounds to the same 0 below;
//   round     y = sat(v) * scale lies in [0, 1023] (scale 255 or 1023), so
//             y + 2^23 lies in [2^23, 2^24), where the floats are the
//             integers: the add's round to nearest even is 2^23 + rint(y)
//             (the bias is even, so a tie goes to the even integer, as
//             rintf's does). Its bits are 2^23's with rint(y) in the low
//             10 bits: the encode's integer, and the decode above of those
//             bits is the round trip's rint(y) * inv. A bias 2^23 + m, m
//             even and m + 1023 < 2^23, rounds the same and carries m in
//             the bits above: kAlpha8Bias carries the RGBA8 alpha byte;
//   encode    the encode of a round trip's value is the encode of the
//             value: sat(rint(y) * inv) * scale rounds to rint(y) for every
//             integer of [0, scale] (tests/test_torch_exact_codec.py tries
//             each), so a channel whose round trip goes straight to the
//             encode (B1's R) skips it;
//   pack      byte permutes gather the low bits into the texel.
// The __*_rn intrinsics keep every op as written (no contraction). The
// inside kernels keep channel, roundtrip and pack: their operands may hold
// a NaN.
namespace exact {

constexpr uint32_t kTwo23Bits = 0x4B000000u;   // the bits of 2^23
constexpr float kTwo23 = 8388608.0f;
constexpr float kAlpha8Bias = 8453888.0f;      // 2^23 + 0xFF00: 255 in bits 8-15

// u * inv from 2^23's bits with u < 2^23 in their low bits
__device__ __forceinline__ float decode(uint32_t bits, float inv) {
  return __fmaf_rn(__uint_as_float(bits), inv, -kTwo23 * inv);
}
// the bits of bias + rint(sat(v) * scale), for scale at most 1023
__device__ __forceinline__ uint32_t round_bits(float v, float scale, float bias = kTwo23) {
  return __float_as_uint(__fadd_rn(__fmul_rn(__saturatef(v), scale), bias));
}

}  // namespace exact

struct Rgba8 {
  using Texel = uint32_t;
  static __device__ __forceinline__ float channel(Texel t, int c) { return rgba8::channel(t, c); }
  static __device__ __forceinline__ Texel pack(float r, float g, float b, float a) {
    return rgba8::pack(r, g, b, a);
  }
  static __device__ __forceinline__ float roundtrip(float v) { return ffx::unorm8_roundtrip(v); }
  // channel(t, c) of an RGB channel: byte c in 2^23's bits
  static __device__ __forceinline__ float exact_channel(Texel t, int c) {
    return exact::decode(__byte_perm(t, exact::kTwo23Bits, 0x7440u | c), ffx::kInv255);
  }
  static __device__ __forceinline__ float exact_roundtrip(float v) {
    return exact::decode(exact::round_bits(v, 255.0f), ffx::kInv255);
  }
  // pack(r, g, b, 1.0f): R's and G's low bytes, then B's low byte and the
  // alpha 255 from B's sum (kAlpha8Bias)
  static __device__ __forceinline__ Texel exact_pack(float r, float g, float b) {
    const uint32_t rg =
        __byte_perm(exact::round_bits(r, 255.0f), exact::round_bits(g, 255.0f), 0x0040u);
    return __byte_perm(rg, exact::round_bits(b, 255.0f, exact::kAlpha8Bias), 0x5410u);
  }
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
  // channel(t, c) of an RGB channel: the word's low or high 16 bits in
  // 2^23's bits
  static __device__ __forceinline__ float exact_channel(Texel t, int c) {
    const uint32_t w = c < 2 ? t.x : t.y;
    return exact::decode(__byte_perm(w, exact::kTwo23Bits, (c & 1) ? 0x7432u : 0x7410u),
                         ffx::kInv1023);
  }
  static __device__ __forceinline__ float exact_roundtrip(float v) {
    return exact::decode(exact::round_bits(v, 1023.0f), ffx::kInv1023);
  }
  // pack(r, g, b, 1.0f): each sum's low 16 bits (bits 10-15 are 0), and the
  // alpha 3
  static __device__ __forceinline__ Texel exact_pack(float r, float g, float b) {
    return make_uint2(
        __byte_perm(exact::round_bits(r, 1023.0f), exact::round_bits(g, 1023.0f), 0x5410u),
        __byte_perm(exact::round_bits(b, 1023.0f), 3u, 0x5410u));
  }
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
