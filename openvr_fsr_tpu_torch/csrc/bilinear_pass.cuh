// bilinear_pass.cuh — the upscalers' foveation fallback outside the circle:
// one barrier-free pass that fsr_fused.cu (B1), nis_scaler.cu (B3) and
// cas_upscale.cu (B5) share.
//
// All three compute the same thing there: the bilinear linear-clamp tap of
// the input (ops/bilinear.py::bilinear_gather; fsr_easu.hlsl:33-36,
// NIS_Upscale.hlsl:77-90) from the map row the kernel names, G and B times
// the debug tint, alpha 1, stored as packed RGBA8. B1 adds the UNORM8 round
// trip of the reference's intermediate texture (kRoundTrip). They differ
// only in the map row (B1 and B5 the bilinear row 1, B3 the DirectCopy
// rows col_i[3] / col_f[2]) and the tile shape (B1 and B5 32x32, B3 32x48).
//
// What bounds it: bytes (four taps and one store of 4 bytes per output, the
// taps served by L1 and L2). So each CTA takes one tile of the host's
// outside list; each of its 256 threads 4 neighbouring outputs of one row
// (a tile of more than 1,024 outputs loops), read straight from device
// memory and stored with one 16-byte store where the row start allows it.
// No shared memory, no barrier.
#pragma once

#include <cstdint>

#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace bilinear_pass {

constexpr int kThreads = 256;
constexpr int kRun = 4;   // neighbouring outputs of one row per thread

struct Args {
  const uint32_t* img;    // (B, in_rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;          // (B, out_h, out_w) packed RGBA8
  const int32_t* x0;      // (out_w,): the bilinear floor per output column
  const float* fx;        // (out_w,): its fraction
  const int32_t* y0;      // (out_h,): per output row
  const float* fy;        // (out_h,)
  const int32_t* tiles;   // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int in_h, in_w, in_rows, pitch, out_h, out_w, tiles_x, tiles_y;
  float tint;
};

// One output from its four taps (c00 at the floor, c10 right of it, c01
// below): bilerp per channel, the UNORM8 round trip where kRoundTrip, G and
// B times the tint, alpha 1.
template <bool kRoundTrip>
__device__ __forceinline__ uint32_t texel(uint32_t c00, uint32_t c10, uint32_t c01, uint32_t c11,
                                          float fx, float fy, float tint) {
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[c] = ffx::bilerp(rgba8::channel(c00, c), rgba8::channel(c10, c), rgba8::channel(c01, c),
                       rgba8::channel(c11, c), fx, fy);
    if (kRoundTrip) q[c] = ffx::unorm8_roundtrip(q[c]);
  }
  return rgba8::pack(q[0], q[1] * tint, q[2] * tint, 1.0f);
}

// Run r (kRun outputs of one row) of tile (b, tx, ty).
template <int TW, int TH, bool kRoundTrip>
__device__ __forceinline__ void run_outputs(const Args& a, int b, int tx, int ty, int r) {
  constexpr int kPerRow = TW / kRun;
  const int oy = ty * TH + r / kPerRow;
  const int ox = tx * TW + (r % kPerRow) * kRun;
  if (oy >= a.out_h || ox >= a.out_w) return;
  const uint32_t* img = a.img + static_cast<size_t>(b) * a.in_rows * a.pitch;
  const int y0 = a.y0[oy];
  const float fy = a.fy[oy];
  const uint32_t* r0 = img + static_cast<size_t>(rgba8::clampi(y0, 0, a.in_h - 1)) * a.pitch;
  const uint32_t* r1 = img + static_cast<size_t>(rgba8::clampi(y0 + 1, 0, a.in_h - 1)) * a.pitch;
  const int n = min(kRun, a.out_w - ox);
  uint32_t v[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= n) break;
    const int x0 = a.x0[ox + j];
    const int sx0 = rgba8::clampi(x0, 0, a.in_w - 1), sx1 = rgba8::clampi(x0 + 1, 0, a.in_w - 1);
    v[j] = texel<kRoundTrip>(r0[sx0], r0[sx1], r1[sx0], r1[sx1], a.fx[ox + j], fy, a.tint);
  }
  uint32_t* dst = a.out + (static_cast<size_t>(b) * a.out_h + oy) * a.out_w + ox;
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n; ++j) dst[j] = v[j];
  }
}

// The body of a (TW x TH)-tile pass kernel: the caller's __global__ with
// __launch_bounds__(kThreads) calls it with one CTA per tile of a.tiles.
template <int TW, int TH, bool kRoundTrip>
__device__ __forceinline__ void run(const Args& a) {
  static_assert(TW % kRun == 0, "a row of the tile holds whole runs");
  constexpr int kRuns = TW * TH / kRun;
  const int id = a.tiles[blockIdx.x];
  const int per = a.tiles_x * a.tiles_y;
  const int b = id / per;
  const int rem = id - b * per;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  if constexpr (kRuns == kThreads) {
    run_outputs<TW, TH, kRoundTrip>(a, b, tx, ty, threadIdx.x);
  } else {
    for (int r = threadIdx.x; r < kRuns; r += kThreads) run_outputs<TW, TH, kRoundTrip>(a, b, tx, ty, r);
  }
}

}  // namespace bilinear_pass
