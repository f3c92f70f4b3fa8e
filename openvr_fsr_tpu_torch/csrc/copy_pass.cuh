// copy_pass.cuh — the sharpen-only kernels' foveation fallback outside the
// circle: one barrier-free pass that cas_sharpen.cu (B6), nis_sharpen.cu
// (B4) and rcas_sharpen.cu (B2) share, the counterpart of the upscalers'
// bilinear_pass.cuh.
//
// At renderScale 1 the output outside the circle is the source texel itself:
// R, G times the debug tint, B times the tint, stored as packed RGBA8. The
// kernels differ only in the alpha (kKeepAlpha): CAS sharpen and RCAS
// sharpen keep the source's (JAX kernels/cas.py:483-490, kernels/rcas.py:
// 112-115), NVSharpen writes 1 (kernels/nis.py:238-241).
//
// What bounds it: bytes, one 4-byte load and one 4-byte store per output.
// So each CTA takes one tile of the host's outside list; each of its 256
// threads 4 neighbouring outputs of one row (a tile of more than 1,024
// outputs loops), loaded with one 16-byte load where the input row address
// allows it and stored with one 16-byte store where the output's does. No
// shared memory, no barrier.
#pragma once

#include <cstdint>

#include "rgba8.cuh"

namespace copy_pass {

constexpr int kThreads = 256;
constexpr int kRun = 4;   // neighbouring outputs of one row per thread

struct Args {
  const uint32_t* img;    // (B, rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;          // (B, h, w) packed RGBA8
  const int32_t* tiles;   // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int h, w, rows, pitch, tiles_x, tiles_y;
  float tint;
};

// One output from its source texel: G and B times the tint, the source's
// alpha where kKeepAlpha, else 1.
template <bool kKeepAlpha>
__device__ __forceinline__ uint32_t texel(uint32_t t, float tint) {
  return rgba8::pack(rgba8::channel(t, 0), rgba8::channel(t, 1) * tint,
                     rgba8::channel(t, 2) * tint, kKeepAlpha ? rgba8::channel(t, 3) : 1.0f);
}

// Run r (kRun outputs of one row) of tile (b, tx, ty).
template <int TW, int TH, bool kKeepAlpha>
__device__ __forceinline__ void run_outputs(const Args& a, int b, int tx, int ty, int r) {
  constexpr int kPerRow = TW / kRun;
  const int y = ty * TH + r / kPerRow;
  const int x = tx * TW + (r % kPerRow) * kRun;
  if (y >= a.h || x >= a.w) return;
  const int n = min(kRun, a.w - x);
  const uint32_t* src = a.img + (static_cast<size_t>(b) * a.rows + y) * a.pitch + x;
  uint32_t v[kRun] = {0u, 0u, 0u, 0u};
  if (n == kRun && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    for (int j = 0; j < n; ++j) v[j] = src[j];
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) v[j] = texel<kKeepAlpha>(v[j], a.tint);
  uint32_t* dst = a.out + (static_cast<size_t>(b) * a.h + y) * a.w + x;
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n; ++j) dst[j] = v[j];
  }
}

// The body of a (TW x TH)-tile pass kernel: the caller's __global__ with
// __launch_bounds__(kThreads) calls it with one CTA per tile of a.tiles.
template <int TW, int TH, bool kKeepAlpha>
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
    run_outputs<TW, TH, kKeepAlpha>(a, b, tx, ty, threadIdx.x);
  } else {
    for (int r = threadIdx.x; r < kRuns; r += kThreads) run_outputs<TW, TH, kKeepAlpha>(a, b, tx, ty, r);
  }
}

}  // namespace copy_pass
