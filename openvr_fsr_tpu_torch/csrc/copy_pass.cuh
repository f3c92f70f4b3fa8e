// copy_pass.cuh — the sharpen-only kernels' foveation fallback outside the
// circle: one barrier-free pass that cas_sharpen.cu (B6), nis_sharpen.cu
// (B4) and rcas_sharpen.cu (B2) share, the counterpart of the upscalers'
// bilinear_pass.cuh.
//
// At renderScale 1 the output outside the circle is the source texel itself:
// R, G times the debug tint, B times the tint, stored in the frame's format
// (the codec C, codec.cuh). The kernels differ only in the alpha
// (kKeepAlpha): CAS sharpen and RCAS sharpen keep the source's (JAX
// kernels/cas.py:483-490, kernels/rcas.py:112-115), NVSharpen writes 1
// (kernels/nis.py:238-241).
//
// What bounds it: bytes, one texel load and one texel store per output (4
// bytes each in RGBA8, 8 in R10G10B10A2). So each CTA takes one tile of the
// host's outside list; each of its 256 threads 4 neighbouring outputs of one
// row (a tile of more than 1,024 outputs loops), loaded with 16-byte loads
// (one in RGBA8, two in R10G10B10A2) where the input row address allows it
// and stored the same way where the output's does. No shared memory, no
// barrier.
#pragma once

#include <cstdint>

#include "codec.cuh"

namespace copy_pass {

constexpr int kThreads = 256;
constexpr int kRun = 4;   // neighbouring outputs of one row per thread

template <class C>
struct Args {
  const typename C::Texel* img;   // (B, rows, pitch) texels
  typename C::Texel* out;         // (B, h, w) texels
  const int32_t* tiles;   // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int h, w, rows, pitch, tiles_x, tiles_y;
  float tint;
};

// One output from its source texel: G and B times the tint, the source's
// alpha where kKeepAlpha, else 1.
template <bool kKeepAlpha, class C>
__device__ __forceinline__ typename C::Texel texel(typename C::Texel t, float tint) {
  return C::pack(C::channel(t, 0), C::channel(t, 1) * tint, C::channel(t, 2) * tint,
                 kKeepAlpha ? C::channel(t, 3) : 1.0f);
}

// Run r (kRun outputs of one row) of tile (b, tx, ty).
template <int TW, int TH, bool kKeepAlpha, class C>
__device__ __forceinline__ void run_outputs(const Args<C>& a, int b, int tx, int ty, int r) {
  using Texel = typename C::Texel;
  constexpr int kPerRow = TW / kRun;
  const int y = ty * TH + r / kPerRow;
  const int x = tx * TW + (r % kPerRow) * kRun;
  if (y >= a.h || x >= a.w) return;
  const int n = min(kRun, a.w - x);
  const Texel* src = a.img + (static_cast<size_t>(b) * a.rows + y) * a.pitch + x;
  Texel v[kRun] = {};
  if (n == kRun && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    C::load4(src, v);
  } else {
    for (int j = 0; j < n; ++j) v[j] = src[j];
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) v[j] = texel<kKeepAlpha, C>(v[j], a.tint);
  Texel* dst = a.out + (static_cast<size_t>(b) * a.h + y) * a.w + x;
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    C::store4(dst, v);
  } else {
    for (int j = 0; j < n; ++j) dst[j] = v[j];
  }
}

// The body of a (TW x TH)-tile pass kernel: the caller's __global__ with
// __launch_bounds__(kThreads) calls it with one CTA per tile of a.tiles.
template <int TW, int TH, bool kKeepAlpha, class C>
__device__ __forceinline__ void run(const Args<C>& a) {
  static_assert(TW % kRun == 0, "a row of the tile holds whole runs");
  constexpr int kRuns = TW * TH / kRun;
  const int id = a.tiles[blockIdx.x];
  const int per = a.tiles_x * a.tiles_y;
  const int b = id / per;
  const int rem = id - b * per;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  if constexpr (kRuns == kThreads) {
    run_outputs<TW, TH, kKeepAlpha, C>(a, b, tx, ty, threadIdx.x);
  } else {
    for (int r = threadIdx.x; r < kRuns; r += kThreads) run_outputs<TW, TH, kKeepAlpha, C>(a, b, tx, ty, r);
  }
}

}  // namespace copy_pass
