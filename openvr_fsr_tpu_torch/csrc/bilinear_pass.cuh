// bilinear_pass.cuh — the upscalers' foveation fallback outside the circle:
// one barrier-free pass that fsr_fused.cu (B1), nis_scaler.cu (B3) and
// cas_upscale.cu (B5) share.
//
// All three compute the same thing there: the bilinear linear-clamp tap of
// the input (ops/bilinear.py::bilinear_gather; fsr_easu.hlsl:33-36,
// NIS_Upscale.hlsl:77-90) from the map row the kernel names, G and B times
// the debug tint, alpha 1, stored in the frame's format (the codec C,
// codec.cuh). B1 adds the UNORM round trip of the reference's intermediate
// texture, in the same format (kRoundTrip). They differ only in the map
// row (B1 and B5 the bilinear row 1, B3 the DirectCopy rows col_i[3] /
// col_f[2]) and the tile shape (B1 and B5 32x32, B3 32x48).
//
// What bounds it: bytes (four taps and one store of a texel, 4 or 8 bytes,
// per output, the taps served by L1 and L2). So each CTA takes one tile of
// the host's outside list; each of its 256 threads 4 neighbouring outputs of
// one row (a tile of more than 1,024 outputs loops), read straight from
// device memory and stored with 16-byte stores where the row start allows
// it. No shared memory, no barrier.
//
// A row-band strip (B1 and B5, kBand): the launch computes the output rows
// [band.row0, band.row1) of the full image into a (B, band.rows, out_w)
// buffer from an input strip of in_rows rows that starts at the image's
// row in_row_base. Every row index stays global (clamped against the full
// image's in_h): the caller passes img and out rebased by in_row_base and
// band.row0 rows, so that a global row addresses the strip, and an output
// row outside the band is neither computed nor stored. The band travels in
// a kernel parameter of its own: the whole output (and B3) launch the pass
// without it, with PR 12's parameters and code.
#pragma once

#include <cstdint>

#include "codec.cuh"
#include "ffx_math.cuh"

namespace bilinear_pass {

constexpr int kThreads = 256;
constexpr int kRun = 4;   // neighbouring outputs of one row per thread

template <class C>
struct Args {
  const typename C::Texel* img;   // (B, in_rows, pitch) texels
  typename C::Texel* out;         // (B, out_h, out_w) texels
  const int32_t* x0;      // (out_w,): the bilinear floor per output column
  const float* fx;        // (out_w,): its fraction
  const int32_t* y0;      // (out_h,): per output row
  const float* fy;        // (out_h,)
  const int32_t* tiles;   // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int in_h, in_w, in_rows, pitch, out_h, out_w, tiles_x, tiles_y;
  float tint;
};

// A band of output rows [row0, row1); rows = row1 - row0, the rows per batch
// entry of the band's output buffer.
struct Band {
  int row0, row1, rows;
};

// One output from its four taps (c00 at the floor, c10 right of it, c01
// below): bilerp per channel, the UNORM round trip where kRoundTrip, G and
// B times the tint, alpha 1.
template <bool kRoundTrip, class C>
__device__ __forceinline__ typename C::Texel texel(typename C::Texel c00, typename C::Texel c10,
                                                   typename C::Texel c01, typename C::Texel c11,
                                                   float fx, float fy, float tint) {
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[c] = ffx::bilerp(C::channel(c00, c), C::channel(c10, c), C::channel(c01, c),
                       C::channel(c11, c), fx, fy);
    if (kRoundTrip) q[c] = C::roundtrip(q[c]);
  }
  return C::pack(q[0], q[1] * tint, q[2] * tint, 1.0f);
}

// Run r (kRun outputs of one row) of tile (b, tx, ty).
template <int TW, int TH, bool kRoundTrip, bool kBand, class C>
__device__ __forceinline__ void run_outputs(const Args<C>& a, const Band& band, int b, int tx,
                                            int ty, int r) {
  using Texel = typename C::Texel;
  constexpr int kPerRow = TW / kRun;
  const int oy = ty * TH + r / kPerRow;
  const int ox = tx * TW + (r % kPerRow) * kRun;
  if constexpr (kBand) {
    if (oy < band.row0 || oy >= band.row1 || ox >= a.out_w) return;
  } else {
    if (oy >= a.out_h || ox >= a.out_w) return;
  }
  const Texel* img = a.img + static_cast<size_t>(b) * a.in_rows * a.pitch;
  const int y0 = a.y0[oy];
  const float fy = a.fy[oy];
  const Texel* r0 = img + static_cast<size_t>(rgba8::clampi(y0, 0, a.in_h - 1)) * a.pitch;
  const Texel* r1 = img + static_cast<size_t>(rgba8::clampi(y0 + 1, 0, a.in_h - 1)) * a.pitch;
  const int n = min(kRun, a.out_w - ox);
  Texel v[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j >= n) break;
    const int x0 = a.x0[ox + j];
    const int sx0 = rgba8::clampi(x0, 0, a.in_w - 1), sx1 = rgba8::clampi(x0 + 1, 0, a.in_w - 1);
    v[j] = texel<kRoundTrip, C>(r0[sx0], r0[sx1], r1[sx0], r1[sx1], a.fx[ox + j], fy, a.tint);
  }
  Texel* dst = a.out + (static_cast<size_t>(b) * (kBand ? band.rows : a.out_h) + oy) * a.out_w + ox;
  if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    C::store4(dst, v);
  } else {
    for (int j = 0; j < n; ++j) dst[j] = v[j];
  }
}

// The body of a (TW x TH)-tile pass kernel: the caller's __global__ with
// __launch_bounds__(kThreads) calls it with one CTA per tile of a.tiles
// (kBand: with the band's rows).
template <int TW, int TH, bool kRoundTrip, class C, bool kBand = false>
__device__ __forceinline__ void run(const Args<C>& a, const Band& band = Band{}) {
  static_assert(TW % kRun == 0, "a row of the tile holds whole runs");
  constexpr int kRuns = TW * TH / kRun;
  const int id = a.tiles[blockIdx.x];
  const int per = a.tiles_x * a.tiles_y;
  const int b = id / per;
  const int rem = id - b * per;
  const int ty = rem / a.tiles_x;
  const int tx = rem - ty * a.tiles_x;
  if constexpr (kRuns == kThreads) {
    run_outputs<TW, TH, kRoundTrip, kBand, C>(a, band, b, tx, ty, threadIdx.x);
  } else {
    for (int r = threadIdx.x; r < kRuns; r += kThreads)
      run_outputs<TW, TH, kRoundTrip, kBand, C>(a, band, b, tx, ty, r);
  }
}

// Host side of a strip launch (B1, B5). Whether the strip and the band are
// admissible: the band is a non-empty range of the output's rows; the whole
// output takes the whole image (row 0, at least in_h rows: a pre-padded
// frame may hold more); a smaller band a strip inside the image. That the
// strip holds every row the band's tiles read, the host has established
// from the tables (kernels/_maps.py::band_strip).
inline bool strip_is_valid(int in_h, int in_row_base, int in_rows, int out_h, int out_row0,
                           int out_row1) {
  if (in_row_base < 0 || in_row_base >= in_h || in_rows <= 0 || out_row0 < 0 ||
      out_row0 >= out_row1 || out_row1 > out_h)
    return false;
  if (out_row0 == 0 && out_row1 == out_h) return in_row_base == 0 && in_rows >= in_h;
  return in_row_base + in_rows <= in_h;
}

// A strip's buffer rebased by `rows` rows of `pitch` elements, so that row y
// of the full image (or output) addresses the buffer's row y - rows. Formed
// as an address: the kernels add a global row's offset back before any
// access, which then lies in the buffer.
template <class T>
inline T* rebase(T* buffer, int rows, int pitch) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(buffer) -
                              static_cast<uintptr_t>(rows) * static_cast<uintptr_t>(pitch) *
                                  sizeof(T));
}

}  // namespace bilinear_pass
