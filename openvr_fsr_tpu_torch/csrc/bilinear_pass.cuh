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
// What bounds it: the latency of a run's two waits on memory, at 36 warps
// per SM (56 registers at 8 bits, 72 at 10). On an NVIDIA H100 80GB HBM3
// at 700 W the pass alone (radius 0, 2 x 1683x1869 -> 2 x 2244x2492) takes
// 0.0485 ms: 1.45 TB/s, 43% of the HBM's 3.35, and about a third of the
// SMs' issue. Its instructions were the bound before, so the pass spends
// few:
//   - the codecs' exact forms (codec.cuh, namespace exact, where each
//     identity is argued): a decode is a byte permute and one FMA, a
//     saturate folds into the multiply or add before it, a round is an add
//     of 2^23 and an encode byte permutes of the sums' bits. No conversion
//     instruction (I2F, FRND and F2I issue at a quarter of the FP32 rate)
//     and no NaN-carrying select: the same bits, as every operand here is
//     finite;
//   - each thread takes a run of kRun outputs down one column of a tile
//     (threads(TW, TH) per CTA): the column's floor, fraction and clamped
//     tap columns load once, every tap of the run loads before any is
//     used, and where each row's floor is the last one's or one further
//     (every step of a scale of at most 1) a row's top lerp is the last
//     one's top or bot, so an output computes at most one new row. A warp
//     is 32 neighbouring columns of the same rows: its taps and its stores
//     are neighbouring texels;
//   - host-made multiply-high divisors split the tile id (a division by a
//     variable compiles to I2F, MUFU and F2I), and a tap's offset within
//     its image is 32-bit.
// The f32 arithmetic is ffx::bilerp's, op for op, then the reciprocal
// decode multiplies and the tint multiply. No shared memory, no barrier.
// texel keeps the codecs' plain forms for nis_inside_kernel's DirectCopy
// blocks.
//
// A row-band strip (B1 and B5, kBand): the launch computes the output rows
// [band.row0, band.row1) of the full image into a (B, band.rows, out_w)
// buffer from an input strip of in_rows rows that starts at the image's
// row in_row_base. Every row index stays global (clamped against the full
// image's in_h): the caller passes img and out rebased by in_row_base and
// band.row0 rows, so that a global row addresses the strip, and an output
// row outside the band is not stored (a run that crosses the band's edge
// computes its rows past the edge as the edge row, within the strip). The
// band travels in a kernel parameter of its own: the whole output (and B3)
// launch the pass without it.
#pragma once

#include <cstdint>

#include "codec.cuh"
#include "ffx_math.cuh"

namespace bilinear_pass {

constexpr int kRun = 8;   // output rows per thread: one column of each tile
// threads per CTA of a (tw x th)-tile pass: one run each
constexpr int threads(int tw, int th) { return tw * th / kRun; }

// n / d by a multiply-high, for 0 <= n < 2^31 (the round-up method of
// Granlund and Montgomery): for d > 1, m = ceil(2^p / d) with
// p = 31 + ceil(log2 d) lies below 2^32, and floor(n * m / 2^p) is
// floor(n / d), since n * (m * d - 2^p) / (d * 2^p) < 2^31 / 2^p <= 1 / d.
// Made on the host once per launch (of), so the pass splits its tile ids
// without a division by a variable, which compiles to I2F, MUFU and F2I.
struct Divisor {
  int d;
  uint32_t m;   // 0 for d == 1
  int shift;    // p - 32
  static Divisor of(int d) {
    int log2 = 0;
    while ((1ll << log2) < d) ++log2;
    if (d == 1) return {1, 0u, 0};
    return {d, static_cast<uint32_t>(((1ull << (31 + log2)) + d - 1) / d), log2 - 1};
  }
  __device__ __forceinline__ int div(int n) const {
    return m ? static_cast<int>(__umulhi(static_cast<uint32_t>(n), m) >> shift) : n;
  }
};

template <class C>
struct Args {
  const typename C::Texel* img;   // (B, in_rows, pitch) texels
  typename C::Texel* out;         // (B, out_h, out_w) texels
  const int32_t* x0;      // (out_w,): the bilinear floor per output column
  const float* fx;        // (out_w,): its fraction
  const int32_t* y0;      // (out_h,): per output row
  const float* fy;        // (out_h,)
  const int32_t* tiles;   // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int in_h, in_w, in_rows, pitch, out_h, out_w;
  float tint;
  Divisor per, cols;      // tiles_y * tiles_x and tiles_x: a tile id's b, ty, tx
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

// p, as an address the compiler cannot see into: a tap's address is then
// a 32-bit offset and one wide multiply-add onto p, where the compiler
// would otherwise fold p's own offset into every tap's 64-bit arithmetic.
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
#ifdef __CUDA_ARCH__
  asm("" : "+l"(p));
#endif
  return p;
}

// An input row's taps t0 (at the floor's column) and t1 (right of it),
// decoded and lerped, c0 * (1 - fx) + c1 * fx per channel: ffx::bilerp's
// top or bot row, op for op.
struct Lerp {
  float c[3];
};

template <class C>
__device__ __forceinline__ Lerp lerp_row(typename C::Texel t0, typename C::Texel t1, float fx,
                                         float gx) {
  Lerp l;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    l.c[c] = __fadd_rn(__fmul_rn(C::exact_channel(t0, c), gx),
                       __fmul_rn(C::exact_channel(t1, c), fx));
  return l;
}

// texel's bits from its rows' lerps, top * (1 - fy) + bot * fy per
// channel as ffx::bilerp ends, through the codec's exact forms
// (codec.cuh). B1's R skips its round trip, whose integer is its encode's
// (codec.cuh, exact: encode).
template <bool kRoundTrip, class C>
__device__ __forceinline__ typename C::Texel exact_texel(const Lerp& top, const Lerp& bot,
                                                         float fy, float tint) {
  const float gy = __fsub_rn(1.0f, fy);
  float q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q[c] = __fadd_rn(__fmul_rn(top.c[c], gy), __fmul_rn(bot.c[c], fy));
    if (kRoundTrip && c > 0) q[c] = C::exact_roundtrip(q[c]);
  }
  return C::exact_pack(q[0], __fmul_rn(q[1], tint), __fmul_rn(q[2], tint));
}

// This thread's run of tile (b, tx, ty): output column ox, kRun rows from
// oy0 (a warp: 32 neighbouring columns of the same rows, so its loads and
// stores take neighbouring texels). The column's floor, fraction and
// clamped taps are loaded once, and every tap of the run before any is
// used, so a run waits on memory twice. Where each row's floor is the last
// one's or one further (every step of a scale of at most 1), a row's top
// lerp is the last one's top or bot, and only a new bot is computed (the
// floor is the same in the whole warp, so the branch is too); otherwise (a
// larger scale) each row computes both: the same values either way. Rows
// outside the output (or the band) are computed as its nearest row and not
// stored. Offsets within one image are 32-bit (the launchers refuse an
// image where they could wrap: offsets_fit).
template <int TW, int TH, bool kRoundTrip, bool kBand, class C>
__device__ __forceinline__ void run_column(const Args<C>& a, const Band& band, int b, int tx,
                                           int ty) {
  using Texel = typename C::Texel;
  static_assert(TH % kRun == 0, "a tile's column holds whole runs");
  const int ox = tx * TW + static_cast<int>(threadIdx.x) % TW;
  const int oy0 = ty * TH + static_cast<int>(threadIdx.x) / TW * kRun;
  const int lo = kBand ? band.row0 : 0, hi = (kBand ? band.row1 : a.out_h) - 1;
  if (ox >= a.out_w || oy0 > hi || oy0 + kRun <= lo) return;
  const Texel* img = opaque(a.img + static_cast<size_t>(b) * a.in_rows * a.pitch);
  const int x0 = a.x0[ox];
  const float fx = a.fx[ox], gx = __fsub_rn(1.0f, fx);
  const uint32_t sx0 = rgba8::clampi(x0, 0, a.in_w - 1), sx1 = rgba8::clampi(x0 + 1, 0, a.in_w - 1);
  int y0[kRun];
  float fy[kRun];
  bool slides = true;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int oy = rgba8::clampi(oy0 + j, lo, hi);
    y0[j] = a.y0[oy];
    fy[j] = a.fy[oy];
    if (j > 0) slides = slides && static_cast<uint32_t>(y0[j] - y0[j - 1]) <= 1u;
  }
  const uint32_t pitch = static_cast<uint32_t>(a.pitch);
  const auto row = [&](int y) {
    return static_cast<uint32_t>(rgba8::clampi(y, 0, a.in_h - 1)) * pitch;
  };
  Texel v[kRun];
  if (slides) {
    // t[0]: the first top row's taps; t[j + 1]: row j's bot row's
    Texel t0[kRun + 1], t1[kRun + 1];
#pragma unroll
    for (int k = 0; k <= kRun; ++k) {
      const uint32_t r = row(k == 0 ? y0[0] : y0[k - 1] + 1);
      t0[k] = __ldg(img + (r + sx0));
      t1[k] = __ldg(img + (r + sx1));
    }
    Lerp top = lerp_row<C>(t0[0], t1[0], fx, gx), bot = lerp_row<C>(t0[1], t1[1], fx, gx);
    v[0] = exact_texel<kRoundTrip, C>(top, bot, fy[0], a.tint);
#pragma unroll
    for (int j = 1; j < kRun; ++j) {
      if (y0[j] != y0[j - 1]) {
        top = bot;
        bot = lerp_row<C>(t0[j + 1], t1[j + 1], fx, gx);
      }
      v[j] = exact_texel<kRoundTrip, C>(top, bot, fy[j], a.tint);
    }
  } else {
    Texel t[kRun][4];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const uint32_t r0 = row(y0[j]), r1 = row(y0[j] + 1);
      t[j][0] = __ldg(img + (r0 + sx0));
      t[j][1] = __ldg(img + (r0 + sx1));
      t[j][2] = __ldg(img + (r1 + sx0));
      t[j][3] = __ldg(img + (r1 + sx1));
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      v[j] = exact_texel<kRoundTrip, C>(lerp_row<C>(t[j][0], t[j][1], fx, gx),
                                        lerp_row<C>(t[j][2], t[j][3], fx, gx), fy[j], a.tint);
  }
  Texel* dst = a.out + static_cast<size_t>(b) * (kBand ? band.rows : a.out_h) * a.out_w + ox;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    if (oy0 + j >= lo && oy0 + j <= hi) dst[static_cast<size_t>(oy0 + j) * a.out_w] = v[j];
}

// The body of a (TW x TH)-tile pass kernel: the caller's __global__ with
// __launch_bounds__(threads(TW, TH)) calls it with one CTA per tile of
// a.tiles (kBand: with the band's rows).
template <int TW, int TH, bool kRoundTrip, class C, bool kBand = false>
__device__ __forceinline__ void run(const Args<C>& a, const Band& band = Band{}) {
  const int id = a.tiles[blockIdx.x];
  const int b = a.per.div(id);
  const int rem = id - b * a.per.d;
  const int ty = a.cols.div(rem);
  const int tx = rem - ty * a.cols.d;
  run_column<TW, TH, kRoundTrip, kBand, C>(a, band, b, tx, ty);
}

// Host side of every launch (B1, B3, B5). Whether a tap's offset within one
// image, the 32-bit row * pitch + column of run_column, cannot wrap: every
// tap lies at a row below in_h (global, in a strip too) and a column below
// in_w <= pitch, so below in_h * pitch texels.
inline bool offsets_fit(int in_h, int pitch) {
  return static_cast<uint64_t>(in_h) * static_cast<uint64_t>(pitch) <= (uint64_t{1} << 32);
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
