// cas_upscale.cu — FFX CAS sharpen-and-upscale (CasFilter scaling) for
// Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/cas.py::build_cas_upscale
// (pallas_call at :381): per stereo batch, CasFilter with scaling
// (ffx_cas.h:552-892, the mod's cas.upscale.hlsl flags) over 12 taps of the
// 4x4 window around floor(pp), with zero out-of-image taps (CasLoad),
// inside the foveation circle; outside, the bilinear fallback
// (fsr_easu.hlsl:33-36) times the debug tint (kernels/cas.py:345-348); stored
// in the frame's format with alpha 1: packed RGBA8, or R10G10B10A2 as four
// uint16 (the JAX builder's color_bits=10 branch, cas.py:67; the codecs of
// codec.cuh, one instantiation of every kernel each, behind
// cas_upscale_launch and cas_upscale_launch10).
//
// What bounds it: bytes outside the circle (four taps and one texel store
// per output), and inside it the filter's issue: about a hundred f32 ops per
// output, plus its taps. At the full size (2 x 1683x1869 -> 2 x 2244x2492)
// one stereo pair reads 25.2 MB and writes 44.7 MB in RGBA8, 50.3 MB and
// 89.5 MB in R10G10B10A2.
//
// The design, per output tile of 32x32 pixels (2x2 foveation groups of
// 16x16, the reference's circle test being per group):
//   - the host (kernels/_maps.py::cas_upscale_maps) evaluates the circle
//     test once per build and per group and splits the tiles into an inside
//     list (any group inside) and an outside list, as for the fused FSR
//     kernel. No foveation test and no int64 arithmetic runs here.
//   - cas_outside_kernel runs the outside list: the shared bilinear pass
//     (bilinear_pass.cuh, no round trip): 4 outputs of one row per thread
//     straight from device memory, 16-byte stores, no shared memory, no
//     barrier.
//   - cas_inside_kernel runs the inside list, one CTA per tile: the tile's
//     36x36 window (0 outside the image, so a CAS tap reads it as it is) is
//     loaded once and decoded into three f32 planes in shared memory, one
//     barrier; then each thread takes 4 outputs of one column (a warp
//     stores whole rows), unrolled so their loads and math overlap, each
//     reading its 12 taps from the planes (no conversion per tap). An
//     output whose own 16x16 group lies outside the circle takes the
//     bilinear fallback from the decoded planes (its taps are clamped into
//     the image first), so bits never depend on the tile a group sits in.
//     Sliding the tap window down a column's run in registers did not pay,
//     and a cp.async ring could hide only the staging, a small part of the
//     time at radius 0.5: the filter's own instructions take the rest
//     (PERF.md §6).
// Both launch on the caller's stream; an empty list launches nothing. Build
// with --fmad=false: the bits then match the plain torch version
// (kernels/cas.py::cas_upscale_reference).
//
// Row-band strips (the JAX builder's band_range, cas.py:70, 232-245): a
// launch computes the output rows [out_row0, out_row1) of the full image
// into a (B, out_row1 - out_row0, out_w) buffer, from an input strip of
// in_rows rows that starts at the image's row in_row_base, with the full
// image's tables and the band's 32-row tiles in the lists
// (kernels/_maps.py::band_strip finds the strip: every row the tiles read,
// inside the image). Every row index stays global: the window reads 0
// outside the full image (not outside the strip), and the launch rebases
// img by in_row_base rows and out by out_row0 rows, so a global row
// addresses the strip. A tile that a band edge cuts runs in both strips,
// each storing its own rows. The full image is the band [0, out_h) of the
// strip at row 0, through the same entry point and class-kernel bodies; a
// band smaller than the output launches their instantiations with the row
// test before each store and the band's rows in a parameter of their own
// (cas_band_outside_kernel, cas_band_inside_kernel). The whole output's take
// PR 12's parameters and keep its registers and CTAs per SM (PERF.md, PR
// 13).
//
// Half precision (the JAX kernel's precision="half", cas.py:89, 306):
// cas_half_inside_kernel is the inside kernel's body with CasFilter in bf16
// op by op (cas::upscale<ffx::Half>): the 12 taps and the fractions are
// rounded to bf16 where they are read (the planes stay f32: the bilinear
// fallback of an outside group in an inside tile reads them, f32 as in
// JAX), the host rounds the sharpness; the outside pass is the same. One
// instantiation per codec behind cas_upscale_launch_h and
// cas_upscale_launch10_h, and a band one (cas_band_half_inside_kernel) for
// the half strips, as the JAX builder takes band_range and
// precision="half" together (cas.py:67-70); a band's outside pass is
// cas_band_outside_kernel at both precisions.

#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear_pass.cuh"
#include "cas_math.cuh"
#include "codec.cuh"
#include "ffx_math.cuh"

namespace {

constexpr int kGroup = 16;     // the foveation group edge
constexpr int kTile = 32;      // CTA output tile edge (kernels/_maps.py FSR_TILE)
constexpr int kWin = 36;       // staged input window edge (kernels/_maps.py CAS_IN_TILE)
constexpr int kThreads = 256;
constexpr int kRun = kTile * kTile / kThreads;   // outputs per thread (4), one column

template <class C>
struct Params {
  const typename C::Texel* img;   // (B, in_rows, pitch) texels, rebased: img + y * pitch is image row y
  typename C::Texel* out;         // (B, rows of the band, out_w) texels, rebased: out + y * out_w is output row y
  const int32_t* col_i;       // (2, out_w): CAS floor fx, bilinear x0
  const float* col_f;         // (2, out_w): CAS fraction ppx, bilinear fx
  const int32_t* row_i;       // (2, out_h): CAS floor fy, bilinear y0
  const float* row_f;         // (2, out_h): CAS fraction ppy, bilinear fy
  const int32_t* tile_x0;     // (tiles_x,): first staged input column (may be < 0)
  const int32_t* tile_y0;     // (tiles_y,): first staged input row (may be < 0)
  const int32_t* group_cls;   // (B, groups_y, groups_x): 1 inside the circle
  const int32_t* tiles;       // the inside list: b * tiles_y * tiles_x + ty * tiles_x + tx
  int in_h, in_w, in_rows, pitch, out_h, out_w;
  int tiles_x, tiles_y, groups_x, groups_y;
  float sharp, tint;
};

using bilinear_pass::Band;
using bilinear_pass::rebase;
using bilinear_pass::strip_is_valid;
using rgba8::clampi;

// The inside kernel's shared memory: the window decoded into R, G, B planes.
struct Smem {
  float c[3][kWin][kWin];
};

// One inside tile (the CTA's of the list) in the working precision P
// (ffx::Full, ffx::Half); kBand: store only the band's rows (a band smaller
// than the output).
template <class C, class P, bool kBand>
__device__ __forceinline__ void inside_tile(const Params<C>& p, const Band& band) {
  using Texel = typename C::Texel;
  __shared__ Smem s;

  const int tid = threadIdx.x;
  const int id = p.tiles[blockIdx.x];
  const int per = p.tiles_x * p.tiles_y;
  const int b = id / per;
  const int ty = (id - b * per) / p.tiles_x;
  const int tx = id - b * per - ty * p.tiles_x;
  const int wx0 = p.tile_x0[tx], wy0 = p.tile_y0[ty];
  const Texel* img = p.img + static_cast<size_t>(b) * p.in_rows * p.pitch;

  // the window, once, decoded; texels outside the image are 0
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int ly = i / kWin, lx = i % kWin;
    const int y = wy0 + ly, x = wx0 + lx;
    const Texel t = (y >= 0 && y < p.in_h && x >= 0 && x < p.in_w)
                        ? img[static_cast<size_t>(y) * p.pitch + x]
                        : Texel{};
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c][ly][lx] = C::channel(t, c);
  }
  __syncthreads();

  // this thread's outputs: column ox, rows oy0 .. oy0 + kRun - 1, all in
  // one group row (kRun divides kGroup)
  const int ox = tx * kTile + tid % kTile, oy0 = ty * kTile + (tid / kTile) * kRun;
  if (ox >= p.out_w || oy0 >= (kBand ? band.row1 : p.out_h) ||
      (kBand && oy0 + kRun <= band.row0))
    return;
  Texel* out = p.out + static_cast<size_t>(b) * (kBand ? band.rows : p.out_h) * p.out_w;
  if (p.group_cls[(b * p.groups_y + oy0 / kGroup) * p.groups_x + ox / kGroup]) {
    const int sx = p.col_i[ox] - 1 - wx0;
    const float ppx = P::r(p.col_f[ox]);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int oy = oy0 + r;
      if (oy >= (kBand ? band.row1 : p.out_h)) break;
      if (kBand && oy < band.row0) continue;   // a row of the band above
      const int sy = p.row_i[oy] - 1 - wy0;
      float w[4][4][3];   // the 4x4 window around floor(pp); the corners are not read
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            w[k][q][c] =
                ((k == 0 || k == 3) && (q == 0 || q == 3)) ? 0.0f : P::r(s.c[c][sy + k][sx + q]);
      float rgb[3];
      cas::upscale<P>(w, ppx, P::r(p.row_f[oy]), p.sharp, rgb);
      out[static_cast<size_t>(oy) * p.out_w + ox] = C::pack(rgb[0], rgb[1], rgb[2], 1.0f);
    }
  } else {
    const int x0 = p.col_i[p.out_w + ox];
    const int sx0 = clampi(x0, 0, p.in_w - 1) - wx0, sx1 = clampi(x0 + 1, 0, p.in_w - 1) - wx0;
    const float fxw = p.col_f[p.out_w + ox];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int oy = oy0 + r;
      if (oy >= (kBand ? band.row1 : p.out_h)) break;
      if (kBand && oy < band.row0) continue;
      const int y0 = p.row_i[p.out_h + oy];
      const int sy0 = clampi(y0, 0, p.in_h - 1) - wy0, sy1 = clampi(y0 + 1, 0, p.in_h - 1) - wy0;
      const float fyw = p.row_f[p.out_h + oy];
      float rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[c] = ffx::bilerp(s.c[c][sy0][sx0], s.c[c][sy0][sx1], s.c[c][sy1][sx0],
                             s.c[c][sy1][sx1], fxw, fyw);
      out[static_cast<size_t>(oy) * p.out_w + ox] =
          C::pack(rgb[0], rgb[1] * p.tint, rgb[2] * p.tint, 1.0f);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) cas_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Full, false>(p, Band{});
}
template <class C>
__global__ void __launch_bounds__(kThreads) cas_band_inside_kernel(Params<C> p, Band band) {
  inside_tile<C, ffx::Full, true>(p, band);
}
template <class C>
__global__ void __launch_bounds__(kThreads) cas_half_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Half, false>(p, Band{});
}
template <class C>
__global__ void __launch_bounds__(kThreads) cas_band_half_inside_kernel(Params<C> p, Band band) {
  inside_tile<C, ffx::Half, true>(p, band);
}

// The whole output's inside kernel of precision P.
template <class C, class P>
auto inside_kernel() {
  if constexpr (P::kHalf)
    return cas_half_inside_kernel<C>;
  else
    return cas_inside_kernel<C>;
}
// A band's inside kernel of precision P.
template <class C, class P>
auto band_inside_kernel() {
  if constexpr (P::kHalf)
    return cas_band_half_inside_kernel<C>;
  else
    return cas_band_inside_kernel<C>;
}

// The outside list: the shared bilinear pass, no round trip, on every row or
// on the band's.
template <class C>
__global__ void __launch_bounds__(bilinear_pass::kThreads)
    cas_outside_kernel(bilinear_pass::Args<C> a) {
  bilinear_pass::run<kTile, kTile, false, C>(a);
}
template <class C>
__global__ void __launch_bounds__(bilinear_pass::kThreads)
    cas_band_outside_kernel(bilinear_pass::Args<C> a, Band band) {
  bilinear_pass::run<kTile, kTile, false, C, true>(a, band);
}

template <class C, class P>
int occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      outside, cas_outside_kernel<C>, bilinear_pass::kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, inside_kernel<C, P>(), kThreads,
                                                        0);
  return static_cast<int>(err);
}

// CTAs per SM of the band inside kernel of precision P on the current
// device.
template <class C, class P>
int band_occupancy(int* inside) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, band_inside_kernel<C, P>(), kThreads, 0));
}

// A launch of precision P, of the whole output or of a band.
template <class C, class P>
int launch(const void* img, void* out, const void* col_i, const void* col_f, const void* row_i,
           const void* row_f, const void* tile_x0, const void* tile_y0, const void* group_cls,
           const void* inside_tiles, int n_inside, const void* outside_tiles, int n_outside,
           int batch, int in_h, int in_w, int in_row_base, int in_rows, int pitch, int out_h,
           int out_w, int out_row0, int out_row1, float sharp, float tint, int tile, int window,
           void* stream) {
  using Texel = typename C::Texel;
  if (tile != kTile || window != kWin || batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 ||
      out_w <= 0 || in_w > pitch || n_inside < 0 || n_outside < 0 ||
      !strip_is_valid(in_h, in_row_base, in_rows, out_h, out_row0, out_row1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<C> p;
  p.img = rebase(static_cast<const Texel*>(img), in_row_base, pitch);
  p.out = rebase(static_cast<Texel*>(out), out_row0, out_w);
  p.col_i = static_cast<const int32_t*>(col_i);
  p.col_f = static_cast<const float*>(col_f);
  p.row_i = static_cast<const int32_t*>(row_i);
  p.row_f = static_cast<const float*>(row_f);
  p.tile_x0 = static_cast<const int32_t*>(tile_x0);
  p.tile_y0 = static_cast<const int32_t*>(tile_y0);
  p.group_cls = static_cast<const int32_t*>(group_cls);
  p.tiles = static_cast<const int32_t*>(inside_tiles);
  p.in_h = in_h;
  p.in_w = in_w;
  p.in_rows = in_rows;
  p.pitch = pitch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.tiles_x = (out_w + kTile - 1) / kTile;
  p.tiles_y = (out_h + kTile - 1) / kTile;
  p.groups_x = (out_w + kGroup - 1) / kGroup;
  p.groups_y = (out_h + kGroup - 1) / kGroup;
  p.sharp = sharp;
  p.tint = tint;
  const Band rows = {out_row0, out_row1, out_row1 - out_row0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool band = out_row0 != 0 || out_row1 != out_h;
  if (n_outside > 0) {
    const bilinear_pass::Args<C> a = {p.img, p.out, p.col_i + out_w, p.col_f + out_w,
                                      p.row_i + out_h, p.row_f + out_h,
                                      static_cast<const int32_t*>(outside_tiles), in_h, in_w,
                                      in_rows, pitch, out_h, out_w, p.tiles_x, p.tiles_y, tint};
    if (band)
      cas_band_outside_kernel<C><<<n_outside, bilinear_pass::kThreads, 0, s>>>(a, rows);
    else
      cas_outside_kernel<C><<<n_outside, bilinear_pass::kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_inside > 0) {
    if (band) {
      const auto kernel = band_inside_kernel<C, P>();
      kernel<<<n_inside, kThreads, 0, s>>>(p, rows);
    } else {
      const auto kernel = inside_kernel<C, P>();
      kernel<<<n_inside, kThreads, 0, s>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// CTAs per SM of the outside and inside kernels on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the inside kernel's
// shared memory per CTA in bytes, for RGBA8 (cas_upscale_occupancy) and
// R10G10B10A2 (cas_upscale_occupancy10). Returns the first non-zero
// cudaError_t.
extern "C" int cas_upscale_occupancy(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Full>(outside, inside, inside_smem);
}
extern "C" int cas_upscale_occupancy10(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Full>(outside, inside, inside_smem);
}
// The same for the half instantiations (cas_upscale_launch_h, _launch10_h).
extern "C" int cas_upscale_occupancy_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Half>(outside, inside, inside_smem);
}
extern "C" int cas_upscale_occupancy10_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Half>(outside, inside, inside_smem);
}

// CTAs per SM of the band inside kernel (cas_band_inside_kernel,
// cas_band_half_inside_kernel) of color_bits 8 or 10 at full (half 0) or
// half (half 1) precision on the current device. Returns the cudaError_t.
extern "C" int cas_upscale_band_occupancy(int color_bits, int half, int* inside) {
  if (color_bits == 10)
    return half ? band_occupancy<codec::Rgb10a2, ffx::Half>(inside)
                : band_occupancy<codec::Rgb10a2, ffx::Full>(inside);
  if (color_bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  return half ? band_occupancy<codec::Rgba8, ffx::Half>(inside)
              : band_occupancy<codec::Rgba8, ffx::Full>(inside);
}

// Launch on `stream`: the outside pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing), on packed
// RGBA8 texels (cas_upscale_launch) or R10G10B10A2 ones
// (cas_upscale_launch10), for the output rows [out_row0, out_row1) from
// the input strip of in_rows rows at the image's row in_row_base (the full
// image: 0, its rows, 0, out_h). Returns the first non-zero cudaError_t (0
// = launched). The caller (kernels/cas.py) has checked shapes, dtypes and
// devices, that every tile's window fits kWin, that the lists partition
// the band's tiles and that the strip holds every row they read; tile and
// window must equal kTile and kWin.
extern "C" int cas_upscale_launch(const void* img, void* out, const void* col_i,
                                  const void* col_f, const void* row_i, const void* row_f,
                                  const void* tile_x0, const void* tile_y0, const void* group_cls,
                                  const void* inside_tiles, int n_inside,
                                  const void* outside_tiles, int n_outside, int batch, int in_h,
                                  int in_w, int in_row_base, int in_rows, int pitch, int out_h,
                                  int out_w, int out_row0, int out_row1, float sharp, float tint,
                                  int tile, int window, void* stream) {
  return launch<codec::Rgba8, ffx::Full>(img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0,
                                         group_cls, inside_tiles, n_inside, outside_tiles,
                                         n_outside, batch, in_h, in_w, in_row_base, in_rows,
                                         pitch, out_h, out_w, out_row0, out_row1, sharp, tint,
                                         tile, window, stream);
}
extern "C" int cas_upscale_launch10(const void* img, void* out, const void* col_i,
                                    const void* col_f, const void* row_i, const void* row_f,
                                    const void* tile_x0, const void* tile_y0,
                                    const void* group_cls, const void* inside_tiles,
                                    int n_inside, const void* outside_tiles, int n_outside,
                                    int batch, int in_h, int in_w, int in_row_base, int in_rows,
                                    int pitch, int out_h, int out_w, int out_row0, int out_row1,
                                    float sharp, float tint, int tile, int window,
                                    void* stream) {
  return launch<codec::Rgb10a2, ffx::Full>(img, out, col_i, col_f, row_i, row_f, tile_x0,
                                           tile_y0, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, in_h, in_w,
                                           in_row_base, in_rows, pitch, out_h, out_w, out_row0,
                                           out_row1, sharp, tint, tile, window, stream);
}

// The half instantiations, the same prototype: sharp is the host's bf16
// value; the whole output or a band, as the full ones.
extern "C" int cas_upscale_launch_h(const void* img, void* out, const void* col_i,
                                    const void* col_f, const void* row_i, const void* row_f,
                                    const void* tile_x0, const void* tile_y0,
                                    const void* group_cls, const void* inside_tiles, int n_inside,
                                    const void* outside_tiles, int n_outside, int batch,
                                    int in_h, int in_w, int in_row_base, int in_rows, int pitch,
                                    int out_h, int out_w, int out_row0, int out_row1, float sharp,
                                    float tint, int tile, int window, void* stream) {
  return launch<codec::Rgba8, ffx::Half>(img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0,
                                         group_cls, inside_tiles, n_inside, outside_tiles,
                                         n_outside, batch, in_h, in_w, in_row_base, in_rows,
                                         pitch, out_h, out_w, out_row0, out_row1, sharp, tint,
                                         tile, window, stream);
}
extern "C" int cas_upscale_launch10_h(const void* img, void* out, const void* col_i,
                                      const void* col_f, const void* row_i, const void* row_f,
                                      const void* tile_x0, const void* tile_y0,
                                      const void* group_cls, const void* inside_tiles,
                                      int n_inside, const void* outside_tiles, int n_outside,
                                      int batch, int in_h, int in_w, int in_row_base,
                                      int in_rows, int pitch, int out_h, int out_w, int out_row0,
                                      int out_row1, float sharp, float tint, int tile, int window,
                                      void* stream) {
  return launch<codec::Rgb10a2, ffx::Half>(img, out, col_i, col_f, row_i, row_f, tile_x0,
                                           tile_y0, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, in_h, in_w,
                                           in_row_base, in_rows, pitch, out_h, out_w, out_row0,
                                           out_row1, sharp, tint, tile, window, stream);
}
