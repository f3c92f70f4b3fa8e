// fsr_fused.cu — the fused FSR1 upscale (EASU -> UNORM -> RCAS) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/fsr.py::build_fsr_fused
// (pallas_call at :1019) on the system's main path: per stereo batch, EASU
// (ffx_fsr1.h:315-437) inside the foveation circle and the bilinear
// fallback (fsr_easu.hlsl:33-36) outside, the UNORM round trip of the
// reference's intermediate texture in the frame's own format
// (PostProcessor.cpp:527; JAX kernels/fsr.py:752), RCAS (ffx_fsr1.h:684-769)
// with zero out-of-image taps (fsr_rcas.hlsl:18) inside the circle and the
// quantized value times the debug tint outside (fsr_rcas.hlsl:46), stored
// with alpha 1 as packed RGBA8, or as R10G10B10A2 in four uint16 (the JAX
// builder's color_bits=10 branch, fsr.py:191; the codecs of codec.cuh, one
// instantiation of every kernel each, behind fsr_fused_launch and
// fsr_fused_launch10).
//
// What bounds it: operations inside the circle (EASU + RCAS are about 650
// f32 ops per output pixel), bytes outside it (the fallback is about 44 ops
// per pixel over 4 input and 4 output bytes in RGBA8, 8 and 8 in
// R10G10B10A2). At the full main-path size (2 x 1683x1869 -> 2 x
// 2244x2492) one stereo pair reads about 25 MB and writes about 45 MB in
// RGBA8, 50 MB and 90 MB in R10G10B10A2.
//
// The design, per output tile of 32x32 pixels (2x2 foveation groups of
// 16x16; the reference's circle test is per group, fsr_easu.hlsl:41-45):
//   - the host (kernels/_maps.py) evaluates the circle test once per build
//     and per group, and splits the tiles into two lists: inside (any group
//     inside the circle) and outside (none). No int64 arithmetic and no
//     foveation test runs here; the inside kernel reads the classes of the
//     tile's groups and of their neighbours from a per-group table.
//   - fsr_outside_kernel runs the outside list: the shared bilinear pass
//     (bilinear_pass.cuh, with the UNORM8 round trip): one CTA per tile,
//     each thread a run of 8 outputs down one column, bilinear straight
//     from device memory (each input row's lerp shared down the run),
//     quantized, tinted and stored through the codec's exact integer
//     forms. No shared memory, no barrier.
//   - fsr_inside_kernel walks the inside list with persistent CTAs (about
//     SMs x CTAs per SM, tile i, i + grid, ...). Each tile's 40x40 input
//     window, the sample maps of its 34 haloed columns and rows, and the
//     classes of the 4x4 groups around it are copied into a two-slot ring
//     in shared memory with cp.async, so the next tile's copies are in
//     flight while this one computes. The window texels the tile's
//     positions read are decoded once into f32 RGB (one 16-byte load per
//     tap afterwards, where each stage-1 position would decode 12 texels)
//     and EASU's luma (a plane of its own: the terms pass reads it
//     without bank conflicts). EASU's analysis of a
//     quadrant centre (FsrEasuSetF but its weighting: dirX, dirY, lenX²,
//     lenY² of the texel's 4-neighbour cross) depends on the texel alone,
//     so a terms pass computes it once for every window texel the tile's
//     positions take as a centre (26x26 at renderScale 0.75, where the
//     positions would analyse 4 centres each: each texel's terms once
//     instead of about 7 times, its luma once instead of about 16). Stage
//     1 (EASU, its four sums from the centres' terms, or bilinear by each
//     position's own group class, then UNORM) runs over the 34x34 haloed
//     tile, 1156 positions spread evenly over 256 threads, into shared
//     memory as f32; then each thread runs RCAS (or the tint) for 4 outputs
//     of one column and stores them, a warp writing whole rows. Four
//     barriers per tile; the loads of the next tile cross all four. A
//     slot holds 6.4 KB of window texels in RGBA8 and 12.8 KB in
//     R10G10B10A2 (8-byte texels, one 8-byte cp.async each); with the
//     38x38 terms (23.1 KB) and the luma plane (6.4 KB) the CTA's shared
//     memory is about 84.1 KB in RGBA8 and 96.9 KB in R10G10B10A2, and two
//     CTAs, the launch bound, still fit an SM (chip_smoke.py phase 1
//     prints both).
// Both launch on the caller's stream; an empty list launches nothing.
//
// A window is staged edge-clamped (its origin may lie left of or above the
// image), so it holds every tap at its unclamped position with the
// clamped texel's value, as the reference's clamped sampler reads it.
//
// Row-band strips (the JAX builder's band_range, fsr.py:194, 436-454): a
// launch computes the output rows [out_row0, out_row1) of the full image
// into a (B, out_row1 - out_row0, out_w) buffer, from an input strip of
// in_rows rows that starts at the image's row in_row_base. The tables are
// the full image's and the tile lists hold the band's 32-row tiles
// (kernels/_maps.py::band_strip, which also finds the strip: every row the
// tiles read). Every row index stays global: the window is clamped against
// the full image's in_h, and the launch rebases img by in_row_base rows
// and out by out_row0 rows, so a global row addresses the strip. A tile
// that a band edge cuts runs in both strips, each computing the whole
// tile (its RCAS needs stage 1 one row beyond the band) and storing only
// its own rows. The full image is the band [0, out_h) of the strip at row
// 0, through the same entry point and class-kernel bodies; a band smaller
// than the output launches their instantiations with the row test before
// each store and the band's rows in a parameter of their own
// (fsr_band_outside_kernel, fsr_band_inside_kernel). The whole output's
// instantiations take PR 12's parameters and keep its registers and CTAs
// per SM: with the row test, the inside kernel compiled to 113 registers
// instead of 117 and ran 1.5% slower at radius 0.5 (PERF.md, PR 13).
//
// Half precision (the JAX kernel's precision="half", fsr.py:263, 707-709,
// 878): fsr_half_inside_kernel is the inside kernel's body with EASU and
// RCAS in bf16 op by op (ffx::Half of ffx_math.cuh): the EASU taps and
// fractions and RCAS's cross are rounded to bf16 where they are read, the
// sharpness by the host; the bilinear fallback, the UNORM round trip, the
// tint and the outside pass stay f32, as there. One instantiation per codec
// behind fsr_fused_launch_h and fsr_fused_launch10_h, and a band one
// (fsr_band_half_inside_kernel) for the half strips, as the JAX builder
// takes band_range and precision="half" together (fsr.py:191-194); a band's
// outside pass is fsr_band_outside_kernel at both precisions.
// Build with --fmad=false:
// the bits then match the plain torch version
// (kernels/fsr.py::fsr_fused_reference).

#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear_pass.cuh"
#include "codec.cuh"
#include "ffx_math.cuh"

namespace {

constexpr int kGroup = 16;            // the foveation group edge
constexpr int kTile = 32;             // CTA output tile edge (kernels/_maps.py FSR_TILE)
constexpr int kHalo = kTile + 2;      // stage-1 tile with the RCAS halo
constexpr int kWin = 40;              // staged input window edge (kernels/_maps.py IN_TILE)
constexpr int kTerms = kWin - 2;      // the window's interior, where every quadrant centre lies
constexpr int kNbr = kTile / kGroup + 2;   // group neighbourhood edge of a haloed tile
constexpr int kThreads = 256;
constexpr int kRun = kTile * kTile / kThreads;   // outputs per thread (4)
constexpr int kInsideCtasPerSm = 2;   // __launch_bounds__ minimum of the inside kernel

template <class C>
struct Params {
  const typename C::Texel* img;   // (B, in_rows, pitch) texels, rebased: img + y * pitch is image row y
  typename C::Texel* out;         // (B, rows of the band, out_w) texels, rebased: out + y * out_w is output row y
  const int32_t* col_i;       // (2, out_w): EASU floor fxi, bilinear x0
  const float* col_f;         // (2, out_w): EASU fraction ppx, bilinear fx
  const int32_t* row_i;       // (2, out_h): EASU floor fyi, bilinear y0
  const float* row_f;         // (2, out_h): EASU fraction ppy, bilinear fy
  const int32_t* tile_x0;     // (tiles_x,): first staged input column per tile column
  const int32_t* tile_y0;     // (tiles_y,): first staged input row per tile row
  const int32_t* group_cls;   // (B, groups_y, groups_x): 1 inside the circle
  const int32_t* tiles;       // this launch's tile ids: b * tiles_y * tiles_x + ty * tiles_x + tx
  int n_tiles;
  int in_h, in_w, in_rows, pitch, out_h, out_w;
  int tiles_x, tiles_y, groups_x, groups_y;
  float sharp, tint;
};

using bilinear_pass::Band;
using bilinear_pass::rebase;
using bilinear_pass::strip_is_valid;
using rgba8::clampi;

// ---- the asynchronous copy: the only inline PTX of this file ---------------
// One word of kBytes (4 or 8) from global to shared memory, cached in L1
// (cp.async.ca); with valid false nothing is read and the word is
// zero-filled (src-size 0).
template <int kBytes>
__device__ __forceinline__ void copy_word(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait for every group this thread committed but the newest.
__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// -----------------------------------------------------------------------------

struct Tile {
  int b, tx, ty, ox0, oy0;
};

template <class C>
__device__ __forceinline__ Tile tile_at(const Params<C>& p, int id) {
  Tile t;
  const int per = p.tiles_x * p.tiles_y;
  t.b = id / per;
  const int rem = id - t.b * per;
  t.ty = rem / p.tiles_x;
  t.tx = rem - t.ty * p.tiles_x;
  t.ox0 = t.tx * kTile;
  t.oy0 = t.ty * kTile;
  return t;
}

// One ring slot: what the copies of one tile bring.
template <class C>
struct Slot {
  typename C::Texel win[kWin][kWin];   // input window at (tile_x0[tx], tile_y0[ty])
  // sample maps of haloed column / row j (output ox0 - 1 + j, oy0 - 1 + j):
  // 0 EASU floor, 1 bilinear floor (int32 bits), 2 EASU fraction, 3
  // bilinear fraction (f32 bits); columns in 0-3, rows in 4-7
  uint32_t maps[8][kHalo];
  int32_t cls[kNbr][kNbr];    // classes of groups (2 ty - 1 + i, 2 tx - 1 + j)
};

// The inside kernel's shared memory (dynamic: above the 48 KB of static).
template <class C>
struct Smem {
  Slot<C> slot[2];            // the ring
  // this tile's window decoded (R, G, B in [0, 1]) and EASU's luma in P,
  // written only over the tile's tap span (tile_spans)
  float4 win[kWin][kWin];
  float lum[kWin][kWin];
  // EASU's analysis terms of window texel (1 + i, 1 + j) (easu_terms):
  // dirX, dirY, lenX², lenY²; written only over the tile's terms span
  float4 terms[kTerms][kTerms];
  float q[3][kHalo][kHalo];   // stage 1 of the haloed tile, UNORM-quantized
};

// Issue the copies of tile t into slot s (every thread its share).
template <class C>
__device__ __forceinline__ void stage_tile(const Params<C>& p, const Tile& t, Slot<C>& s, int tid) {
  const typename C::Texel* img = p.img + static_cast<size_t>(t.b) * p.in_rows * p.pitch;
  const int wx0 = p.tile_x0[t.tx], wy0 = p.tile_y0[t.ty];
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int y = clampi(wy0 + i / kWin, 0, p.in_h - 1), x = clampi(wx0 + i % kWin, 0, p.in_w - 1);
    copy_word<sizeof(typename C::Texel)>(&s.win[i / kWin][i % kWin],
                                         img + static_cast<size_t>(y) * p.pitch + x, true);
  }
  for (int i = tid; i < 8 * kHalo; i += kThreads) {
    const int k = i / kHalo, j = i % kHalo;
    const bool col = k < 4;
    const int n = col ? p.out_w : p.out_h;
    const int o = (col ? t.ox0 : t.oy0) - 1 + j;
    const int row = k & 1;   // row of the (2, n) map
    const void* base = (k & 2) ? static_cast<const void*>(col ? p.col_f : p.row_f)
                               : static_cast<const void*>(col ? p.col_i : p.row_i);
    const bool ok = o >= 0 && o < n;
    copy_word<4>(&s.maps[k][j], static_cast<const uint32_t*>(base) + row * n + (ok ? o : 0), ok);
  }
  if (tid < kNbr * kNbr) {
    const int gy = 2 * t.ty - 1 + tid / kNbr, gx = 2 * t.tx - 1 + tid % kNbr;
    const bool ok = gy >= 0 && gy < p.groups_y && gx >= 0 && gx < p.groups_x;
    copy_word<4>(&s.cls[tid / kNbr][tid % kNbr],
              p.group_cls + (static_cast<size_t>(t.b) * p.groups_y + (ok ? gy : 0)) * p.groups_x +
                  (ok ? gx : 0),
              ok);
  }
}

// ---- EASU split at FsrEasuSetF's weighting ----------------------------------
// ffx::easu's four FsrEasuSetF calls each take the 4-neighbour cross of one
// quadrant centre (f, g, j, k); all of a call but its weighting by the
// quadrant's w and the sums is a function of that centre texel alone. So
// the inside kernel computes it once per window texel (easu_terms, in the
// terms pass) and each stage-1 position weights and sums its four centres'
// terms (easu_from_terms): the same ops on the same values, so the same
// bits as ffx::easu at either P.

// A texel's EASU luma in P from its decoded channels, as ffx::easu computes
// it for each tap (the channels rounded to P where they are read).
template <class P>
__device__ __forceinline__ float easu_luma(float r, float g, float b) {
  return P::r(P::r(P::r(b) * 0.5f) + P::r(P::r(P::r(r) * 0.5f) + P::r(g)));
}

// The analysis terms of the texel whose luma is at c, in the window's luma
// plane: ffx::easu_set's ops in its order, with the texel as the cross's
// centre C and A, B, D, E its neighbours above, left, right and below.
// Returns dirX, dirY, lenX², lenY² (the squares f32 at either P, as the
// length sum takes them).
template <class P>
__device__ __forceinline__ float4 easu_terms(const float* c) {
  const float lA = c[-kWin], lB = c[-1], lC = c[0], lD = c[1], lE = c[kWin];
  const float dc = P::r(lD - lC);
  const float cb = P::r(lC - lB);
  float lenX = P::r(ffx::aprx_lo_rcp(ffx::max_nan(fabsf(dc), fabsf(cb))));
  const float dirX = P::r(lD - lB);
  lenX = ffx::sat(P::r(fabsf(dirX) * lenX));
  const float ec = P::r(lE - lC);
  const float ca = P::r(lC - lA);
  float lenY = P::r(ffx::aprx_lo_rcp(ffx::max_nan(fabsf(ec), fabsf(ca))));
  const float dirY = P::r(lE - lA);
  lenY = ffx::sat(P::r(fabsf(dirY) * lenY));
  return make_float4(dirX, dirY, lenX * lenX, lenY * lenY);
}

// ffx::easu from the terms of the four quadrant centres (term: centre f's,
// in the terms array: g at + 1, j at + kTerms, k at + kTerms + 1) and the 12
// taps t (in P; for the filter and the dering clamp): the four sets' weights
// and sums in FsrEasuSetF's order, then ffx::easu after the sums, op for op.
template <class P>
__device__ __forceinline__ void easu_from_terms(const float t[12][3], const float4* term,
                                                float ppx, float ppy, float out[3]) {
  using namespace ffx;
  const float nx = P::r(1.0f - ppx), ny = P::r(1.0f - ppy);
  const float w[4] = {P::r(nx * ny), P::r(ppx * ny), P::r(nx * ppy), P::r(ppx * ppy)};
  const int at[4] = {0, 1, kTerms, kTerms + 1};   // f, g, j, k
  float dir_x = 0.0f, dir_y = 0.0f, len = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 c = term[at[q]];
    dir_x = P::r(dir_x + P::r(c.x * w[q]));
    len = len + c.z * w[q];
    dir_y = P::r(dir_y + P::r(c.y * w[q]));
    len = len + c.w * w[q];
  }

  float dirR = P::r(P::r(dir_x * dir_x) + P::r(dir_y * dir_y));
  const bool zro = dirR < 1.0f / 32768.0f;
  dirR = P::r(aprx_lo_rsq(dirR));
  dirR = zro ? 1.0f : dirR;
  dir_x = zro ? 1.0f : dir_x;
  dir_x = P::r(dir_x * dirR);
  dir_y = P::r(dir_y * dirR);

  len = len * 0.5f;
  len = len * len;
  const float stretch = P::r(P::r(P::r(dir_x * dir_x) + P::r(dir_y * dir_y)) *
                             P::r(aprx_lo_rcp(max_nan(fabsf(dir_x), fabsf(dir_y)))));
  const float len2_x = 1.0f + P::r(stretch - 1.0f) * len;
  const float len2_y = 1.0f + -0.5f * len;
  const float lob = 0.5f + P::kEasuLob * len;
  const float clp = P::r(aprx_lo_rcp(lob));

  // FsrEasuTapF (ffx_fsr1.h:239-272) with the per-offset products shared:
  // vx = off_x*dir_x + off_y*dir_y, vy = off_x*(-dir_y) + off_y*dir_x.
  const float ndir_y = -dir_y;
  float pvx_x[4], pvx_y[4], pvy_x[4], pvy_y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float offx = P::r(static_cast<float>(i - 1) - ppx);
    const float offy = P::r(static_cast<float>(i - 1) - ppy);
    pvx_x[i] = P::r(offx * dir_x);
    pvx_y[i] = P::r(offy * dir_y);
    pvy_x[i] = P::r(offx * ndir_y);
    pvy_y[i] = P::r(offy * dir_x);
  }

  float aC[3] = {0.0f, 0.0f, 0.0f};
  float aW = 0.0f;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const int ix = tap_dx(k) + 1, iy = tap_dy(k) + 1;
    float vx = P::r(pvx_x[ix] + pvx_y[iy]);
    float vy = P::r(pvy_x[ix] + pvy_y[iy]);
    vx = vx * len2_x;
    vy = vy * len2_y;
    const float d2 = min_nan(vx * vx + vy * vy, clp);
    float wB = P::kEasuWB * d2 + -1.0f;
    float wA = lob * d2 + -1.0f;
    wB = wB * wB;
    wA = wA * wA;
    wB = static_cast<float>(25.0 / 16.0) * wB + static_cast<float>(-(25.0 / 16.0 - 1.0));
    const float wk = wB * wA;
#pragma unroll
    for (int c = 0; c < 3; ++c) aC[c] = aC[c] + t[k][c] * wk;
    aW = aW + wk;
  }
  const float inv_w = P::r(rcp(aW));  // the resolve is aC * (1/aW) (ffx_fsr1.h:434)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mn4 = min_nan(min3(t[TF][c], t[TK][c], t[TJ][c]), t[TG][c]);
    const float mx4 = max_nan(max3(t[TF][c], t[TK][c], t[TJ][c]), t[TG][c]);
    out[c] = min_nan(mx4, max_nan(mn4, aC[c] * inv_w));
  }
}
// -----------------------------------------------------------------------------

// A rectangle of window or terms coordinates: first column and row, columns
// and rows.
struct Span {
  int x0, y0, w, h;
};

// What tile t's stage 1 reads, from its slot s: the window texels of every
// tap of its in-image haloed positions (taps, window coordinates: EASU's
// floor - 1 to floor + 2, the bilinear floor to floor + 1) and the quadrant
// centres whose terms it weights, floor + 0 and floor + 1 (terms, terms
// coordinates: window - 1). The sample maps are nondecreasing, so the words
// of the first and last in-image positions bound both (the words of
// out-of-image positions are zero-filled: never read). kernels/fsr.py
// counts the terms spans (launch work `analysed`).
struct Spans {
  Span taps, terms;
};
template <class C>
__device__ __forceinline__ Spans tile_spans(const Params<C>& p, const Tile& t, const Slot<C>& s) {
  // haloed column j is output column ox0 - 1 + j: in the image from
  // j = 1 - ox0 (ox0 a multiple of kTile) to j = out_w - ox0
  const int jx0 = t.ox0 > 0 ? 0 : 1, jx1 = min(kHalo - 1, p.out_w - t.ox0);
  const int jy0 = t.oy0 > 0 ? 0 : 1, jy1 = min(kHalo - 1, p.out_h - t.oy0);
  const int wx0 = p.tile_x0[t.tx], wy0 = p.tile_y0[t.ty];
  const int fx0 = static_cast<int>(s.maps[0][jx0]), fx1 = static_cast<int>(s.maps[0][jx1]);
  const int fy0 = static_cast<int>(s.maps[4][jy0]), fy1 = static_cast<int>(s.maps[4][jy1]);
  const int bx0 = static_cast<int>(s.maps[1][jx0]), bx1 = static_cast<int>(s.maps[1][jx1]);
  const int by0 = static_cast<int>(s.maps[5][jy0]), by1 = static_cast<int>(s.maps[5][jy1]);
  Spans r;
  r.taps.x0 = min(fx0 - 1, bx0) - wx0;
  r.taps.y0 = min(fy0 - 1, by0) - wy0;
  r.taps.w = max(fx1 + 2, bx1 + 1) - wx0 - r.taps.x0 + 1;
  r.taps.h = max(fy1 + 2, by1 + 1) - wy0 - r.taps.y0 + 1;
  r.terms = {fx0 - wx0 - 1, fy0 - wy0 - 1, fx1 - fx0 + 2, fy1 - fy0 + 2};
  return r;
}

// Calls f(y, x) at every point of span r, the points spread evenly over the
// CTA's threads row by row: thread tid takes points tid, tid + kThreads, ...
// The row of point q is q / r.w, taken as the truncated product (q + 0.5) *
// rcp(r.w): (q + 0.5) / r.w lies at least 0.5 / r.w from an integer, far
// beyond the product's rounding error for q <= kThreads and r.w <= kWin, so
// no thread waits on an integer division's chain at the start of a pass.
template <class F>
__device__ __forceinline__ void span_each(const Span& r, int tid, F&& f) {
  const float inv = __frcp_rn(static_cast<float>(r.w));
  int y = static_cast<int>((static_cast<float>(tid) + 0.5f) * inv), x = tid - y * r.w;
  const int dy = static_cast<int>((static_cast<float>(kThreads) + 0.5f) * inv);
  const int dx = kThreads - dy * r.w;
  while (y < r.h) {
    f(r.y0 + y, r.x0 + x);
    x += dx;
    y += dy;
    if (x >= r.w) {
      x -= r.w;
      ++y;
    }
  }
}

// Stage 1 of haloed position (ly, lx) of tile t from its slot s and its
// decoded window: EASU or the bilinear fallback by the position's own group
// class, then the UNORM round trip; 0 outside the image (the RCAS Load()
// rule). The window holds the edge-clamped texels of every unclamped tap
// position, so a tap at a constant offset from the sample's floor needs no
// clamp. EASU's taps and fractions are rounded to P, the bilinear's not;
// its four sums take the quadrant centres' terms from the terms pass.
template <class C, class P>
__device__ __forceinline__ void stage1(const Params<C>& p, const Tile& t, const Slot<C>& s,
                                       const float4 (*win)[kWin], const float4 (*terms)[kTerms],
                                       int ly, int lx, float rgb[3]) {
  rgb[0] = rgb[1] = rgb[2] = 0.0f;
  const int oy = t.oy0 - 1 + ly, ox = t.ox0 - 1 + lx;
  if (oy < 0 || oy >= p.out_h || ox < 0 || ox >= p.out_w) return;
  const int wx0 = p.tile_x0[t.tx], wy0 = p.tile_y0[t.ty];
  if (s.cls[(oy >> 4) - 2 * t.ty + 1][(ox >> 4) - 2 * t.tx + 1]) {
    const int fy = static_cast<int>(s.maps[4][ly]) - wy0;
    const int fx = static_cast<int>(s.maps[0][lx]) - wx0;
    const float4* at = &win[fy][fx];
    float tap[12][3];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float4 texel = at[ffx::tap_dy(k) * kWin + ffx::tap_dx(k)];
      tap[k][0] = P::r(texel.x);
      tap[k][1] = P::r(texel.y);
      tap[k][2] = P::r(texel.z);
    }
    easu_from_terms<P>(tap, &terms[fy - 1][fx - 1], P::r(__uint_as_float(s.maps[2][lx])),
                       P::r(__uint_as_float(s.maps[6][ly])), rgb);
  } else {
    const float4* at =
        &win[static_cast<int>(s.maps[5][ly]) - wy0][static_cast<int>(s.maps[1][lx]) - wx0];
    const float fxw = __uint_as_float(s.maps[3][lx]), fyw = __uint_as_float(s.maps[7][ly]);
    const float4 c00 = at[0], c10 = at[1], c01 = at[kWin], c11 = at[kWin + 1];
    rgb[0] = ffx::bilerp(c00.x, c10.x, c01.x, c11.x, fxw, fyw);
    rgb[1] = ffx::bilerp(c00.y, c10.y, c01.y, c11.y, fxw, fyw);
    rgb[2] = ffx::bilerp(c00.z, c10.z, c01.z, c11.z, fxw, fyw);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = C::roundtrip(rgb[c]);
}

// The inside list's body in the working precision P (ffx::Full, ffx::Half);
// kBand: store only the band's rows (a band smaller than the output).
template <class C, class P, bool kBand>
__device__ __forceinline__ void inside_tiles(const Params<C>& p, const Band& band) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(smem_raw);
  Slot<C>* s_slot = sm.slot;
  float (*s_q)[kHalo][kHalo] = sm.q;

  const int tid = threadIdx.x;
  int i = blockIdx.x;
  if (i >= p.n_tiles) return;
  Tile cur = tile_at(p, p.tiles[i]);
  stage_tile(p, cur, s_slot[0], tid);
  copy_commit();
  // this thread's outputs in RCAS: column lx, rows ly0 .. ly0 + kRun - 1,
  // all in one group row (kRun divides kGroup)
  const int lx = tid % kTile, ly0 = (tid / kTile) * kRun;
  for (int k = 0; i < p.n_tiles; ++k, i += gridDim.x) {
    const Slot<C>& s = s_slot[k & 1];
    Tile next = cur;
    if (i + static_cast<int>(gridDim.x) < p.n_tiles) {
      next = tile_at(p, p.tiles[i + gridDim.x]);
      stage_tile(p, next, s_slot[(k + 1) & 1], tid);   // read by stage 1 of tile k - 1, done
    }
    copy_commit();      // possibly empty: the wait below then still covers tile k
    copy_wait_prior();
    // slot k & 1 has landed; stage 1 of tile k - 1 is done with sm.win and
    // sm.terms, and the terms pass with sm.lum (since their own last
    // barriers), RCAS of tile k - 1 with s_q
    __syncthreads();

    // decode the texels stage 1 reads once, with each one's luma: stage 1
    // reads each texel up to 16 times, the terms pass each luma up to 5
    const Spans spans = tile_spans(p, cur, s);
    span_each(spans.taps, tid, [&](int y, int x) {
      const typename C::Texel texel = s.win[y][x];
      const float r = C::channel(texel, 0), g = C::channel(texel, 1), b = C::channel(texel, 2);
      sm.win[y][x] = make_float4(r, g, b, 0.0f);
      sm.lum[y][x] = easu_luma<P>(r, g, b);
    });
    __syncthreads();    // ends the decode's writes: the terms pass reads the lumas

    span_each(spans.terms, tid, [&](int y, int x) {
      sm.terms[y][x] = easu_terms<P>(&sm.lum[y + 1][x + 1]);
    });
    __syncthreads();    // ends the terms pass's writes: stage 1 reads the terms

    for (int j = tid; j < kHalo * kHalo; j += kThreads) {
      const int ly = j / kHalo, lxh = j % kHalo;
      float rgb[3];
      stage1<C, P>(p, cur, s, sm.win, sm.terms, ly, lxh, rgb);
#pragma unroll
      for (int c = 0; c < 3; ++c) s_q[c][ly][lxh] = rgb[c];
    }
    // the class of this thread's outputs, read before the slot is reused
    const bool inside = s.cls[(ly0 >> 4) + 1][(lx >> 4) + 1] != 0;
    // ends stage 1's writes of s_q (RCAS reads them) and its reads of sm.win
    // and sm.terms, before the next tile's decode and terms pass rewrite them
    __syncthreads();

    const int ox = cur.ox0 + lx;
    typename C::Texel* out =
        p.out + static_cast<size_t>(cur.b) * (kBand ? band.rows : p.out_h) * p.out_w;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int ly = ly0 + r, oy = cur.oy0 + ly;
      if (ox >= p.out_w || oy >= (kBand ? band.row1 : p.out_h)) break;
      if (kBand && oy < band.row0) continue;   // a row of the band above
      float e[3], res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) e[c] = s_q[c][ly + 1][lx + 1];
      if (inside) {
        float bt[3], dt[3], et[3], ft[3], ht[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bt[c] = P::r(s_q[c][ly][lx + 1]);
          dt[c] = P::r(s_q[c][ly + 1][lx]);
          et[c] = P::r(e[c]);
          ft[c] = P::r(s_q[c][ly + 1][lx + 2]);
          ht[c] = P::r(s_q[c][ly + 2][lx + 1]);
        }
        ffx::rcas<P>(bt, dt, et, ft, ht, p.sharp, res);
      } else {
        res[0] = e[0];
        res[1] = e[1] * p.tint;
        res[2] = e[2] * p.tint;
      }
      out[static_cast<size_t>(oy) * p.out_w + ox] = C::pack(res[0], res[1], res[2], 1.0f);
    }
    cur = next;
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm) fsr_inside_kernel(Params<C> p) {
  inside_tiles<C, ffx::Full, false>(p, Band{});
}
template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm)
    fsr_band_inside_kernel(Params<C> p, Band band) {
  inside_tiles<C, ffx::Full, true>(p, band);
}
template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm)
    fsr_half_inside_kernel(Params<C> p) {
  inside_tiles<C, ffx::Half, false>(p, Band{});
}
template <class C>
__global__ void __launch_bounds__(kThreads, kInsideCtasPerSm)
    fsr_band_half_inside_kernel(Params<C> p, Band band) {
  inside_tiles<C, ffx::Half, true>(p, band);
}

// The whole output's inside kernel of precision P.
template <class C, class P>
auto inside_kernel() {
  if constexpr (P::kHalf)
    return fsr_half_inside_kernel<C>;
  else
    return fsr_inside_kernel<C>;
}
// A band's inside kernel of precision P.
template <class C, class P>
auto band_inside_kernel() {
  if constexpr (P::kHalf)
    return fsr_band_half_inside_kernel<C>;
  else
    return fsr_band_inside_kernel<C>;
}

// The outside list: the shared bilinear pass with the UNORM round trip, on
// every row or on the band's.
template <class C>
__global__ void __launch_bounds__(bilinear_pass::threads(kTile, kTile))
    fsr_outside_kernel(bilinear_pass::Args<C> a) {
  bilinear_pass::run<kTile, kTile, true, C>(a);
}
template <class C>
__global__ void __launch_bounds__(bilinear_pass::threads(kTile, kTile))
    fsr_band_outside_kernel(bilinear_pass::Args<C> a, Band band) {
  bilinear_pass::run<kTile, kTile, true, C, true>(a, band);
}

// CTAs per SM of the (whole-output) outside and inside kernels of precision
// P on the current device, as cudaOccupancyMaxActiveBlocksPerMultiprocessor
// gives them, after allowing the inside kernels their dynamic shared memory
// (also the band's of precision P, which runs on the whole kernel's grid:
// both are held to kInsideCtasPerSm by their launch bounds, the same shared
// memory and the same threads). Returns the first non-zero cudaError_t.
template <class C, class P>
int occupancy(int* outside, int* inside) {
  cudaError_t err = cudaFuncSetAttribute(
      inside_kernel<C, P>(), cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<C>));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(band_inside_kernel<C, P>(),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<C>));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(outside, fsr_outside_kernel<C>,
                                                        bilinear_pass::threads(kTile, kTile), 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, inside_kernel<C, P>(), kThreads,
                                                        sizeof(Smem<C>));
  return static_cast<int>(err);
}

// CTAs per SM of the band inside kernel of precision P on the current
// device, after allowing it its dynamic shared memory.
template <class C, class P>
int band_occupancy(int* inside) {
  cudaError_t err = cudaFuncSetAttribute(
      band_inside_kernel<C, P>(), cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<C>));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, band_inside_kernel<C, P>(),
                                                        kThreads, sizeof(Smem<C>));
  return static_cast<int>(err);
}

// The inside kernel's persistent grid on the current device: SMs x the CTAs
// of it one SM holds, queried once per device and process (0 on an error).
template <class C, class P>
int inside_grid() {
  constexpr int kMaxDevices = 64;
  static int grid[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (grid[dev] == 0) {
    int sms = 0, outside = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        occupancy<C, P>(&outside, &per_sm) != cudaSuccess)
      return 0;
    grid[dev] = sms * per_sm;
  }
  return grid[dev];
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
  if (tile != kTile || window != kWin || batch <= 0 || in_h <= 0 || out_h <= 0 || out_w <= 0 ||
      in_w > pitch || n_inside < 0 || n_outside < 0 ||
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
    if (!bilinear_pass::offsets_fit(in_h, pitch))
      return static_cast<int>(cudaErrorInvalidValue);
    const bilinear_pass::Args<C> a = {p.img, p.out, p.col_i + out_w, p.col_f + out_w,
                                      p.row_i + out_h, p.row_f + out_h,
                                      static_cast<const int32_t*>(outside_tiles), in_h, in_w,
                                      in_rows, pitch, out_h, out_w, tint,
                                      bilinear_pass::Divisor::of(p.tiles_x * p.tiles_y),
                                      bilinear_pass::Divisor::of(p.tiles_x)};
    constexpr int kPass = bilinear_pass::threads(kTile, kTile);
    if (band)
      fsr_band_outside_kernel<C><<<n_outside, kPass, 0, s>>>(a, rows);
    else
      fsr_outside_kernel<C><<<n_outside, kPass, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_inside > 0) {
    const int grid = inside_grid<C, P>();
    if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    p.tiles = static_cast<const int32_t*>(inside_tiles);
    p.n_tiles = n_inside;
    const int ctas = grid < n_inside ? grid : n_inside;
    if (band) {
      const auto kernel = band_inside_kernel<C, P>();
      kernel<<<ctas, kThreads, sizeof(Smem<C>), s>>>(p, rows);
    } else {
      const auto kernel = inside_kernel<C, P>();
      kernel<<<ctas, kThreads, sizeof(Smem<C>), s>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// CTAs per SM of the outside and inside kernels on the current device, and
// the inside kernel's dynamic shared memory per CTA in bytes, for RGBA8
// (fsr_fused_occupancy) and R10G10B10A2 (fsr_fused_occupancy10).
extern "C" int fsr_fused_occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem<codec::Rgba8>));
  return occupancy<codec::Rgba8, ffx::Full>(outside, inside);
}
extern "C" int fsr_fused_occupancy10(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem<codec::Rgb10a2>));
  return occupancy<codec::Rgb10a2, ffx::Full>(outside, inside);
}
// The same for the half instantiations (fsr_fused_launch_h, _launch10_h).
extern "C" int fsr_fused_occupancy_h(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem<codec::Rgba8>));
  return occupancy<codec::Rgba8, ffx::Half>(outside, inside);
}
extern "C" int fsr_fused_occupancy10_h(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem<codec::Rgb10a2>));
  return occupancy<codec::Rgb10a2, ffx::Half>(outside, inside);
}

// CTAs per SM of the band inside kernel (fsr_band_inside_kernel,
// fsr_band_half_inside_kernel) of color_bits 8 or 10 at full (half 0) or
// half (half 1) precision on the current device. Returns the first non-zero
// cudaError_t.
extern "C" int fsr_fused_band_occupancy(int color_bits, int half, int* inside) {
  if (color_bits == 10)
    return half ? band_occupancy<codec::Rgb10a2, ffx::Half>(inside)
                : band_occupancy<codec::Rgb10a2, ffx::Full>(inside);
  if (color_bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  return half ? band_occupancy<codec::Rgba8, ffx::Half>(inside)
              : band_occupancy<codec::Rgba8, ffx::Full>(inside);
}

// Launch on `stream`: the outside pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing), on packed
// RGBA8 texels (fsr_fused_launch) or R10G10B10A2 ones (fsr_fused_launch10),
// for the output rows [out_row0, out_row1) from the input strip of in_rows
// rows at the image's row in_row_base (the full image: 0, its rows, 0,
// out_h). Returns the first non-zero cudaError_t (0 = launched). The
// caller (kernels/fsr.py) has checked shapes, dtypes and devices, that
// every tile's window fits kWin, that the lists partition the band's tiles
// and that the strip holds every row they read; tile and window must equal
// kTile and kWin.
extern "C" int fsr_fused_launch(const void* img, void* out, const void* col_i, const void* col_f,
                                const void* row_i, const void* row_f, const void* tile_x0,
                                const void* tile_y0, const void* group_cls,
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
extern "C" int fsr_fused_launch10(const void* img, void* out, const void* col_i,
                                  const void* col_f, const void* row_i, const void* row_f,
                                  const void* tile_x0, const void* tile_y0,
                                  const void* group_cls, const void* inside_tiles, int n_inside,
                                  const void* outside_tiles, int n_outside, int batch, int in_h,
                                  int in_w, int in_row_base, int in_rows, int pitch, int out_h,
                                  int out_w, int out_row0, int out_row1, float sharp, float tint,
                                  int tile, int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Full>(img, out, col_i, col_f, row_i, row_f, tile_x0,
                                           tile_y0, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, in_h, in_w,
                                           in_row_base, in_rows, pitch, out_h, out_w, out_row0,
                                           out_row1, sharp, tint, tile, window, stream);
}

// The half instantiations, the same prototype: sharp is the host's bf16
// value; the whole output or a band, as the full ones.
extern "C" int fsr_fused_launch_h(const void* img, void* out, const void* col_i,
                                  const void* col_f, const void* row_i, const void* row_f,
                                  const void* tile_x0, const void* tile_y0,
                                  const void* group_cls, const void* inside_tiles, int n_inside,
                                  const void* outside_tiles, int n_outside, int batch, int in_h,
                                  int in_w, int in_row_base, int in_rows, int pitch, int out_h,
                                  int out_w, int out_row0, int out_row1, float sharp, float tint,
                                  int tile, int window, void* stream) {
  return launch<codec::Rgba8, ffx::Half>(img, out, col_i, col_f, row_i, row_f, tile_x0, tile_y0,
                                         group_cls, inside_tiles, n_inside, outside_tiles,
                                         n_outside, batch, in_h, in_w, in_row_base, in_rows,
                                         pitch, out_h, out_w, out_row0, out_row1, sharp, tint,
                                         tile, window, stream);
}
extern "C" int fsr_fused_launch10_h(const void* img, void* out, const void* col_i,
                                    const void* col_f, const void* row_i, const void* row_f,
                                    const void* tile_x0, const void* tile_y0,
                                    const void* group_cls, const void* inside_tiles, int n_inside,
                                    const void* outside_tiles, int n_outside, int batch,
                                    int in_h, int in_w, int in_row_base, int in_rows, int pitch,
                                    int out_h, int out_w, int out_row0, int out_row1, float sharp,
                                    float tint, int tile, int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Half>(img, out, col_i, col_f, row_i, row_f, tile_x0,
                                           tile_y0, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, in_h, in_w,
                                           in_row_base, in_rows, pitch, out_h, out_w, out_row0,
                                           out_row1, sharp, tint, tile, window, stream);
}
