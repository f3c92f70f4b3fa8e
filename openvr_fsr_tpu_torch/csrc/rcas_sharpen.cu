// rcas_sharpen.cu — FSR1 RCAS sharpen-only (renderScale 1) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/rcas.py::build_rcas_sharpen
// (pallas_call at :139): the reference runs only the sharpen dispatch when
// renderScale is 1 (PostProcessor.cpp:530-535, 591-594), RCAS
// (ffx_fsr1.h:684-769) over the game's own frame with zero out-of-image taps
// (fsr_rcas.hlsl:18). Inside the foveation circle (16x16 groups) the output
// is the sharpened colour with alpha 1; outside, the source colour times the
// debug tint with the source's own alpha (kernels/rcas.py:112-115), stored
// in the frame's format: packed RGBA8, or R10G10B10A2 as four uint16 (the
// JAX builder's color_bits=10 branch, rcas.py:35; the codecs of codec.cuh,
// one instantiation of every kernel each, behind rcas_sharpen_launch and
// rcas_sharpen_launch10).
//
// What bounds it: bytes moved outside the circle (one texel load and store
// per output; at the headset's per-eye size, 2 x 2244x2492, one stereo pair
// reads and writes 44.7 MB each way in RGBA8, 89.5 MB in R10G10B10A2), and
// inside it instruction issue: RCAS is a few dozen f32 ops per pixel, and
// its decode, min/max and reciprocals about as many again.
//
// The design, per output tile of 32x32 pixels (2x2 foveation groups), as
// cas_sharpen.cu's:
//   - the host (kernels/_maps.py::sharpen_maps) evaluates the circle test
//     once per build and per group and splits the tiles into an inside list
//     (any group inside) and an outside list. No foveation test and no int64
//     arithmetic runs here.
//   - rcas_sharpen_outside_kernel runs the outside list: the shared copy
//     pass (copy_pass.cuh, the source alpha kept): 4 outputs of one row per
//     thread, 16-byte loads and stores, no shared memory, no barrier.
//   - rcas_sharpen_inside_kernel runs the inside list, one CTA per tile: the
//     tile's 34x34 window (0 outside the image) is loaded once and decoded
//     into three f32 planes in shared memory, one barrier; then each thread
//     takes 4 outputs of one column (a warp reads and stores whole rows, so
//     the plane reads have no bank conflicts), and the cross slides down the
//     run in registers: the next row's top tap is this row's centre and its
//     centre this row's bottom, so the first output reads 15 words and each
//     later one only its new left, right and bottom taps' 9 (10.5 per
//     output). A run lies in one 16x16 group; a run whose group is outside
//     the circle writes the copy (its texels from device memory), so bits
//     never depend on the tile a group sits in.
//   - at RGBA8 and full precision the inside kernel computes RCAS on the
//     texels' 256 levels (its explicit specialization), with the same
//     bits: the window stays packed, one word a texel (4.6 KB, the f32
//     planes 13.9 KB), so a tap is one shared word (3.5 per output); min4
//     and max4 of the cross are byte SIMD (the channels' bytes in 16-bit
//     lanes, three-way min and max); the two correctly rounded reciprocals,
//     whose arguments take one of 256 values each, and min4 and 1 - max4
//     come from two tables of the levels that each CTA makes in shared
//     memory (4 KB); the result is encoded by codec.cuh's exact form. The
//     R10G10B10A2 (1,024 levels) and half instantiations keep the f32
//     planes (inside_tile).
// Both launch on the caller's stream; an empty list launches nothing.
//
// Half precision (the JAX kernel's precision="half", rcas.py:49, 105):
// rcas_sharpen_half_inside_kernel is the inside kernel's body with RCAS in
// bf16 op by op (ffx::Half of ffx_math.cuh): the window is decoded into
// bf16 values (held as f32 in the same planes; they feed only RCAS) and the
// host rounds the sharpness; the copy outside the circle is the same. One
// instantiation per codec behind rcas_sharpen_launch_h and
// rcas_sharpen_launch10_h.
// Build with --fmad=false: the bits then match the plain torch version
// (kernels/rcas.py::rcas_sharpen_reference).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bilinear_pass.cuh"
#include "copy_pass.cuh"
#include "codec.cuh"
#include "ffx_math.cuh"

namespace {

constexpr int kGroup = 16;       // the foveation group edge
constexpr int kTile = 32;        // CTA output tile edge (kernels/_maps.py SHARPEN_TILE)
constexpr int kWin = kTile + 2;  // with the cross taps (kernels/_maps.py CAS_SHARPEN_IN_TILE)
constexpr int kThreads = 256;
constexpr int kRun = kTile * kTile / kThreads;   // outputs per thread (4), one column
static_assert(kGroup % kRun == 0, "a run lies in one group row");

template <class C>
struct Params {
  const typename C::Texel* img;   // (B, rows, pitch) texels
  typename C::Texel* out;         // (B, h, w) texels
  const int32_t* group_cls;   // (B, groups_y, groups_x): 1 inside the circle
  const int32_t* tiles;       // the inside list: b * tiles_y * tiles_x + ty * tiles_x + tx
  int h, w, rows, pitch, tiles_x, tiles_y, groups_x, groups_y;
  float sharp, tint;
  // tiles_y * tiles_x and tiles_x: a tile id's b, ty, tx (the RGBA8 body on
  // the levels)
  bilinear_pass::Divisor per, cols;
};

// The inside kernel's shared memory: the window decoded into R, G, B planes.
struct Smem {
  float c[3][kWin][kWin];
};

// One inside tile (the CTA's of the list) in the working precision P
// (ffx::Full, ffx::Half).
template <class C, class P>
__device__ __forceinline__ void inside_tile(const Params<C>& p) {
  using Texel = typename C::Texel;
  __shared__ Smem s;

  const int tid = threadIdx.x;
  const int id = p.tiles[blockIdx.x];
  const int per = p.tiles_x * p.tiles_y;
  const int b = id / per;
  const int ty = (id - b * per) / p.tiles_x;
  const int tx = id - b * per - ty * p.tiles_x;
  const int x0 = tx * kTile, y0 = ty * kTile;
  const Texel* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;

  // the window, once, decoded; texels outside the image are 0 (Load() rule)
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int ly = i / kWin, lx = i % kWin;
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    const Texel t = (y >= 0 && y < p.h && x >= 0 && x < p.w)
                        ? img[static_cast<size_t>(y) * p.pitch + x]
                        : Texel{};
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c][ly][lx] = P::r(C::channel(t, c));
  }
  __syncthreads();

  // this thread's outputs: column x, rows oy0 .. oy0 + kRun - 1
  const int lx = tid % kTile, ly0 = (tid / kTile) * kRun;
  const int x = x0 + lx, oy0 = y0 + ly0;
  if (x >= p.w || oy0 >= p.h) return;
  Texel* out = p.out + static_cast<size_t>(b) * p.h * p.w;
  if (!p.group_cls[(b * p.groups_y + oy0 / kGroup) * p.groups_x + x / kGroup]) {
    for (int r = 0; r < kRun && oy0 + r < p.h; ++r)
      out[static_cast<size_t>(oy0 + r) * p.w + x] =
          copy_pass::texel<true, C>(img[static_cast<size_t>(oy0 + r) * p.pitch + x], p.tint);
    return;
  }
  // the cross of output row oy0 + r, at window row ly = ly0 + r + 1: bt above,
  // dt left, e centre, ft right, ht below
  float bt[3], dt[3], e[3], ft[3], ht[3];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (oy0 + r >= p.h) break;
    const int ly = ly0 + r + 1;
    const bool reload = r == 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (reload) {
        bt[c] = s.c[c][ly - 1][lx + 1];
        e[c] = s.c[c][ly][lx + 1];
      } else {   // slide one row down
        bt[c] = e[c];
        e[c] = ht[c];
      }
      dt[c] = s.c[c][ly][lx];
      ft[c] = s.c[c][ly][lx + 2];
      ht[c] = s.c[c][ly + 1][lx + 1];
    }
    float res[3];
    ffx::rcas<P>(bt, dt, e, ft, ht, p.sharp, res);
    out[static_cast<size_t>(oy0 + r) * p.w + x] = C::pack(res[0], res[1], res[2], 1.0f);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) rcas_sharpen_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Full>(p);
}

// Whether the inside kernel of codec C and precision P runs on the levels.
template <class C, class P>
constexpr bool kOnLevels = std::is_same_v<C, codec::Rgba8> && !P::kHalf;

// The levels kernel's shared memory: the window as packed RGBA8 texels, and
// at each level k of a channel (decoded k/255 by rgba8::channel) the
// operands of ffx::rcas's hit_min and hit_max that depend on the min4 byte
// (lo) or on the max4 byte (hi).
struct LevelSmem {
  uint32_t w[kWin][kWin];
  float2 lo[256];   // {k/255, rcp(4 k/255 - 4)}
  float2 hi[256];   // {rcp(4 k/255), 1 - k/255}
};
static_assert(kThreads == 256, "a thread makes one level of the tables");

// A packed RGBA8 texel as two words of unsigned 16-bit lanes, ev = R | B <<
// 16 and od = G | A << 16, whose lane-wise min and max (Hopper's three-way
// __vimin3_u16x2 / __vimax3_u16x2) are the channels' byte min and max.
struct Pair {
  uint32_t ev, od;
  static __device__ __forceinline__ Pair of(uint32_t word) {
    return {__byte_perm(word, 0u, 0x4240u), __byte_perm(word, 0u, 0x4341u)};
  }
  // the byte of channel c: a level
  __device__ __forceinline__ uint32_t level(int c) const {
    return __byte_perm(c == 1 ? od : ev, 0u, c == 2 ? 0x4442u : 0x4440u);
  }
};
__device__ __forceinline__ Pair min4(const Pair& a, const Pair& b, const Pair& c, const Pair& d) {
  return {__vimin3_u16x2(__vimin3_u16x2(a.ev, b.ev, c.ev), d.ev, d.ev),
          __vimin3_u16x2(__vimin3_u16x2(a.od, b.od, c.od), d.od, d.od)};
}
__device__ __forceinline__ Pair max4(const Pair& a, const Pair& b, const Pair& c, const Pair& d) {
  return {__vimax3_u16x2(__vimax3_u16x2(a.ev, b.ev, c.ev), d.ev, d.ev),
          __vimax3_u16x2(__vimax3_u16x2(a.od, b.od, c.od), d.od, d.od)};
}

// ffx::max3 but for the sign of a zero max (PTX max.NaN: a NaN in either
// operand gives NaN), which the hlsl_min with 0 after it maps to 0 either
// way.
__device__ __forceinline__ float max3_nan(float a, float b, float c) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(b), "f"(c));
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(r));
  return r;
}

// FsrRcasF (ffx::rcas<ffx::Full>) on the levels: mn and mx are the byte
// min and max of the four cross taps b, d, f, h; b, d, e, f, h the taps
// decoded. Byte order is the decoded order (the decode is strictly
// increasing and never NaN, so min_nan / max_nan of the decoded taps are
// the decode of the byte min / max), and each table entry is computed with
// ffx::rcas's ops on its level: hit_min, hit_max and every op after them
// have ffx::rcas's bits, the 0 * inf NaNs of flat black and white crosses
// among them.
__device__ __forceinline__ void rcas_levels(const float b[3], const float d[3], const float e[3],
                                            const float f[3], const float h[3], const Pair& mn,
                                            const Pair& mx, const LevelSmem& s, float sharp,
                                            float out[3]) {
  float lobe_c[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float2 lo = s.lo[mn.level(c)];
    const float2 hi = s.hi[mx.level(c)];
    const float hit_min = lo.x * hi.x;   // mn4 * rcp(4 mx4)
    const float hit_max = hi.y * lo.y;   // (1 - mx4) * rcp(4 mn4 - 4)
    lobe_c[c] = ffx::hlsl_max(-hit_min, hit_max);
  }
  constexpr float kRcasLimit = 0.25f - 1.0f / 16.0f;
  const float lobe =
      ffx::hlsl_max(-kRcasLimit, ffx::hlsl_min(max3_nan(lobe_c[0], lobe_c[1], lobe_c[2]), 0.0f)) *
      sharp;
  const float rcp_l = ffx::aprx_med_rcp(4.0f * lobe + 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = lobe * b[c] + lobe * d[c];
    acc = acc + lobe * h[c];
    acc = acc + lobe * f[c];
    out[c] = (acc + e[c]) * rcp_l;
  }
}

// The inside list at RGBA8 and full precision, on the texels' levels: one
// tile per CTA, as inside_tile, at most 32 registers a thread so that an
// SM holds 8 CTAs. The CTA makes the level tables, one level per thread;
// splits its tile id by the host's multiply-high divisors; starts its
// run's group class load; stages the window packed, a row per warp at a
// time, every load of a thread before its first store (a row's offset
// within the image is 32-bit); then each thread computes its run, each tap
// one shared word, the cross's top and centre sliding down. The taps are
// decoded by rgba8::channel (the plain decode: one I2F of the byte and one
// multiply). RCAS's result is finite (its lobe is clamped to [-3/16, 0]
// before the sharpness scales it), so exact_pack gives pack's bits.
template <>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    rcas_sharpen_inside_kernel<codec::Rgba8>(Params<codec::Rgba8> p) {
  using C = codec::Rgba8;
  __shared__ LevelSmem s;
  const int tid = threadIdx.x;
  {
    const float v = C::channel(static_cast<uint32_t>(tid), 0);
    s.lo[tid] = make_float2(v, ffx::rcp(4.0f * v + -4.0f));
    s.hi[tid] = make_float2(ffx::rcp(4.0f * v), 1.0f - v);
  }
  const int id = p.tiles[blockIdx.x];
  const int b = p.per.div(id);
  const int ty = p.cols.div(id - b * p.per.d);
  const int x0 = (id - b * p.per.d - ty * p.cols.d) * kTile, y0 = ty * kTile;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;

  // this thread's outputs: column x, rows oy0 .. oy0 + kRun - 1
  const int lx = tid % kTile, ly0 = (tid / kTile) * kRun;
  const int x = x0 + lx, oy0 = y0 + ly0;
  const bool live = x < p.w && oy0 < p.h;
  const int cls = live ? p.group_cls[(b * p.groups_y + oy0 / kGroup) * p.groups_x + x / kGroup] : 0;

  {  // the window; texels outside the image are 0 (Load() rule)
    constexpr int kWarps = kThreads / 32, kRows = (kWin + kWarps - 1) / kWarps;
    const int lane = tid % 32, gx = x0 - 1 + lane;
    const bool in0 = gx >= 0 && gx < p.w;
    const bool in1 = lane < kWin - 32 && gx + 32 < p.w;
    uint32_t v0[kRows], v1[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int ly = tid / 32 + kWarps * k, y = y0 - 1 + ly;
      const bool in_y = (k < kRows - 1 || ly < kWin) &&
                        static_cast<unsigned>(y) < static_cast<unsigned>(p.h);
      // y * pitch wraps for the row above the image, whose words are not read
      const uint32_t* row = img + gx + static_cast<unsigned>(y * p.pitch);
      v0[k] = in_y && in0 ? row[0] : 0u;
      v1[k] = in_y && in1 ? row[32] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int ly = tid / 32 + kWarps * k;
      if (k < kRows - 1 || ly < kWin) {
        s.w[ly][lane] = v0[k];
        if (lane < kWin - 32) s.w[ly][lane + 32] = v1[k];
      }
    }
  }
  __syncthreads();

  if (!live) return;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.h * p.w + oy0 * p.w + x;
  if (!cls) {
    for (int r = 0; r < kRun && oy0 + r < p.h; ++r)
      out[r * p.w] = copy_pass::texel<true, C>(img[(oy0 + r) * p.pitch + x], p.tint);
    return;
  }
  // the cross of output row oy0 + r as packed words (bw above, dw left, ew
  // centre, fw right, hw below), as pairs and decoded
  uint32_t bw, dw, ew, fw, hw;
  Pair bp, ep, hp;
  float bt[3], dt[3], e[3], ft[3], ht[3];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (oy0 + r >= p.h) break;
    const int ly = ly0 + r + 1;
    const bool load_top = r == 0;
    if (load_top) {
      bw = s.w[ly - 1][lx + 1];
      ew = s.w[ly][lx + 1];
      bp = Pair::of(bw);
      ep = Pair::of(ew);
    } else {   // slide one row down
      bw = ew;
      ew = hw;
      bp = ep;
      ep = hp;
    }
    dw = s.w[ly][lx];
    fw = s.w[ly][lx + 2];
    hw = s.w[ly + 1][lx + 1];
    hp = Pair::of(hw);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (load_top) {
        bt[c] = C::channel(bw, c);
        e[c] = C::channel(ew, c);
      } else {
        bt[c] = e[c];
        e[c] = ht[c];
      }
      dt[c] = C::channel(dw, c);
      ft[c] = C::channel(fw, c);
      ht[c] = C::channel(hw, c);
    }
    const Pair dp = Pair::of(dw), fp = Pair::of(fw);
    float res[3];
    rcas_levels(bt, dt, e, ft, ht, min4(bp, dp, fp, hp), max4(bp, dp, fp, hp), s, p.sharp,
                res);
    out[r * p.w] = C::exact_pack(res[0], res[1], res[2]);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) rcas_sharpen_half_inside_kernel(Params<C> p) {
  inside_tile<C, ffx::Half>(p);
}

// The inside kernel of precision P.
template <class C, class P>
auto inside_kernel() {
  if constexpr (P::kHalf)
    return rcas_sharpen_half_inside_kernel<C>;
  else
    return rcas_sharpen_inside_kernel<C>;
}

// The outside list: the shared copy pass, the source alpha kept.
template <class C>
__global__ void __launch_bounds__(copy_pass::kThreads)
    rcas_sharpen_outside_kernel(copy_pass::Args<C> a) {
  copy_pass::run<kTile, kTile, true, C>(a);
}

template <class C, class P>
int occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(kOnLevels<C, P> ? sizeof(LevelSmem) : sizeof(Smem));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      outside, rcas_sharpen_outside_kernel<C>, copy_pass::kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, inside_kernel<C, P>(), kThreads,
                                                        0);
  return static_cast<int>(err);
}

template <class C, class P>
int launch(const void* img, void* out, const void* group_cls, const void* inside_tiles,
           int n_inside, const void* outside_tiles, int n_outside, int batch, int h, int w,
           int rows, int pitch, float sharp, float tint, int tile, int window, void* stream) {
  using Texel = typename C::Texel;
  if (tile != kTile || window != kWin || batch <= 0 || h <= 0 || w <= 0 || h > rows ||
      w > pitch || n_inside < 0 || n_outside < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<C> p;
  p.img = static_cast<const Texel*>(img);
  p.out = static_cast<Texel*>(out);
  p.group_cls = static_cast<const int32_t*>(group_cls);
  p.tiles = static_cast<const int32_t*>(inside_tiles);
  p.h = h;
  p.w = w;
  p.rows = rows;
  p.pitch = pitch;
  p.tiles_x = (w + kTile - 1) / kTile;
  p.tiles_y = (h + kTile - 1) / kTile;
  p.groups_x = (w + kGroup - 1) / kGroup;
  p.groups_y = (h + kGroup - 1) / kGroup;
  p.sharp = sharp;
  p.tint = tint;
  p.per = bilinear_pass::Divisor::of(p.tiles_x * p.tiles_y);
  p.cols = bilinear_pass::Divisor::of(p.tiles_x);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_outside > 0) {
    const copy_pass::Args<C> a = {p.img, p.out, static_cast<const int32_t*>(outside_tiles), h,
                                  w, rows, pitch, p.tiles_x, p.tiles_y, tint};
    rcas_sharpen_outside_kernel<C><<<n_outside, copy_pass::kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_inside > 0) {
    const auto kernel = inside_kernel<C, P>();
    kernel<<<n_inside, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// CTAs per SM of the outside and inside kernels on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the inside kernel's
// shared memory per CTA in bytes, for RGBA8 (rcas_sharpen_occupancy) and
// R10G10B10A2 (rcas_sharpen_occupancy10). Returns the first non-zero
// cudaError_t.
extern "C" int rcas_sharpen_occupancy(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Full>(outside, inside, inside_smem);
}
extern "C" int rcas_sharpen_occupancy10(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Full>(outside, inside, inside_smem);
}
// The same for the half instantiations (rcas_sharpen_launch_h, _launch10_h).
extern "C" int rcas_sharpen_occupancy_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Half>(outside, inside, inside_smem);
}
extern "C" int rcas_sharpen_occupancy10_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Half>(outside, inside, inside_smem);
}

// Launch on `stream`: the copy pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing), on packed
// RGBA8 texels (rcas_sharpen_launch) or R10G10B10A2 ones
// (rcas_sharpen_launch10). Returns the first non-zero cudaError_t (0 =
// launched). The caller (kernels/rcas.py) has checked shapes, dtypes and
// devices and that the lists partition the tiles; tile and window must
// equal kTile and kWin.
extern "C" int rcas_sharpen_launch(const void* img, void* out, const void* group_cls,
                                   const void* inside_tiles, int n_inside,
                                   const void* outside_tiles, int n_outside, int batch, int h,
                                   int w, int rows, int pitch, float sharp, float tint, int tile,
                                   int window, void* stream) {
  return launch<codec::Rgba8, ffx::Full>(img, out, group_cls, inside_tiles, n_inside,
                                         outside_tiles, n_outside, batch, h, w, rows, pitch,
                                         sharp, tint, tile, window, stream);
}
extern "C" int rcas_sharpen_launch10(const void* img, void* out, const void* group_cls,
                                     const void* inside_tiles, int n_inside,
                                     const void* outside_tiles, int n_outside, int batch, int h,
                                     int w, int rows, int pitch, float sharp, float tint, int tile,
                                     int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Full>(img, out, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, h, w, rows, pitch,
                                           sharp, tint, tile, window, stream);
}

// The half instantiations, the same prototype (sharp: the host's bf16
// value).
extern "C" int rcas_sharpen_launch_h(const void* img, void* out, const void* group_cls,
                                     const void* inside_tiles, int n_inside,
                                     const void* outside_tiles, int n_outside, int batch, int h,
                                     int w, int rows, int pitch, float sharp, float tint,
                                     int tile, int window, void* stream) {
  return launch<codec::Rgba8, ffx::Half>(img, out, group_cls, inside_tiles, n_inside,
                                         outside_tiles, n_outside, batch, h, w, rows, pitch,
                                         sharp, tint, tile, window, stream);
}
extern "C" int rcas_sharpen_launch10_h(const void* img, void* out, const void* group_cls,
                                       const void* inside_tiles, int n_inside,
                                       const void* outside_tiles, int n_outside, int batch,
                                       int h, int w, int rows, int pitch, float sharp,
                                       float tint, int tile, int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Half>(img, out, group_cls, inside_tiles, n_inside,
                                           outside_tiles, n_outside, batch, h, w, rows, pitch,
                                           sharp, tint, tile, window, stream);
}
