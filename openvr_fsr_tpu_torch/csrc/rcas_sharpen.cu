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
// inside it the shared-memory words RCAS's cross of 5 taps reads (RCAS is a
// few dozen f32 ops per pixel).
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
  *inside_smem = static_cast<int>(sizeof(Smem));
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
