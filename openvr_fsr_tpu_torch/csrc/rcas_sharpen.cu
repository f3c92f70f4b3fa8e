// rcas_sharpen.cu — FSR1 RCAS sharpen-only (renderScale 1) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/rcas.py::build_rcas_sharpen
// (pallas_call at :139): the reference runs only the sharpen dispatch when
// renderScale is 1 (PostProcessor.cpp:530-535, 591-594), RCAS
// (ffx_fsr1.h:684-769) over the game's own frame with zero out-of-image taps
// (fsr_rcas.hlsl:18). Inside the foveation circle (16x16 groups) the output
// is the sharpened colour with alpha 1; outside, the source colour times the
// debug tint with the source's own alpha (kernels/rcas.py:112-115), stored
// as packed RGBA8.
//
// What bounds it: bytes moved outside the circle (one 4-byte load and store
// per output; at the headset's per-eye size, 2 x 2244x2492, one stereo pair
// reads and writes 44.7 MB each way), and inside it the shared-memory words
// RCAS's cross of 5 taps reads (RCAS is a few dozen f32 ops per pixel).
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
// Both launch on the caller's stream; an empty list launches nothing. Build
// with --fmad=false: the bits then match the plain torch version
// (kernels/rcas.py::rcas_sharpen_reference).

#include <cuda_runtime.h>

#include <cstdint>

#include "copy_pass.cuh"
#include "ffx_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kGroup = 16;       // the foveation group edge
constexpr int kTile = 32;        // CTA output tile edge (kernels/_maps.py SHARPEN_TILE)
constexpr int kWin = kTile + 2;  // with the cross taps (kernels/_maps.py CAS_SHARPEN_IN_TILE)
constexpr int kThreads = 256;
constexpr int kRun = kTile * kTile / kThreads;   // outputs per thread (4), one column
static_assert(kGroup % kRun == 0, "a run lies in one group row");

struct Params {
  const uint32_t* img;        // (B, rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;              // (B, h, w) packed RGBA8
  const int32_t* group_cls;   // (B, groups_y, groups_x): 1 inside the circle
  const int32_t* tiles;       // the inside list: b * tiles_y * tiles_x + ty * tiles_x + tx
  int h, w, rows, pitch, tiles_x, tiles_y, groups_x, groups_y;
  float sharp, tint;
};

using rgba8::channel;

// The inside kernel's shared memory: the window decoded into R, G, B planes.
struct Smem {
  float c[3][kWin][kWin];
};

__global__ void __launch_bounds__(kThreads) rcas_sharpen_inside_kernel(Params p) {
  __shared__ Smem s;

  const int tid = threadIdx.x;
  const int id = p.tiles[blockIdx.x];
  const int per = p.tiles_x * p.tiles_y;
  const int b = id / per;
  const int ty = (id - b * per) / p.tiles_x;
  const int tx = id - b * per - ty * p.tiles_x;
  const int x0 = tx * kTile, y0 = ty * kTile;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;

  // the window, once, decoded; texels outside the image are 0 (Load() rule)
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int ly = i / kWin, lx = i % kWin;
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    const uint32_t t = (y >= 0 && y < p.h && x >= 0 && x < p.w)
                           ? img[static_cast<size_t>(y) * p.pitch + x]
                           : 0u;
#pragma unroll
    for (int c = 0; c < 3; ++c) s.c[c][ly][lx] = channel(t, c);
  }
  __syncthreads();

  // this thread's outputs: column x, rows oy0 .. oy0 + kRun - 1
  const int lx = tid % kTile, ly0 = (tid / kTile) * kRun;
  const int x = x0 + lx, oy0 = y0 + ly0;
  if (x >= p.w || oy0 >= p.h) return;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.h * p.w;
  if (!p.group_cls[(b * p.groups_y + oy0 / kGroup) * p.groups_x + x / kGroup]) {
    for (int r = 0; r < kRun && oy0 + r < p.h; ++r)
      out[static_cast<size_t>(oy0 + r) * p.w + x] =
          copy_pass::texel<true>(img[static_cast<size_t>(oy0 + r) * p.pitch + x], p.tint);
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
    ffx::rcas(bt, dt, e, ft, ht, p.sharp, res);
    out[static_cast<size_t>(oy0 + r) * p.w + x] = rgba8::pack(res[0], res[1], res[2], 1.0f);
  }
}

// The outside list: the shared copy pass, the source alpha kept.
__global__ void __launch_bounds__(copy_pass::kThreads)
    rcas_sharpen_outside_kernel(copy_pass::Args a) {
  copy_pass::run<kTile, kTile, true>(a);
}

}  // namespace

// CTAs per SM of the outside and inside kernels on the current device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the inside kernel's
// shared memory per CTA in bytes. Returns the first non-zero cudaError_t.
extern "C" int rcas_sharpen_occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      outside, rcas_sharpen_outside_kernel, copy_pass::kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, rcas_sharpen_inside_kernel,
                                                        kThreads, 0);
  return static_cast<int>(err);
}

// Launch on `stream`: the copy pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing). Returns the
// first non-zero cudaError_t (0 = launched). The caller (kernels/rcas.py)
// has checked shapes, dtypes and devices and that the lists partition the
// tiles; tile and window must equal kTile and kWin.
extern "C" int rcas_sharpen_launch(const void* img, void* out, const void* group_cls,
                                   const void* inside_tiles, int n_inside,
                                   const void* outside_tiles, int n_outside, int batch, int h,
                                   int w, int rows, int pitch, float sharp, float tint, int tile,
                                   int window, void* stream) {
  if (tile != kTile || window != kWin || batch <= 0 || h <= 0 || w <= 0 || h > rows ||
      w > pitch || n_inside < 0 || n_outside < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img = static_cast<const uint32_t*>(img);
  p.out = static_cast<uint32_t*>(out);
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
    const copy_pass::Args a = {p.img, p.out, static_cast<const int32_t*>(outside_tiles), h, w,
                               rows, pitch, p.tiles_x, p.tiles_y, tint};
    rcas_sharpen_outside_kernel<<<n_outside, copy_pass::kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_inside > 0) {
    rcas_sharpen_inside_kernel<<<n_inside, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
