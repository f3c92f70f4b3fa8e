// dma_floor.cu — the DMA floor (B7): a compute kernel's loads and stores with
// no compute, for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/sol.py::build_dma_floor
// (pallas_call at :85): a kernel with the exact launch shape and device
// memory traffic of one compute kernel of the port and nothing else, so its
// time is a floor under that kernel's on the same card, and
// vs_sol = floor / kernel <= 1 when both are timed together.
//
// What it mirrors, from the compute kernel's published DMA geometry
// (kernels/_maps.py::dma_geometry): the same grid of (tile_w x tile_h)
// output blocks per batch entry, the same 256 threads per CTA, the same
// (win_w x win_h) window staged into shared memory at the same per-tile
// origins, with out-of-image words loaded edge-clamped or staged as 0
// without a load, by the same CTAs, in one of two forms:
//   kCopy    the sharpen-only class kernels (RCAS sharpen, CAS sharpen,
//            NVSharpen): the CTAs a host table marks (the inside list)
//            stage; the others copy their own texels as the copy pass does
//            (copy_pass.cuh), 4 of one row per thread with 16-byte loads
//            and stores where aligned;
//   kList    the upscalers: the CTAs a host table marks (the inside list)
//            stage; the others run the shared outside pass's loads, four
//            bilinear taps per output, 4 outputs of one row per thread
//            (bilinear_pass.cuh); NVScaler's staging CTAs also load each
//            pixel's four RGBA taps (stage_quads).
// Every output word is stored once.
//
// What bounds it: only bytes, by construction. Nothing may be elided: the
// staged words go to shared memory, each output is the staged word at its
// own tap (a runtime index into the window), and the words of the four-tap
// loads enter the output through `mask`, which is 0 at run time but unknown
// to the compiler. So the output is deterministic: the input word at each
// output's tap (or, in a kList CTA that does not stage, at its first outside
// tap), which is what the plain
// torch version (kernels/sol.py::dma_floor_reference) computes.
//
// The compute kernels' tile and window shapes are the template instances
// below; any other shape is refused.

#include <cuda_runtime.h>

#include <cstdint>

#include "rgba8.cuh"

namespace {

constexpr int kThreads = 256;   // every compute kernel's threads per CTA
// CTAs per SM the register budget must allow: a CTA that does not stage
// runs the copy pass's or the bilinear pass's loads, and those passes run
// 8 CTAs per SM (about 30 registers); a floor held to fewer would be slower
// than a kernel whose tiles are all outside the circle
constexpr int kMinCtas = 8;

enum Stage { kList = 0, kCopy = 1 };   // kernels/sol.py _STAGES

struct Params {
  const uint32_t* img;      // (B, rows, pitch) packed RGBA8
  uint32_t* out;            // (B, out_h, out_w)
  const int32_t* tile_x0;   // (tiles_x,): window origin per tile column (may be < 0)
  const int32_t* tile_y0;   // (tiles_y,): window origin per tile row
  const int32_t* tap_x;     // (out_w,): each output column's tap; null = the column itself
  const int32_t* tap_y;     // (out_h,): each output row's tap; null = the row itself
  const int32_t* quad_x;    // (2, out_w) for kList: four-tap floors (staging, other CTAs)
  const int32_t* quad_y;    // (2, out_h)
  const uint8_t* staged;    // (B, tiles_y, tiles_x): 1 = the CTA stages
  int in_h, in_w, rows, pitch, out_h, out_w;
  int stage;                // Stage: which CTAs stage their window
  int stage_quads;          // kList, 1: staging CTAs also load four taps per output (quad row 0)
  int clamp;                // 1: out-of-image window words load clamped; 0: staged as 0
  uint32_t mask;            // 0 at run time
};

using rgba8::clampi;

__device__ __forceinline__ int tap(const int32_t* t, int o) { return t ? t[o] : o; }

// The four edge-clamped bilinear taps at floor (x0, y0), as
// rgba8::bilinear_rgba loads them; returns the first.
__device__ __forceinline__ uint32_t quad(const uint32_t* img, const Params& p, int x0, int y0) {
  const int sx0 = clampi(x0, 0, p.in_w - 1), sx1 = clampi(x0 + 1, 0, p.in_w - 1);
  const int sy0 = clampi(y0, 0, p.in_h - 1), sy1 = clampi(y0 + 1, 0, p.in_h - 1);
  const uint32_t c00 = img[static_cast<size_t>(sy0) * p.pitch + sx0];
  const uint32_t c10 = img[static_cast<size_t>(sy0) * p.pitch + sx1];
  const uint32_t c01 = img[static_cast<size_t>(sy1) * p.pitch + sx0];
  const uint32_t c11 = img[static_cast<size_t>(sy1) * p.pitch + sx1];
  return c00 | ((c10 | c01 | c11) & p.mask);
}

template <int TW, int TH, int WW, int WH>
__global__ void __launch_bounds__(kThreads, kMinCtas) dma_floor_kernel(Params p) {
  __shared__ uint32_t s_win[WH][WW];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.out_h * p.out_w;

  if (!p.staged[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x]) {
    // the outside passes (bilinear_pass.cuh, copy_pass.cuh): 4 outputs of
    // one row per thread, 16-byte stores where aligned
    constexpr int kRun = 4;
    static_assert(TW % kRun == 0, "a tile row holds whole runs");
    for (int r = tid; r < TW * TH / kRun; r += kThreads) {
      const int oy = oy0 + r / (TW / kRun), ox = ox0 + (r % (TW / kRun)) * kRun;
      if (oy >= p.out_h || ox >= p.out_w) continue;
      const int n = min(kRun, p.out_w - ox);
      uint32_t v[kRun] = {0u, 0u, 0u, 0u};
      const uint32_t* src = img + static_cast<size_t>(oy) * p.pitch + ox;
      if (p.stage == kCopy && n == kRun && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        const uint4 q = *reinterpret_cast<const uint4*>(src);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else if (p.stage == kCopy) {
        for (int j = 0; j < n; ++j) v[j] = src[j];
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (j < n) v[j] = quad(img, p, p.quad_x[p.out_w + ox + j], p.quad_y[p.out_h + oy]);
      }
      uint32_t* dst = out + static_cast<size_t>(oy) * p.out_w + ox;
      if (n == kRun && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
        for (int j = 0; j < n; ++j) dst[j] = v[j];
      }
    }
    return;
  }

  const int wx0 = p.tile_x0[blockIdx.x], wy0 = p.tile_y0[blockIdx.y];
  for (int i = tid; i < WW * WH; i += kThreads) {
    const int ly = i / WW, lx = i % WW;
    const int y = wy0 + ly, x = wx0 + lx;
    uint32_t v = 0u;
    if (p.clamp)
      v = img[static_cast<size_t>(clampi(y, 0, p.in_h - 1)) * p.pitch + clampi(x, 0, p.in_w - 1)];
    else if (y >= 0 && y < p.in_h && x >= 0 && x < p.in_w)
      v = img[static_cast<size_t>(y) * p.pitch + x];
    s_win[ly][lx] = v;
  }
  __syncthreads();

  for (int i = tid; i < TW * TH; i += kThreads) {
    const int ox = ox0 + i % TW, oy = oy0 + i / TW;
    if (ox >= p.out_w || oy >= p.out_h) continue;
    uint32_t v = s_win[tap(p.tap_y, oy) - wy0][tap(p.tap_x, ox) - wx0];
    if (p.stage_quads) v |= quad(img, p, p.quad_x[ox], p.quad_y[oy]) & p.mask;
    out[static_cast<size_t>(oy) * p.out_w + ox] = v;
  }
}

template <int TW, int TH, int WW, int WH>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.out_w + TW - 1) / TW, (p.out_h + TH - 1) / TH, batch);
  dma_floor_kernel<TW, TH, WW, WH><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/sol.py) has checked the geometry: every tap lies inside
// every window of its tile, and the staged table has the grid's shape.
// kList takes the four-tap floors; kCopy identity taps (null) and no
// floors; only kList takes stage_quads.
// (tile_w, tile_h, win_w, win_h) must be one of the compute kernels' shapes
// and threads must be 256.
extern "C" int dma_floor_launch(const void* img, void* out, const void* tile_x0,
                                const void* tile_y0, const void* tap_x, const void* tap_y,
                                const void* quad_x, const void* quad_y, const void* staged,
                                int batch, int in_h, int in_w, int rows,
                                int pitch, int out_h, int out_w, int tile_w, int tile_h, int win_w,
                                int win_h, int threads, int stage, int stage_quads, int clamp,
                                unsigned int mask, void* stream) {
  if (threads != kThreads || batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
      in_h > rows || in_w > pitch || (stage != kList && stage != kCopy) || staged == nullptr ||
      (stage == kList) != (quad_x != nullptr) ||
      (stage == kList) != (quad_y != nullptr) || (stage != kList && stage_quads) ||
      (stage == kCopy && (tap_x != nullptr || tap_y != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img = static_cast<const uint32_t*>(img);
  p.out = static_cast<uint32_t*>(out);
  p.tile_x0 = static_cast<const int32_t*>(tile_x0);
  p.tile_y0 = static_cast<const int32_t*>(tile_y0);
  p.tap_x = static_cast<const int32_t*>(tap_x);
  p.tap_y = static_cast<const int32_t*>(tap_y);
  p.quad_x = static_cast<const int32_t*>(quad_x);
  p.quad_y = static_cast<const int32_t*>(quad_y);
  p.staged = static_cast<const uint8_t*>(staged);
  p.in_h = in_h;
  p.in_w = in_w;
  p.rows = rows;
  p.pitch = pitch;
  p.out_h = out_h;
  p.out_w = out_w;
  p.stage = stage;
  p.stage_quads = stage_quads;
  p.clamp = clamp;
  p.mask = mask;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_w == 32 && tile_h == 32 && win_w == 40 && win_h == 40)   // fsr_fused
    return launch<32, 32, 40, 40>(p, batch, s);
  if (tile_w == 32 && tile_h == 32 && win_w == 34 && win_h == 34)   // cas_sharpen, rcas_sharpen
    return launch<32, 32, 34, 34>(p, batch, s);
  if (tile_w == 32 && tile_h == 32 && win_w == 36 && win_h == 36)   // nis_sharpen, cas_upscale
    return launch<32, 32, 36, 36>(p, batch, s);
  if (tile_w == 32 && tile_h == 48 && win_w == 40 && win_h == 56)   // nis_scaler
    return launch<32, 48, 40, 56>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
