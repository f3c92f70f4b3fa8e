// cas_sharpen.cu — FFX CAS sharpen-only (CasFilter noScaling, renderScale
// 1) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/cas.py::build_cas_sharpen
// (pallas_call at :514): CasFilter without scaling (ffx_cas.h:430-552, the
// mod's cas.sharpen.hlsl flags: CAS_BETTER_DIAGONALS, green-coefficient
// weights) over the game's own frame with zero out-of-image taps (CasLoad),
// clamped to within maxColorDelta of the centre texel. Inside the foveation
// circle (16x16 groups) the output is that colour with alpha 1; outside,
// the source colour times the debug tint with the source's own alpha
// (kernels/cas.py:483-490), stored as packed RGBA8.
//
// What bounds it: bytes moved. At the headset's per-eye size (2 x
// 2244x2492, u32 in and out) one stereo pair reads and writes 44.7 MB each
// way, while the filter is a few dozen f32 ops per pixel. The structural
// sibling of rcas_sharpen.cu: one CTA per 16x16 tile and batch entry (one
// thread per pixel); a tile inside the circle stages its 18x18 haloed
// footprint, decoded to f32, in shared memory once; a tile outside reads
// each texel once and writes it back tinted. The circle test is per tile,
// so it is uniform in a CTA. Build with --fmad=false: the bits then match
// the plain torch version (kernels/cas.py::cas_sharpen_reference).

#include <cuda_runtime.h>

#include <cstdint>

#include "cas_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kTile = 16;          // the 16x16 foveation group
constexpr int kHalo = kTile + 2;   // with the 3x3 taps
constexpr int kThreads = kTile * kTile;

struct Params {
  const uint32_t* img;      // (B, rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;            // (B, h, w) packed RGBA8
  const int64_t* centres;   // (B, 5): cx1, cy1, cx2, cy2, radius_sq
  int h, w, rows, pitch;
  float sharp, mcd, tint;
};

__global__ void __launch_bounds__(kThreads) cas_sharpen_kernel(Params p) {
  __shared__ float s_rgb[3][kHalo][kHalo];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;
  const int x = x0 + tid % kTile, y = y0 + tid / kTile;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.h * p.w;

  if (!rgba8::inside_circle(p.centres + 5 * b, x0, y0, kTile, kTile)) {
    if (x >= p.w || y >= p.h) return;
    const uint32_t t = img[static_cast<size_t>(y) * p.pitch + x];
    out[static_cast<size_t>(y) * p.w + x] =
        rgba8::pack(rgba8::channel(t, 0), rgba8::channel(t, 1) * p.tint,
                    rgba8::channel(t, 2) * p.tint, rgba8::channel(t, 3));
    return;
  }

  // the haloed tile, decoded; texels outside the image are 0 (CasLoad)
  for (int i = tid; i < kHalo * kHalo; i += kThreads) {
    const int ly = i / kHalo, lx = i % kHalo;
    const int sy = y0 - 1 + ly, sx = x0 - 1 + lx;
    const uint32_t t = (sy >= 0 && sy < p.h && sx >= 0 && sx < p.w)
                           ? img[static_cast<size_t>(sy) * p.pitch + sx]
                           : 0u;
#pragma unroll
    for (int c = 0; c < 3; ++c) s_rgb[c][ly][lx] = rgba8::channel(t, c);
  }
  __syncthreads();

  if (x >= p.w || y >= p.h) return;
  const int lx = tid % kTile, ly = tid / kTile;
  float t[3][3][3], res[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) t[r][q][c] = s_rgb[c][ly + r][lx + q];
  cas::sharpen(t, p.sharp, p.mcd, res);
  out[static_cast<size_t>(y) * p.w + x] = rgba8::pack(res[0], res[1], res[2], 1.0f);
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/cas.py) has checked shapes, dtypes and devices.
extern "C" int cas_sharpen_launch(const void* img, void* out, const void* centres, int batch,
                                  int h, int w, int rows, int pitch, float sharp, float mcd,
                                  float tint, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || h > rows || w > pitch)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img = static_cast<const uint32_t*>(img);
  p.out = static_cast<uint32_t*>(out);
  p.centres = static_cast<const int64_t*>(centres);
  p.h = h;
  p.w = w;
  p.rows = rows;
  p.pitch = pitch;
  p.sharp = sharp;
  p.mcd = mcd;
  p.tint = tint;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  cas_sharpen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
