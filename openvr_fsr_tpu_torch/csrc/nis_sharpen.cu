// nis_sharpen.cu — NVIDIA Image Scaling NVSharpen (NIS at renderScale 1) for
// Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/nis.py::build_nvsharpen
// (pallas_call at :265): NVSharpen (NIS_Scaler.h:876-971) over the game's
// own frame, with HDR modes 0/1/2. Per pixel: the 5x5 edge-clamped luma
// support (getY), the directional USM with the fixed [-0.6001, 1.2002,
// -0.6001] profile and CalcLTIFast, blended by the edge-map weights of the
// centred 3x3, then the additive (SDR, PQ) or multiplicative (linear HDR)
// luma correction of the source colour. Inside the foveation circle (32x32
// blocks, NIS_Sharpen.hlsl:93-105) the source alpha is kept; outside, the
// DirectCopy writes the source colour times the debug tint with alpha 1
// (kernels/nis.py:238-241). Stored as packed RGBA8.
//
// What bounds it: bytes moved and, inside the circle, the per-pixel math. At
// the headset's per-eye size (2 x 2244x2492, u32 in and out) one stereo pair
// reads and writes 44.7 MB each way; NVSharpen is a few hundred f32 ops per
// pixel. The simple design follows the reference's own: one CTA of 256
// threads per 32x32 block and batch entry stages the block's 36x36
// edge-clamped luma once in shared memory, and each thread evaluates 4
// pixels from it; a block outside the circle only copies. The circle test
// is per block, so it is uniform in a CTA. The TPU kernel's one-hot row
// gathers, concat-shift columns and DMA ring have no counterpart. Build with
// --fmad=false: the bits then match the plain torch version
// (kernels/nis.py::nvsharpen_reference).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "ffx_math.cuh"
#include "nis_math.cuh"
#include "rgba8.cuh"

namespace {

constexpr int kBlock = 32;             // the 32x32 NIS sharpen block
constexpr int kSup = kBlock + 4;       // with the +-2 luma support
constexpr int kThreads = 256;

struct Params {
  const uint32_t* img;      // (B, rows, pitch) packed RGBA8, R in the low byte
  uint32_t* out;            // (B, h, w) packed RGBA8
  const int64_t* centres;   // (B, 5): cx1, cy1, cx2, cy2, radius_sq
  nis::Consts k;
  int h, w, rows, pitch, hdr_mode;
  float tint;
};

__global__ void __launch_bounds__(kThreads) nis_sharpen_kernel(Params p) {
  __shared__ float s_y[kSup][kSup];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kBlock, y0 = blockIdx.y * kBlock;
  const uint32_t* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;
  uint32_t* out = p.out + static_cast<size_t>(b) * p.h * p.w;

  if (!rgba8::inside_circle(p.centres + 5 * b, x0, y0, kBlock, kBlock)) {
    for (int i = tid; i < kBlock * kBlock; i += kThreads) {
      const int x = x0 + i % kBlock, y = y0 + i / kBlock;
      if (x >= p.w || y >= p.h) continue;
      const uint32_t t = img[static_cast<size_t>(y) * p.pitch + x];
      out[static_cast<size_t>(y) * p.w + x] =
          rgba8::pack(rgba8::channel(t, 0), rgba8::channel(t, 1) * p.tint,
                      rgba8::channel(t, 2) * p.tint, 1.0f);
    }
    return;
  }

  // the block's luma with the +-2 support, edge-clamped (the reference's
  // shared-memory tile, NIS_Scaler.h:886-906)
  for (int i = tid; i < kSup * kSup; i += kThreads) {
    const int ly = i / kSup, lx = i % kSup;
    const int sy = rgba8::clampi(y0 - 2 + ly, 0, p.h - 1);
    const int sx = rgba8::clampi(x0 - 2 + lx, 0, p.w - 1);
    const uint32_t t = img[static_cast<size_t>(sy) * p.pitch + sx];
    s_y[ly][lx] = nis::get_y(rgba8::channel(t, 0), rgba8::channel(t, 1), rgba8::channel(t, 2),
                             p.hdr_mode);
  }
  __syncthreads();

  const nis::Consts& k = p.k;
  for (int i = tid; i < kBlock * kBlock; i += kThreads) {
    const int lx = i % kBlock, ly = i / kBlock;
    const int x = x0 + lx, y = y0 + ly;
    if (x >= p.w || y >= p.h) continue;
    float q[5][5];
#pragma unroll
    for (int r = 0; r < 5; ++r)
#pragma unroll
      for (int c = 0; c < 5; ++c) q[r][c] = s_y[ly + r][lx + c];

    // GetDirUSM (NIS_Scaler.h:819-871)
    const float yc = q[2][2];
    const float scale_y = 1.0f - ffx::sat((yc - k.sharp_start_y) * k.sharp_scale_y);
    const float strength = scale_y * k.sharp_strength_scale + k.sharp_strength_min;
    const float limit = (scale_y * k.sharp_limit_scale + k.sharp_limit_min) * yc;
    const float v0[5] = {q[0][2], q[1][2], q[2][2], q[3][2], q[4][2]};
    const float v90[5] = {q[2][0], q[2][1], q[2][2], q[2][3], q[2][4]};
    const float v45[5] = {q[1][1], nis::lerp(q[2][1], q[1][2], 0.5f), q[2][2],
                          nis::lerp(q[3][2], q[2][3], 0.5f), q[3][3]};
    const float v135[5] = {q[3][1], nis::lerp(q[3][2], q[2][1], 0.5f), q[2][2],
                           nis::lerp(q[2][3], q[1][2], 0.5f), q[1][3]};
    const float d0 = nis::eval_usm(v0, strength, limit, k);
    const float d90 = nis::eval_usm(v90, strength, limit, k);
    const float d45 = nis::eval_usm(v45, strength, limit, k);
    const float d135 = nis::eval_usm(v135, strength, limit, k);

    // edge-map weights on the 3x3 centred in the 5x5
    float pc[3][3], wgt[4];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) pc[r][c] = q[r + 1][c + 1];
    nis::edge_map(pc, k, wgt);
    const float usm_y = d0 * wgt[0] + d90 * wgt[1] + d45 * wgt[2] + d135 * wgt[3];

    const uint32_t t = img[static_cast<size_t>(y) * p.pitch + x];
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = rgba8::channel(t, c);
    if (p.hdr_mode == 1) {  // multiplicative luma fix (NIS_Scaler.h:951-959)
      const float new_y = ffx::max_nan(yc + usm_y, 0.0f);
      const float corr = (new_y * new_y + k.sharpen_hdr_eps) / (yc * yc + k.sharpen_hdr_eps);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * corr;
    } else {  // SDR and PQ: additive (:961-963)
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + usm_y;
    }
    out[static_cast<size_t>(y) * p.w + x] = rgba8::pack(rgb[0], rgb[1], rgb[2], rgba8::channel(t, 3));
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/nis.py) has checked shapes, dtypes and devices. consts
// points to nis::kNumConsts host floats in nis::Consts order.
extern "C" int nis_sharpen_launch(const void* img, void* out, const void* centres,
                                  const float* consts, int n_consts, int batch, int h, int w,
                                  int rows, int pitch, int hdr_mode, float tint, void* stream) {
  if (n_consts != nis::kNumConsts || batch <= 0 || h <= 0 || w <= 0 || h > rows || w > pitch ||
      hdr_mode < 0 || hdr_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.img = static_cast<const uint32_t*>(img);
  p.out = static_cast<uint32_t*>(out);
  p.centres = static_cast<const int64_t*>(centres);
  std::memcpy(&p.k, consts, sizeof(p.k));
  p.h = h;
  p.w = w;
  p.rows = rows;
  p.pitch = pitch;
  p.hdr_mode = hdr_mode;
  p.tint = tint;
  const dim3 grid((w + kBlock - 1) / kBlock, (h + kBlock - 1) / kBlock, batch);
  nis_sharpen_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
