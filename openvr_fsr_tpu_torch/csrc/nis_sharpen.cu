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
// (kernels/nis.py:238-241). Stored in the frame's format: packed RGBA8, or
// R10G10B10A2 as four uint16 (the JAX builder's color_bits=10 branch,
// nis.py:125: only the texel decode and encode change, NIS_SCALE_FLOAT
// stays 255; the codecs of codec.cuh, one instantiation of every kernel
// each, behind nis_sharpen_launch and nis_sharpen_launch10).
//
// What bounds it: bytes moved outside the circle (one texel load and store
// per output; at the headset's per-eye size, 2 x 2244x2492, one stereo pair
// reads and writes 44.7 MB each way in RGBA8, 89.5 MB in R10G10B10A2), and
// inside it the per-pixel math (a few hundred f32 ops) and the
// shared-memory words of its 5x5 support.
//
// The design follows the reference's own block of 32x32 pixels:
//   - the host (kernels/_maps.py::sharpen_maps) evaluates the circle test
//     once per build and per block and splits the blocks into an inside and
//     an outside list; every output of an inside block is inside.
//   - nis_sharpen_outside_kernel runs the outside list: the shared copy pass
//     (copy_pass.cuh, alpha 1): 4 outputs of one row per thread, 16-byte
//     loads and stores, no shared memory, no barrier.
//   - nis_sharpen_inside_kernel runs the inside list, one CTA per block: the
//     block's 36x36 edge-clamped window is loaded once and staged twice, as
//     lumas (the reference's shared-memory tile, NIS_Scaler.h:886-906) and as
//     texels (4 or 8 bytes each), one barrier; then each thread takes 4 outputs of one
//     column (a warp reads and stores whole rows: no bank conflicts), and
//     the 5x5 luma support slides down the run in registers: the first
//     output reads 25 lumas, each later one only its new bottom row's 5 (10
//     per output). The centre texel comes from the staged texels, so the
//     kernel loads each window word from device memory once.
// Both launch on the caller's stream; an empty list launches nothing. The
// TPU kernel's one-hot row gathers, concat-shift columns and DMA ring have
// no counterpart.
//
// Half precision (the JAX kernel's precision="half", nis.py:126-137,
// 187-226): nis_sharpen_half_inside_kernel is the inside kernel's body with
// GetDirUSM in bf16 op by op (nis::eval_usm<ffx::Half>): the staged luma is
// rounded to bf16 once (held as f32 in the same plane), the edge map reads
// those rounded lumas, the combine stays f32, and the linear-HDR correction
// takes the centre's f32 luma, recomputed from its staged texel; the host
// rounds the constants of the USM (kernels/nis.py::_consts). The copy
// outside the circle is the same. One instantiation per codec behind
// nis_sharpen_launch_h and nis_sharpen_launch10_h.
// Build with --fmad=false: the bits then match the plain torch version
// (kernels/nis.py::nvsharpen_reference).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "codec.cuh"
#include "copy_pass.cuh"
#include "ffx_math.cuh"
#include "nis_math.cuh"

namespace {

constexpr int kBlock = 32;         // the 32x32 NIS sharpen block (kernels/_maps.py SHARPEN_TILE)
constexpr int kWin = kBlock + 4;   // with the +-2 luma support (NIS_SHARPEN_IN_TILE)
constexpr int kThreads = 256;
constexpr int kRun = kBlock * kBlock / kThreads;   // outputs per thread (4), one column

template <class C>
struct Params {
  const typename C::Texel* img;   // (B, rows, pitch) texels
  typename C::Texel* out;         // (B, h, w) texels
  const int32_t* tiles;     // the inside list: b * tiles_y * tiles_x + ty * tiles_x + tx
  nis::Consts k;
  int h, w, rows, pitch, tiles_x, tiles_y, hdr_mode;
  float tint;
};

// The inside kernel's shared memory: the edge-clamped window as lumas and as
// texels.
template <class C>
struct Smem {
  float y[kWin][kWin];
  typename C::Texel t[kWin][kWin];
};

// One inside block (the CTA's of the list) in the working precision P
// (ffx::Full, ffx::Half).
template <class C, class P>
__device__ __forceinline__ void inside_block(const Params<C>& p) {
  using Texel = typename C::Texel;
  __shared__ Smem<C> s;

  const int tid = threadIdx.x;
  const int id = p.tiles[blockIdx.x];
  const int per = p.tiles_x * p.tiles_y;
  const int b = id / per;
  const int ty = (id - b * per) / p.tiles_x;
  const int tx = id - b * per - ty * p.tiles_x;
  const int x0 = tx * kBlock, y0 = ty * kBlock;
  const Texel* img = p.img + static_cast<size_t>(b) * p.rows * p.pitch;

  // the block with the +-2 support, edge-clamped, once
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int ly = i / kWin, lx = i % kWin;
    const int sy = rgba8::clampi(y0 - 2 + ly, 0, p.h - 1);
    const int sx = rgba8::clampi(x0 - 2 + lx, 0, p.w - 1);
    const Texel t = img[static_cast<size_t>(sy) * p.pitch + sx];
    s.t[ly][lx] = t;
    s.y[ly][lx] =
        P::r(nis::get_y(C::channel(t, 0), C::channel(t, 1), C::channel(t, 2), p.hdr_mode));
  }
  __syncthreads();

  // this thread's outputs: column x, rows oy0 .. oy0 + kRun - 1
  const int lx = tid % kBlock, ly0 = (tid / kBlock) * kRun;
  const int x = x0 + lx, oy0 = y0 + ly0;
  if (x >= p.w || oy0 >= p.h) return;
  Texel* out = p.out + static_cast<size_t>(b) * p.h * p.w;
  const nis::Consts& k = p.k;
  float q[5][5];   // the support of output row oy0 + r: window rows ly0 + r .. + 4
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (oy0 + r >= p.h) break;
    if (r > 0) {   // slide one row down
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 5; ++c) q[i][c] = q[i + 1][c];
    }
#pragma unroll
    for (int i = (r == 0 ? 0 : 4); i < 5; ++i)
#pragma unroll
      for (int c = 0; c < 5; ++c) q[i][c] = s.y[ly0 + r + i][lx + c];

    // GetDirUSM (NIS_Scaler.h:819-871)
    const float yc = q[2][2];
    const float scale_y =
        P::r(1.0f - ffx::sat(P::r(P::r(yc - k.sharp_start_y) * k.sharp_scale_y)));
    const float strength = P::r(P::r(scale_y * k.sharp_strength_scale) + k.sharp_strength_min);
    const float limit = P::r(P::r(P::r(scale_y * k.sharp_limit_scale) + k.sharp_limit_min) * yc);
    const float v0[5] = {q[0][2], q[1][2], q[2][2], q[3][2], q[4][2]};
    const float v90[5] = {q[2][0], q[2][1], q[2][2], q[2][3], q[2][4]};
    const float v45[5] = {q[1][1], nis::lerp<P>(q[2][1], q[1][2], 0.5f), q[2][2],
                          nis::lerp<P>(q[3][2], q[2][3], 0.5f), q[3][3]};
    const float v135[5] = {q[3][1], nis::lerp<P>(q[3][2], q[2][1], 0.5f), q[2][2],
                           nis::lerp<P>(q[2][3], q[1][2], 0.5f), q[1][3]};
    const float d0 = nis::eval_usm<P>(v0, strength, limit, k);
    const float d90 = nis::eval_usm<P>(v90, strength, limit, k);
    const float d45 = nis::eval_usm<P>(v45, strength, limit, k);
    const float d135 = nis::eval_usm<P>(v135, strength, limit, k);

    // edge-map weights on the 3x3 centred in the 5x5 (Half: of the rounded
    // lumas)
    float pc[3][3], wgt[4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) pc[i][c] = q[i + 1][c + 1];
    nis::edge_map(pc, k, wgt);
    const float usm_y = d0 * wgt[0] + d90 * wgt[1] + d45 * wgt[2] + d135 * wgt[3];

    const Texel t = s.t[ly0 + r + 2][lx + 2];   // the output's own texel
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = C::channel(t, c);
    if (p.hdr_mode == 1) {  // multiplicative luma fix (NIS_Scaler.h:951-959)
      // of the f32 luma: Half staged it rounded
      const float y = P::kHalf ? nis::get_y(rgb[0], rgb[1], rgb[2], 1) : yc;
      const float new_y = ffx::max_nan(y + usm_y, 0.0f);
      const float corr = (new_y * new_y + k.sharpen_hdr_eps) / (y * y + k.sharpen_hdr_eps);
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] * corr;
    } else {  // SDR and PQ: additive (:961-963)
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + usm_y;
    }
    out[static_cast<size_t>(oy0 + r) * p.w + x] = C::pack(rgb[0], rgb[1], rgb[2], C::channel(t, 3));
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) nis_sharpen_inside_kernel(Params<C> p) {
  inside_block<C, ffx::Full>(p);
}
template <class C>
__global__ void __launch_bounds__(kThreads) nis_sharpen_half_inside_kernel(Params<C> p) {
  inside_block<C, ffx::Half>(p);
}

// The inside kernel of precision P.
template <class C, class P>
auto inside_kernel() {
  if constexpr (P::kHalf)
    return nis_sharpen_half_inside_kernel<C>;
  else
    return nis_sharpen_inside_kernel<C>;
}

// The outside list: the shared copy pass, alpha 1.
template <class C>
__global__ void __launch_bounds__(copy_pass::kThreads)
    nis_sharpen_outside_kernel(copy_pass::Args<C> a) {
  copy_pass::run<kBlock, kBlock, false, C>(a);
}

template <class C, class P>
int occupancy(int* outside, int* inside, int* inside_smem) {
  *inside_smem = static_cast<int>(sizeof(Smem<C>));
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      outside, nis_sharpen_outside_kernel<C>, copy_pass::kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(inside, inside_kernel<C, P>(), kThreads,
                                                        0);
  return static_cast<int>(err);
}

template <class C, class P>
int launch(const void* img, void* out, const void* inside_tiles, int n_inside,
           const void* outside_tiles, int n_outside, const float* consts, int n_consts,
           int batch, int h, int w, int rows, int pitch, int hdr_mode, float tint, int tile,
           int window, void* stream) {
  using Texel = typename C::Texel;
  if (tile != kBlock || window != kWin || n_consts != nis::kNumConsts || batch <= 0 || h <= 0 ||
      w <= 0 || h > rows || w > pitch || hdr_mode < 0 || hdr_mode > 2 || n_inside < 0 ||
      n_outside < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<C> p;
  p.img = static_cast<const Texel*>(img);
  p.out = static_cast<Texel*>(out);
  p.tiles = static_cast<const int32_t*>(inside_tiles);
  std::memcpy(&p.k, consts, sizeof(p.k));
  p.h = h;
  p.w = w;
  p.rows = rows;
  p.pitch = pitch;
  p.tiles_x = (w + kBlock - 1) / kBlock;
  p.tiles_y = (h + kBlock - 1) / kBlock;
  p.hdr_mode = hdr_mode;
  p.tint = tint;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_outside > 0) {
    const copy_pass::Args<C> a = {p.img, p.out, static_cast<const int32_t*>(outside_tiles), h,
                                  w, rows, pitch, p.tiles_x, p.tiles_y, tint};
    nis_sharpen_outside_kernel<C><<<n_outside, copy_pass::kThreads, 0, s>>>(a);
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
// shared memory per CTA in bytes, for RGBA8 (nis_sharpen_occupancy) and
// R10G10B10A2 (nis_sharpen_occupancy10). Returns the first non-zero
// cudaError_t.
extern "C" int nis_sharpen_occupancy(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Full>(outside, inside, inside_smem);
}
extern "C" int nis_sharpen_occupancy10(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Full>(outside, inside, inside_smem);
}
// The same for the half instantiations (nis_sharpen_launch_h, _launch10_h).
extern "C" int nis_sharpen_occupancy_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgba8, ffx::Half>(outside, inside, inside_smem);
}
extern "C" int nis_sharpen_occupancy10_h(int* outside, int* inside, int* inside_smem) {
  return occupancy<codec::Rgb10a2, ffx::Half>(outside, inside, inside_smem);
}

// Launch on `stream`: the copy pass over outside_tiles, then the inside
// kernel over inside_tiles (an empty list launches nothing), on packed
// RGBA8 texels (nis_sharpen_launch) or R10G10B10A2 ones
// (nis_sharpen_launch10). Returns the first non-zero cudaError_t (0 =
// launched). The caller (kernels/nis.py) has checked shapes, dtypes and
// devices and that the lists partition the blocks; consts points to
// nis::kNumConsts host floats in nis::Consts order; tile and window must
// equal kBlock and kWin.
extern "C" int nis_sharpen_launch(const void* img, void* out, const void* inside_tiles,
                                  int n_inside, const void* outside_tiles, int n_outside,
                                  const float* consts, int n_consts, int batch, int h, int w,
                                  int rows, int pitch, int hdr_mode, float tint, int tile,
                                  int window, void* stream) {
  return launch<codec::Rgba8, ffx::Full>(img, out, inside_tiles, n_inside, outside_tiles,
                                         n_outside, consts, n_consts, batch, h, w, rows, pitch,
                                         hdr_mode, tint, tile, window, stream);
}
extern "C" int nis_sharpen_launch10(const void* img, void* out, const void* inside_tiles,
                                    int n_inside, const void* outside_tiles, int n_outside,
                                    const float* consts, int n_consts, int batch, int h, int w,
                                    int rows, int pitch, int hdr_mode, float tint, int tile,
                                    int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Full>(img, out, inside_tiles, n_inside, outside_tiles,
                                           n_outside, consts, n_consts, batch, h, w, rows, pitch,
                                           hdr_mode, tint, tile, window, stream);
}

// The half instantiations, the same prototype (consts: kernels/nis.py::
// _consts at bf16).
extern "C" int nis_sharpen_launch_h(const void* img, void* out, const void* inside_tiles,
                                    int n_inside, const void* outside_tiles, int n_outside,
                                    const float* consts, int n_consts, int batch, int h, int w,
                                    int rows, int pitch, int hdr_mode, float tint, int tile,
                                    int window, void* stream) {
  return launch<codec::Rgba8, ffx::Half>(img, out, inside_tiles, n_inside, outside_tiles,
                                         n_outside, consts, n_consts, batch, h, w, rows, pitch,
                                         hdr_mode, tint, tile, window, stream);
}
extern "C" int nis_sharpen_launch10_h(const void* img, void* out, const void* inside_tiles,
                                      int n_inside, const void* outside_tiles, int n_outside,
                                      const float* consts, int n_consts, int batch, int h,
                                      int w, int rows, int pitch, int hdr_mode, float tint,
                                      int tile, int window, void* stream) {
  return launch<codec::Rgb10a2, ffx::Half>(img, out, inside_tiles, n_inside, outside_tiles,
                                           n_outside, consts, n_consts, batch, h, w, rows, pitch,
                                           hdr_mode, tint, tile, window, stream);
}
