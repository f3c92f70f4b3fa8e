// mxu_rate.cu — the tensor-core rate probe (B8c) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/sol.py::build_mxu_rate
// (pallas_call at :321): `steps` grid steps, each chaining 8 streams of one
// (128, 128) f32 tile through k rounds of s <- (bf16(s) @ bf16(W)) * 1e-3
// with f32 accumulation, the seed (x + step * 2^-20) * 0.125 * (j + 1) for
// stream j, the 8 streams summed and the 128 rows folded to 8. The slope
// over two k is the card's sustained rate for chained bf16 products of this
// shape (tools/vpu_audit.py).
//
// What bounds it: the tensor cores, then the shared-memory reads of W. Each
// round is mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32) in inline PTX: a
// warp chains its 16-row slice of one stream through the k rounds, 16 n8
// tiles x 8 k16 steps = 128 mma per round. The accumulators of two
// neighbouring n8 tiles are, element for element, the A fragment of one k16
// step, so each round's result is scaled by 1e-3, rounded to bf16 and fed to
// the next round in registers (the TPU probe rounds s every round,
// sol.py:299). W is rounded to bf16 once per step (sol.py:294) into shared
// memory, transposed and padded so that ldmatrix reads its B fragments
// without bank conflicts, every round (W does not fit in registers). The
// x1e-3 and the conversion are side work of each round that
// tools/vpu_audit.py counts and prices at the FP32 rate. mma.sync does not
// reach Hopper's full tensor rate (that takes wgmma); this is the simple
// form, and its time stands beside the datasheet bound.
//
// Parallel form of the sequential grid: one CTA per step, 8 warps (one per
// 16-row slice) that run the 8 streams one after another and add them in
// stream order; the CTA adds the two 8-row halves of each slice, then the
// slices in order, into its (8, 128) partial, and a second pass (rates.cuh)
// adds the steps in order. The plain version (kernels/sol.py::
// mxu_rate_reference) does the same with a float32 matrix product of the
// bf16-rounded operands; the mma's summation order inside a product is
// unspecified, so the two agree to a stated tolerance, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rates.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kPitch = kTile + 8;     // bf16 per shared row of W^T (16 B of padding)
constexpr int kWarps = kTile / 16;    // one warp per 16-row slice
constexpr int kThreads = 32 * kWarps;
constexpr float kScale = 1e-3f;
constexpr float kStepScale = 9.5367431640625e-07f;   // 2^-20

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices of W^T from shared memory: the B fragments (k16 x
// n8) of the n8 tiles at n0 and n0 + 8 for the k16 step at k0.
__device__ __forceinline__ void load_b(const uint16_t* s_wt, int n0, int k0, int lane,
                                       uint32_t b[4]) {
  const int m = lane / 8, r = lane % 8;
  const uint16_t* p = s_wt + (n0 + (m / 2) * 8 + r) * kPitch + k0 + (m % 2) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(kThreads, 1) mxu_rate_kernel(const float* __restrict__ x,
                                                               const float* __restrict__ w,
                                                               float* __restrict__ partials,
                                                               int k) {
  // W^T in bf16 during the rounds; then the slices' (8, 128) row sums in f32
  __shared__ __align__(16) uint16_t s_wt[kTile * kPitch];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int step = blockIdx.x;
  const float step_f = static_cast<float>(step) * kStepScale;

  for (int i = tid; i < kTile * kTile; i += kThreads)
    s_wt[(i % kTile) * kPitch + i / kTile] = __bfloat16_as_ushort(__float2bfloat16_rn(w[i]));
  __syncthreads();

  const int r0 = 16 * warp + g, r1 = r0 + 8;   // this thread's rows of the slice
  float acc[16][4];
#pragma unroll 1
  for (int j = 0; j < 8; ++j) {
    const float cj = 0.125f * static_cast<float>(j + 1);
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
      const float* x0 = x + r0 * kTile;
      const float* x1 = x + r1 * kTile;
      a[kk][0] = pack_bf16((x0[c0] + step_f) * cj, (x0[c0 + 1] + step_f) * cj);
      a[kk][1] = pack_bf16((x1[c0] + step_f) * cj, (x1[c0 + 1] + step_f) * cj);
      a[kk][2] = pack_bf16((x0[c1] + step_f) * cj, (x0[c1 + 1] + step_f) * cj);
      a[kk][3] = pack_bf16((x1[c1] + step_f) * cj, (x1[c1 + 1] + step_f) * cj);
    }
    float cf[16][4];
#pragma unroll 1
    for (int r = 0; r < k; ++r) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) cf[nt][0] = cf[nt][1] = cf[nt][2] = cf[nt][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];
          load_b(s_wt, 16 * np, 16 * kk, lane, b);
          mma_bf16(cf[2 * np], a[kk], b[0], b[1]);
          mma_bf16(cf[2 * np + 1], a[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) cf[nt][i] = cf[nt][i] * kScale;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {   // the next round's A: two n8 tiles per k16 step
        a[kk][0] = pack_bf16(cf[2 * kk][0], cf[2 * kk][1]);
        a[kk][1] = pack_bf16(cf[2 * kk][2], cf[2 * kk][3]);
        a[kk][2] = pack_bf16(cf[2 * kk + 1][0], cf[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(cf[2 * kk + 1][2], cf[2 * kk + 1][3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = j == 0 ? cf[nt][i] : acc[nt][i] + cf[nt][i];
  }
  __syncthreads();   // every warp is done with W

  float* s_red = reinterpret_cast<float*>(s_wt);   // (kWarps, 8, 128)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int col = 8 * nt + 2 * t;
    s_red[(warp * 8 + g) * kTile + col] = acc[nt][0] + acc[nt][2];
    s_red[(warp * 8 + g) * kTile + col + 1] = acc[nt][1] + acc[nt][3];
  }
  __syncthreads();
  for (int i = tid; i < 8 * kTile; i += kThreads) {
    float red = s_red[i];
    for (int s = 1; s < kWarps; ++s) red = red + s_red[s * 8 * kTile + i];
    partials[static_cast<size_t>(step) * 8 * kTile + i] = red;
  }
}

}  // namespace

// Launch on `stream`: x and w (128, 128) f32, partials (steps, 8, 128) f32
// scratch, out (8, 128) f32. Returns the launches' cudaError_t (0 =
// launched). tile must be 128 and k at least 1.
extern "C" int mxu_rate_launch(const void* x, const void* w, void* partials, void* out,
                               int tile, int k, int steps, void* stream) {
  if (tile != kTile || k < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mxu_rate_kernel<<<steps, kThreads, 0, s>>>(static_cast<const float*>(x),
                                             static_cast<const float*>(w),
                                             static_cast<float*>(partials), k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rates::sum_partials(static_cast<const float*>(partials), static_cast<float*>(out), steps,
                      8 * kTile, s);
  return static_cast<int>(cudaGetLastError());
}
