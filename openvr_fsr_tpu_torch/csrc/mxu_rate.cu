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
// What bounds it: the tensor cores. Each round is 8 warpgroup products
// wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32) in inline PTX per 64-row
// half of a stream, A from registers, B = W^T from shared memory through a
// matrix descriptor: the only way to Hopper's full tensor rate (mma.sync
// reaches about half of it). W is rounded to bf16 once per step (sol.py:294)
// and staged once per CTA as W^T in the K-major layout with the 128-byte
// swizzle (wt_offset; kernels/sol.py::wt_swizzle_offset states it), so each
// k16 product reads B once per 64 rows, 4x fewer shared bytes per MAC than
// ldmatrix per 16 rows. The accumulators of one warp are, element for
// element, the m16n8 layout of mma.sync: two neighbouring n8 columns are the
// A fragment of one k16 step, so each round's result is scaled by 1e-3,
// rounded to bf16 and fed to the next round in registers (the TPU probe
// rounds s every round, sol.py:299). The chain forces a wait every round:
// wgmma.fence (A was just written), 8 products, commit, wait. The x1e-3 and
// the conversion are side work that tools/vpu_audit.py counts and prices at
// the FP32 rate.
//
// Parallel form of the sequential grid: one CTA per step, two warpgroups
// (one per 64-row half), two CTAs per SM, so four independent chains hide
// each other's waits. Each warpgroup runs the 8 streams one after another
// and adds them in stream order into a per-thread sum in shared memory
// (registers hold the 64 accumulators and 32 A words); the CTA adds the two
// 8-row halves of each 16-row slice (one warp each), then the slices in
// order, into its (8, 128) partial, and a second pass (rates.cuh) adds the
// steps in order. The plain version (kernels/sol.py::mxu_rate_reference)
// does the same with a float32 matrix product of the bf16-rounded operands;
// the tensor cores' summation order inside a product is their own, so the
// two agree to a stated tolerance, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rates.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kGroups = 2;                 // warpgroups per CTA: the two 64-row halves
constexpr int kThreads = 128 * kGroups;
constexpr int kMinCtas = 2;                // CTAs per SM: four chains
constexpr int kAcc = 64;                   // f32 accumulators per thread (m64n128)
constexpr int kWtBytes = kTile * kTile * 2;                  // W^T in bf16
constexpr int kSumBytes = kGroups * kAcc * 128 * 4;          // the stream sums
constexpr int kSwizzle = 1024;             // the 128-byte swizzle's atom: 8 rows of 128 B
constexpr int kSmemBytes = kWtBytes + kSumBytes + kSwizzle;  // + the alignment slack
constexpr float kScale = 1e-3f;
constexpr float kStepScale = 9.5367431640625e-07f;   // 2^-20

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of W^T element (n, k) in the K-major tile with the 128-byte
// swizzle: two 16 KB atoms along K (k < 64, k >= 64), each 128 rows of 64
// bf16 (128 B) in blocks of 8 rows (1 KB), the 16-byte chunk k / 8 of row n
// stored at chunk (k / 8) ^ (n % 8).
__device__ __forceinline__ int wt_offset(int n, int k) {
  return (k / 64) * (kTile * 128) + (n / 8) * 1024 + (n % 8) * 128 +
         (((k % 64) / 8) ^ (n % 8)) * 16 + (k % 8) * 2;
}

// The descriptor of W^T for the k16 step kk: the atom of its K, 32 B per
// k16 step inside it; leading offset unused for a swizzled K-major operand
// (1), stride 1024 B between blocks of 8 rows, the 128-byte swizzle.
__device__ __forceinline__ uint64_t wt_desc(uint32_t wt_addr, int kk) {
  const uint32_t addr = wt_addr + (kk / 4) * (kTile * 128) + (kk % 4) * 32;
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a @ B for one k16 step: m64n128k16, A (this warp's 16 rows) from
// registers, B from shared memory; accumulate = false overwrites d.
__device__ __forceinline__ void wgmma_k16(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t desc,
                                          bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %68, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(static_cast<int>(accumulate)), "l"(desc));
}

// Keep the compiler from moving reads or writes of these registers across
// the wgmma fence and wait around them (the products read and write them
// asynchronously).
__device__ __forceinline__ void pin(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

__global__ void __launch_bounds__(kThreads, kMinCtas) mxu_rate_kernel(const float* __restrict__ x,
                                                                      const float* __restrict__ w,
                                                                      float* __restrict__ partials,
                                                                      int k) {
  extern __shared__ uint8_t s_dyn[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s_dyn));
  uint8_t* s_wt = s_dyn + (kSwizzle - base % kSwizzle) % kSwizzle;   // the atoms' alignment
  const uint32_t wt_addr = static_cast<uint32_t>(__cvta_generic_to_shared(s_wt));
  const int tid = threadIdx.x, group = tid / 128, gtid = tid % 128;
  const int warp = tid / 32, lane = tid % 32;   // warp = the 16-row slice
  const int g = lane / 4, t = lane % 4;
  // this thread's 64 stream sums, element i at i * 128 + gtid
  float* s_sum = reinterpret_cast<float*>(s_wt + kWtBytes) + group * kAcc * 128 + gtid;
  const int step = blockIdx.x;
  const float step_f = static_cast<float>(step) * kStepScale;

  for (int i = tid; i < kTile * kTile; i += kThreads)   // i = k * 128 + n: W[k][n]
    *reinterpret_cast<__nv_bfloat16*>(s_wt + wt_offset(i % kTile, i / kTile)) =
        __float2bfloat16_rn(w[i]);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
  __syncthreads();

  const int r0 = 16 * warp + g, r1 = r0 + 8;   // this thread's rows of the step's tile
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
    float d[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0.0f;
#pragma unroll 1
    for (int r = 0; r < k; ++r) {
      pin(a);
      pin(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) wgmma_k16(d, a[kk], wt_desc(wt_addr, kk), kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(d);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) d[i] = d[i] * kScale;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {   // the next round's A: two n8 columns per k16 step
        a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
        a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
        a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
        a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) s_sum[i * 128] = j == 0 ? d[i] : s_sum[i * 128] + d[i];
  }
  __syncthreads();   // every warpgroup is done with W^T

  float* s_red = reinterpret_cast<float*>(s_wt);   // (8 slices, 8, 128)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {   // accumulators 4 nt .. 4 nt + 3: rows g, g + 8
    const int col = 8 * nt + 2 * t;
    s_red[(warp * 8 + g) * kTile + col] = s_sum[(4 * nt) * 128] + s_sum[(4 * nt + 2) * 128];
    s_red[(warp * 8 + g) * kTile + col + 1] =
        s_sum[(4 * nt + 1) * 128] + s_sum[(4 * nt + 3) * 128];
  }
  __syncthreads();
  for (int i = tid; i < 8 * kTile; i += kThreads) {
    float red = s_red[i];
    for (int s = 1; s < kTile / 16; ++s) red = red + s_red[s * 8 * kTile + i];
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
  cudaError_t err = cudaFuncSetAttribute(mxu_rate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mxu_rate_kernel<<<steps, kThreads, kSmemBytes, s>>>(static_cast<const float*>(x),
                                                      static_cast<const float*>(w),
                                                      static_cast<float*>(partials), k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rates::sum_partials(static_cast<const float*>(partials), static_cast<float*>(out), steps,
                      8 * kTile, s);
  return static_cast<int>(cudaGetLastError());
}
