// vmem_rate.cu — the shared-memory rate probe (B8b) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/sol.py::build_vmem_rate
// (pallas_call at :257): `steps` grid steps, each folding the k planes of a
// (k, th_e, chunk) f32 block into 8 rotating accumulators with the Horner
// step accs[j % 8] = accs[j % 8] * s_i + x[j] (accs start at 1..8, s_i = 1 -
// i * 2^-20), the 8 accumulators summed and the rows folded to 8 as the FP32
// probe folds them. On the TPU the block is DMA'd to VMEM once and every
// step reads it again; the slope over two k is the rate of those plane
// loads (tools/vpu_audit.py prices each kernel's shared-memory reads at it).
//
// What bounds it: shared-memory loads, by construction: 128 bytes per SM
// and clock. A 7.5 MB block (k = 112) is far beyond an SM's 227 KB, so each
// CTA stages one column of all k planes (58 KB at k = 112, as (k/4, th_e)
// float4) into shared memory once and then runs steps over it: every plane
// word of every step is loaded from shared memory, four planes per 16-byte
// load (LDS.128). The planes do not change between steps, so a compiler
// could keep them in registers and the probe would meter registers: a
// compiler memory barrier at each step forces every load of the step loop to
// be made again (chip_smoke.py counts the LDS in the SASS). Per loaded word
// the loop does one FMUL and one FADD (the Horner step), which
// tools/vpu_audit.py counts and prices at the FP32 rate as the side work.
//
// The design keeps the loads coming:
//   - a CTA runs groups = kMaxThreads / th_e step groups over its one staged
//     column (4 at th_e = 130): thread t is row t % th_e of group t / th_e,
//     so every warp is full but the CTA's last, and the 58 KB of planes feed
//     groups x th_e threads; at 3 CTAs per SM (by shared memory and the
//     register budget of __launch_bounds__) that is 51 warps per SM;
//   - the planes are read in blocks of 8 (two LDS.128, one per half of the
//     accumulators) with no predicate, unrolled 4 times so that several
//     loads are in flight; only the last k % 8 planes take a predicated loop
//     (none at the audit's k). No plane is padded: acc * s + 0 would round;
//   - a step ends with one barrier: the row sums go to one of two buffers by
//     step parity, and the first 8 x groups threads fold the step just
//     written while the others run on into the next step.
//
// Parallel form of the sequential grid: the columns are independent, and
// the steps are split into `shares` contiguous ranges, one per group: CTA
// (column, c) runs shares c * groups .. c * groups + groups - 1. A group
// runs its steps in order, folds each step's rows to 8 and adds the folds in
// step order, as the TPU probe accumulates its output block; a second pass
// (rates.cuh) adds the shares in order. With one share that is the JAX
// probe's order exactly. The plain version (kernels/sol.py::
// vmem_rate_reference) repeats it, so the two are equal bit for bit
// (--fmad=false).

#include <cuda_runtime.h>

#include <cstdint>

#include "rates.cuh"

namespace {

constexpr int kMaxThreads = 544;   // groups x th_e threads per CTA: 17 warps
constexpr int kMinCtas = 3;        // CTAs per SM the register budget allows
constexpr float kStepScale = 9.5367431640625e-07f;   // 2^-20

// The step groups of one CTA: as many as kMaxThreads threads hold.
__host__ __device__ int groups_of(int th_e) { return kMaxThreads / th_e; }

__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
    vmem_rate_kernel(const float* __restrict__ x, float* __restrict__ partials, int th_e,
                     int chunk, int k, int steps, int shares) {
  extern __shared__ float4 s_dyn[];
  const int quads = (k + 3) / 4;
  const int groups = groups_of(th_e);
  float4* planes = s_dyn;                                        // (quads, th_e)
  float* sums = reinterpret_cast<float*>(s_dyn + quads * th_e);  // (2, groups, th_e)
  const int t = threadIdx.x, col = blockIdx.x;
  const int g = t / th_e, row = t - g * th_e;

  for (int i = t; i < quads * th_e; i += blockDim.x) {
    const int q = i / th_e, r = i - q * th_e;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      v[u] = j < k ? x[(static_cast<size_t>(j) * th_e + r) * chunk + col] : 0.0f;
    }
    planes[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // this thread's group's share, and the share whose rows it folds (the
  // first 8 x groups threads: row t % 8 of group t / 8)
  const int share = blockIdx.y * groups + g;
  const int first = static_cast<int>(static_cast<int64_t>(share) * steps / shares);
  const int n = share < shares
                    ? static_cast<int>(static_cast<int64_t>(share + 1) * steps / shares) - first
                    : 0;
  const int fold = t < 8 * groups ? blockIdx.y * groups + t / 8 : shares;
  const int fold_n =
      fold < shares ? static_cast<int>(static_cast<int64_t>(fold + 1) * steps / shares -
                                       static_cast<int64_t>(fold) * steps / shares)
                    : 0;
  const int trips = (steps + shares - 1) / shares;   // the most steps of any share
  const float4* mine = planes + row;
  const int pairs = k / 8;
  float red = 0.0f;
  for (int i = 0; i < trips; ++i) {
    float* buf = sums + (i & 1) * groups * th_e;
    if (i < n) {
      asm volatile("" ::: "memory");   // the planes are read anew at every step
      const float s = 1.0f - static_cast<float>(first + i) * kStepScale;
      float acc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = static_cast<float>(u + 1);
      // planes 8 p .. 8 p + 7: no predicate
#pragma unroll 4
      for (int q = 0; q < 2 * pairs; q += 2) {
        const float4 a = mine[q * th_e];
        const float4 b = mine[(q + 1) * th_e];
        acc[0] = acc[0] * s + a.x;
        acc[1] = acc[1] * s + a.y;
        acc[2] = acc[2] * s + a.z;
        acc[3] = acc[3] * s + a.w;
        acc[4] = acc[4] * s + b.x;
        acc[5] = acc[5] * s + b.y;
        acc[6] = acc[6] * s + b.z;
        acc[7] = acc[7] * s + b.w;
      }
      // the last k % 8 planes
#pragma unroll 1
      for (int q0 = 2 * pairs; q0 < quads; q0 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (q0 + h >= quads) break;
          const float4 v = mine[(q0 + h) * th_e];
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * (q0 + h) + u < k) acc[4 * h + u] = acc[4 * h + u] * s + w[u];
        }
      }
      float a = acc[0];
#pragma unroll
      for (int u = 1; u < 8; ++u) a = a + acc[u];
      buf[g * th_e + row] = a;
    }
    __syncthreads();
    if (i < fold_n) {   // the fold (sol.py:228-234), accumulated over the steps
      const float* e = buf + (t / 8) * th_e;
      const int r0 = t % 8;
      float f = e[r0];
      for (int r = 8; r < th_e - 7; r += 8) f = f + e[r + r0];
      if (th_e % 8) f = f + e[th_e - 8 + r0];
      red = i == 0 ? f : red + f;
    }
  }
  if (fold_n > 0) partials[(static_cast<size_t>(fold) * 8 + t % 8) * chunk + col] = red;
}

}  // namespace

// Dynamic shared memory of one CTA: k planes of one column (k rounded up to
// a multiple of 4) and two buffers of the groups' row sums.
extern "C" int vmem_rate_smem_bytes(int th_e, int k) {
  return (((k + 3) / 4) * 4 * th_e + 2 * groups_of(th_e) * th_e) *
         static_cast<int>(sizeof(float));
}

// Launch on `stream`: x (k, th_e, chunk) f32, partials (shares, 8, chunk)
// f32 scratch, out (8, chunk) f32; the steps are split into `shares`
// contiguous ranges, `groups_of(th_e)` of them per CTA. Returns the
// launches' cudaError_t (0 = launched).
extern "C" int vmem_rate_launch(const void* x, void* partials, void* out, int th_e, int chunk,
                                int k, int steps, int shares, void* stream) {
  if (th_e < 8 || th_e > kMaxThreads || chunk < 1 || chunk > 65535 || k < 1 || steps < 1 ||
      shares < 1 || shares > steps || shares > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = groups_of(th_e);
  const int smem = vmem_rate_smem_bytes(th_e, k);
  cudaError_t err = cudaFuncSetAttribute(vmem_rate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  vmem_rate_kernel<<<dim3(chunk, (shares + groups - 1) / groups), groups * th_e, smem, s>>>(
      static_cast<const float*>(x), static_cast<float*>(partials), th_e, chunk, k, steps, shares);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rates::sum_partials(static_cast<const float*>(partials), static_cast<float*>(out), shares,
                      8 * chunk, s);
  return static_cast<int>(cudaGetLastError());
}
