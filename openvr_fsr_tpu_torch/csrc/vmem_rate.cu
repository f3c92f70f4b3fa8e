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
// What bounds it: shared-memory loads, by construction. A 7.5 MB block (k =
// 112) is far beyond an SM's 227 KB, so each CTA stages one column of all k
// planes (58 KB at k = 112) into shared memory once and then runs its
// share of the steps over it: thread `row` reads its element of every
// plane at every step, four planes per 16-byte load (LDS.128; the planes
// are staged as (k/4, th_e, 4)). The planes do not change between steps,
// so a compiler could keep them in registers and the probe would meter
// registers: a compiler memory barrier at each step forces every load of
// the step loop to be made again (chip_smoke.py counts the LDS in the
// SASS). Per loaded word the loop does one FMUL and one FADD (the Horner
// step), which tools/vpu_audit.py counts and prices at the FP32 rate as the
// side work of each k.
//
// Parallel form of the sequential grid: the columns are independent, and
// the steps are split into `shares` contiguous ranges so that several CTAs
// (each with its own copy of the column) keep every SM busy: one CTA per
// (column, share). A CTA runs its steps in order, folds each step's rows to
// 8 through shared memory and adds the folds in step order, as the TPU
// probe accumulates its output block; a second pass (rates.cuh) adds the
// shares in order. With one share that is the JAX probe's order exactly.
// The plain version (kernels/sol.py::vmem_rate_reference) repeats it, so
// the two are equal bit for bit (--fmad=false).

#include <cuda_runtime.h>

#include <cstdint>

#include "rates.cuh"

namespace {

constexpr int kMaxRows = 1024;     // th_e threads per CTA
constexpr float kStepScale = 9.5367431640625e-07f;   // 2^-20

__global__ void __launch_bounds__(kMaxRows) vmem_rate_kernel(const float* __restrict__ x,
                                                             float* __restrict__ partials,
                                                             int th_e, int chunk, int k,
                                                             int steps, int shares) {
  extern __shared__ float4 s_dyn[];
  float4* planes = s_dyn;                                  // (k / 4 rounded up, th_e)
  const int quads = (k + 3) / 4;
  float* s_e = reinterpret_cast<float*>(s_dyn + quads * th_e);   // (th_e,)
  const int row = threadIdx.x, col = blockIdx.x, share = blockIdx.y;

  for (int q = 0; q < quads; ++q) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      v[u] = j < k ? x[(static_cast<size_t>(j) * th_e + row) * chunk + col] : 0.0f;
    }
    planes[q * th_e + row] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int first = static_cast<int>(static_cast<int64_t>(share) * steps / shares);
  const int last = static_cast<int>(static_cast<int64_t>(share + 1) * steps / shares);
  float red = 0.0f;
#pragma unroll 1
  for (int step = first; step < last; ++step) {
    asm volatile("" ::: "memory");   // the planes are read anew at every step
    const float s = 1.0f - static_cast<float>(step) * kStepScale;
    float acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = static_cast<float>(u + 1);
#pragma unroll 1
    for (int q0 = 0; q0 < quads; q0 += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (q0 + h >= quads) break;
        const float4 v = planes[(q0 + h) * th_e + row];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * (q0 + h) + u < k) acc[4 * h + u] = acc[4 * h + u] * s + w[u];
      }
    }
    float a = acc[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) a = a + acc[u];
    s_e[row] = a;
    __syncthreads();
    if (row < 8) {   // the fold (sol.py:228-234), accumulated over the steps
      float f = s_e[row];
      for (int r = 8; r < th_e - 7; r += 8) f = f + s_e[r + row];
      if (th_e % 8) f = f + s_e[th_e - 8 + row];
      red = step == first ? f : red + f;
    }
    __syncthreads();
  }
  if (row < 8) partials[(static_cast<size_t>(share) * 8 + row) * chunk + col] = red;
}

}  // namespace

// Dynamic shared memory of one CTA: k planes of one column (k rounded up to
// a multiple of 4) and the step's row sums.
extern "C" int vmem_rate_smem_bytes(int th_e, int k) {
  return (((k + 3) / 4) * 4 * th_e + th_e) * static_cast<int>(sizeof(float));
}

// Launch on `stream`: x (k, th_e, chunk) f32, partials (shares, 8, chunk)
// f32 scratch, out (8, chunk) f32; the steps are split into `shares`
// contiguous ranges. Returns the launches' cudaError_t (0 = launched).
extern "C" int vmem_rate_launch(const void* x, void* partials, void* out, int th_e, int chunk,
                                int k, int steps, int shares, void* stream) {
  if (th_e < 8 || th_e > kMaxRows || chunk < 1 || chunk > 65535 || k < 1 || steps < 1 ||
      shares < 1 || shares > steps || shares > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = vmem_rate_smem_bytes(th_e, k);
  cudaError_t err = cudaFuncSetAttribute(vmem_rate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  vmem_rate_kernel<<<dim3(chunk, shares), th_e, smem, s>>>(
      static_cast<const float*>(x), static_cast<float*>(partials), th_e, chunk, k, steps, shares);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rates::sum_partials(static_cast<const float*>(partials), static_cast<float*>(out), shares,
                      8 * chunk, s);
  return static_cast<int>(cudaGetLastError());
}
