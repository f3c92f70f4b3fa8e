// vpu_rate.cu — the FP32 rate probe (B8a) for Hopper.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/sol.py::build_vpu_rate
// (pallas_call at :183): `steps` grid steps, each running `k` cycles of the
// op mix vpu_cycle (sol.py:106-130) on 8 independent f32 streams of one
// (th_e, chunk) plane, the seed perturbed by step * 2^-20, the 8 streams
// summed per element and the rows folded to 8 (_fold8, sol.py:156-162: rows
// 0..8*(th_e/8)-1 in blocks of 8, then, when th_e % 8 != 0, the last 8 rows
// once more, so rows 122-127 of a 130-row plane count twice). Timing two k
// and taking the slope gives the card's sustained rate for this mix
// (tools/vpu_audit.py), the rate the audit prices every kernel's op count at.
//
// What bounds it: FP32 instructions, by construction. Each thread keeps its
// element's 8 streams in registers through the k cycles (8 independent
// chains, as the TPU probe's ILP 8); nothing but the seed is read and one
// word per (step, row of 8, column) is written. The mix is 30 ops per
// element and cycle as the meter counts it; in SASS two of them are not
// instructions: |s - x| is an operand modifier, and x * c2 (streams 3 and 7)
// does not depend on the cycle and is computed once outside the loop.
// chip_smoke.py counts the FADD/FMUL/FMNMX of the cycle loop in the SASS.
// min/max are fminf/fmaxf (one FMNMX each): they differ from the meter's
// NaN-propagating minimum/maximum only on NaN, which finite seeds do not
// reach.
//
// Parallel form of the sequential grid: one CTA per (step, 32 columns), 8 x
// 32 threads; thread (r8, c) computes the rows r8, r8 + 8, ... of column c
// and adds those of the full blocks in row order (the fold's own order);
// the rows of the last 8 go through shared memory for the tail term. Each
// CTA writes its (8, 32) part of the step's partial, and a second pass
// (rates.cuh) adds the steps in order. Build with --fmad=false: every mul
// and add rounds on its own, as in the plain version (kernels/sol.py::
// vpu_rate_reference), which this kernel equals bit for bit.

#include <cuda_runtime.h>

#include "rates.cuh"

namespace {

constexpr int kCols = 32;              // columns per CTA
constexpr float kC1 = 1.0009765625f;   // vpu_cycle's constants (sol.py:117)
constexpr float kC2 = -0.4990234375f;
constexpr float kStepScale = 9.5367431640625e-07f;   // 2^-20

// One vpu_cycle (sol.py:119-129) on the 8 streams, in its op order.
__device__ __forceinline__ void cycle(float s[8], float x) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j % 4 == 0) {
      s[j] = s[j] * kC1 + x;
      s[j] = s[j] * kC2 + x;
    } else if (j % 4 == 1) {
      s[j] = fminf(s[j] * kC1, x) + s[j];
    } else if (j % 4 == 2) {
      s[j] = fmaxf(fabsf(s[j] - x) * kC2, x);
    } else {
      s[j] = (s[j] - x) * kC1 + x * kC2;
    }
  }
}

__global__ void __launch_bounds__(8 * kCols) vpu_rate_kernel(const float* __restrict__ x,
                                                            float* __restrict__ partials,
                                                            int th_e, int chunk, int k) {
  __shared__ float s_tail[8][kCols];
  const int r8 = threadIdx.y, col = blockIdx.x * kCols + threadIdx.x;
  const int step = blockIdx.y;
  const float step_f = static_cast<float>(step) * kStepScale;
  const int full = (th_e / 8) * 8, tail0 = th_e - 8;
  float red = 0.0f;
#pragma unroll 1
  for (int row = r8; row < th_e; row += 8) {
    const float xi = x[static_cast<size_t>(row) * chunk + col] + step_f;
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = xi * (0.125f * static_cast<float>(j + 1));
#pragma unroll 1
    for (int it = 0; it < k; ++it) cycle(s, xi);
    float acc = s[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) acc = acc + s[j];
    if (row < full) red = row == r8 ? acc : red + acc;
    if (row >= tail0) s_tail[row - tail0][threadIdx.x] = acc;
  }
  __syncthreads();
  if (th_e % 8) red = red + s_tail[r8][threadIdx.x];
  partials[(static_cast<size_t>(step) * 8 + r8) * chunk + col] = red;
}

}  // namespace

// Launch on `stream`: x (th_e, chunk) f32, partials (steps, 8, chunk) f32
// scratch, out (8, chunk) f32. Returns the launches' cudaError_t (0 =
// launched). chunk must be a multiple of 32, th_e at least 8.
extern "C" int vpu_rate_launch(const void* x, void* partials, void* out, int th_e, int chunk,
                               int k, int steps, void* stream) {
  if (th_e < 8 || chunk <= 0 || chunk % kCols || k < 0 || steps < 1 || steps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  vpu_rate_kernel<<<dim3(chunk / kCols, steps), dim3(kCols, 8), 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(partials), th_e, chunk, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rates::sum_partials(static_cast<const float*>(partials), static_cast<float*>(out), steps,
                      8 * chunk, s);
  return static_cast<int>(cudaGetLastError());
}
