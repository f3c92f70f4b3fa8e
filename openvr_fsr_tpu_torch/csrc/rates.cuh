// rates.cuh — what the three rate probes (vpu_rate.cu, vmem_rate.cu,
// mxu_rate.cu) share: the second pass that sums their partials.
//
// The TPU probes accumulate into one revisited output block over a
// sequential grid. Blocks on Hopper run in parallel and in no order, so each
// step (or share of the steps) writes its own (8, cols) partial and this
// pass adds them in index order, partial 0 first: out = ((p0 + p1) + p2) +
// ... The plain versions
// (kernels/sol.py) add in the same order, so the sums agree bit for bit.
#pragma once

namespace rates {

// out[i] = sum over p of partials[p * n + i], p = 0, 1, ..., parts - 1 in
// order; one thread per output element.
__global__ void sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                    int parts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = partials[i];
  for (int p = 1; p < parts; ++p) s = s + partials[static_cast<size_t>(p) * n + i];
  out[i] = s;
}

inline void sum_partials(const float* partials, float* out, int parts, int n,
                         cudaStream_t stream) {
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partials, out, parts, n);
}

}  // namespace rates
