// The fixed-order sum of a fused SpMM + Gram kernel's partials, shared by
// fused_gram.cu and q_spmm.cu (through fused_apply.cuh) and
// fused_gram_typed.cuh: each cluster or thread-block group writes one
// (mv, m) partial of G, and this kernel
// adds them in group order, so the same inputs give the same bits.

#pragma once

#include <cuda_runtime.h>

namespace {

// G[e] = sum over groups q, in order, of partial[q][e], rounded to f32 once.
template <typename Acc>
__global__ void reduce_partials(const Acc* __restrict__ partial,
                                float* __restrict__ g, int n_groups,
                                long long count) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (e >= count) return;
  Acc s = Acc(0);
  for (int q = 0; q < n_groups; ++q) s += partial[q * count + e];
  g[e] = static_cast<float>(s);
}

}  // namespace
