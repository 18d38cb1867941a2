// Kernel 3's bf16 entry for Hopper (sm_90a), in plain CUDA C++ with a C
// interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py): the fused banded SpMM + Gram of fused_gram_typed.cuh on bf16
// blocks, x and v, mma.sync m16n8k16 with f32 sums for the apply and for
// the gram on bf16(Y). It replaces banded_bsr_spmm_gram
// (fortran_davidson_tpu/ops/pallas_kernels.py:592) for bf16 storage; what
// bounds it and its design are written in fused_gram_typed.cuh.

#include "fused_gram_typed.cuh"

extern "C" {

// The layout of a call, into out[6], as fdt_fused_gram_plan reports the
// float32 kernel's: row groups (the wrapper allocates n_groups * mv * m
// floats of scratch), TN, C, MB, dynamic shared memory a block, clusters
// resident.
int fdt_fused_gram_bf16_plan(int nbr, int bs, int K, int m, int mv,
                             int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  return typed_gram<TBf16>(nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                           nullptr, nbr, bs, K, 0, m, mv, 0, 0, out,
                           nullptr);
}

// blocks, x, v (nullable), ldv, y (nullable, f32), partial (f32), g, nbr,
// bs, K, bw, m, mv, n_groups, variant, stream
int fdt_fused_gram_bf16(const __nv_bfloat16* blocks, const __nv_bfloat16* x,
                        const __nv_bfloat16* v, long long ldv, float* y,
                        float* partial, float* g, int nbr, int bs, int K,
                        int bw, int m, int mv, int n_groups, int variant,
                        void* stream) {
  return typed_gram<TBf16>(blocks, x, v, ldv, y, partial, g, nbr, bs, K, bw,
                           m, mv, n_groups, variant, nullptr, stream);
}

}  // extern "C"
