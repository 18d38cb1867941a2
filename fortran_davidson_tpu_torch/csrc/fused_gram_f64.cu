// Kernel 3's float64 entry for Hopper (sm_90a), in plain CUDA C++ with a C
// interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py): the fused banded SpMM + Gram of fused_gram_typed.cuh on f64
// blocks, x and v, the apply and the gram on DMMA (mma.sync m8n8k4), G
// summed in f64 and rounded to f32 once. It replaces banded_bsr_spmm_gram
// (fortran_davidson_tpu/ops/pallas_kernels.py:592) for float64 storage;
// what bounds it and its design are written in fused_gram_typed.cuh.

#include "fused_gram_typed.cuh"

extern "C" {

// The layout of a call, into out[6], as fdt_fused_gram_bf16_plan reports
// it (the scratch is n_groups * mv * m doubles).
int fdt_fused_gram_f64_plan(int nbr, int bs, int K, int m, int mv,
                            int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  return typed_gram<TF64>(nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                          nullptr, nbr, bs, K, 0, m, mv, 0, 0, out,
                          nullptr);
}

// blocks, x, v (nullable), ldv, y (nullable), partial (f64), g, nbr, bs, K,
// bw, m, mv, n_groups, variant, stream
int fdt_fused_gram_f64(const double* blocks, const double* x, const double* v,
                       long long ldv, double* y, double* partial, float* g,
                       int nbr, int bs, int K, int bw, int m, int mv,
                       int n_groups, int variant, void* stream) {
  return typed_gram<TF64>(blocks, x, v, ldv, y, partial, g, nbr, bs, K, bw,
                          m, mv, n_groups, variant, nullptr, stream);
}

}  // extern "C"
