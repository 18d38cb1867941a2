// Kernel 5 with float64 x and v for Hopper (sm_90a), in plain CUDA C++ with
// a C interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py): the fused banded SpMM + Gram of fused_gram_typed.cuh on its
// int8 slab TQ8F64. It replaces banded_q_bsr_spmm_gram
// (fortran_davidson_tpu/ops/pallas_kernels.py:886) for float64 x: Y = (Q o
// s) @ x_window + d o x_centre with q o s formed in f32 and widened, the
// band summed in f64 on DMMA in kernel 4's order and rounded to f32, d o x
// added in f32, Y in f64 (kernel 4's float64-x Y, q_spmm_f64.cu, bit for
// bit); then G = V^T Y summed in f64, rounded to f32 once. What bounds it
// and its design are written in fused_gram_typed.cuh.

#include "fused_gram_typed.cuh"

extern "C" {

// The layout of a call, into out[6], as fdt_fused_gram_f64_plan reports
// it (the scratch is n_groups * mv * m doubles).
int fdt_fused_gram_q8f64_plan(int nbr, int bs, int K, int m, int mv,
                              int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  return typed_gram<TQ8F64>(nullptr, nullptr, nullptr, 0, nullptr, nullptr,
                            nullptr, nbr, bs, K, 0, m, mv, 0, 0, out,
                            nullptr);
}

// q, scale_rows, diag, x, v (nullable), ldv, y (nullable), partial (f64),
// g, nbr, bs, K, bw, m, mv, n_groups, variant, stream
int fdt_fused_gram_q8f64(const int8_t* q, const float* scale,
                         const float* diag, const double* x, const double* v,
                         long long ldv, double* y, double* partial, float* g,
                         int nbr, int bs, int K, int bw, int m, int mv,
                         int n_groups, int variant, void* stream) {
  return typed_gram<TQ8F64>(q, x, v, ldv, y, partial, g, nbr, bs, K, bw, m,
                            mv, n_groups, variant, nullptr, stream, scale,
                            diag);
}

}  // extern "C"
