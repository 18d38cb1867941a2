// Kernel 5's bf16-dequant variants for Hopper (sm_90a), in plain CUDA C++
// with a C interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py, kernels.fused_gram_variant): the fused banded SpMM + Gram of
// fused_gram_typed.cuh on its int8 slab TQ8Bf16, the counterparts of
// experiments/fused_probe.py's bf16deq, tg_bf16deq and nov_bf16 (the
// pallas_call at :170 and :191): int8 blocks Q, f32 scales s and the exact
// f32 diagonal d; x (n, m) and v (n, mv) bf16. For block row r:
//   W   = bf16(bf16(q) * bf16(s))        (the dequantized blocks)
//   y_r = W @ x_window (bf16 products, f32 sums) + d o x_centre (f32)
// bf16deq (variant kFullT): G = V^T bf16(Y) in f32 sums; tg_bf16deq
// (kTileT): the same function, the gram's pass spanning two ring tiles;
// nov_bf16 (kNoVT, v null): G's row 0 the f32 column sums of Y, the other
// rows zero. No path of the port calls them. What bounds them and the
// design are written in fused_gram_typed.cuh.

#include "fused_gram_typed.cuh"

extern "C" {

// The layout of a call, into out[6], as fdt_fused_gram_bf16_plan reports
// it (the scratch is n_groups * mv * m floats; nov_bf16 takes mv = m).
int fdt_fused_gram_q8bf16_plan(int nbr, int bs, int K, int m, int mv,
                               int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  return typed_gram<TQ8Bf16>(nullptr, nullptr, nullptr, 0, nullptr,
                             nullptr, nullptr, nbr, bs, K, 0, m, mv, 0, 0,
                             out, nullptr);
}

// q, scale_rows, diag, x, v (nullable), ldv, y (nullable, f32), partial
// (f32), g, nbr, bs, K, bw, m, mv, n_groups, variant, stream
int fdt_fused_gram_q8bf16(const int8_t* q, const float* scale,
                          const float* diag, const __nv_bfloat16* x,
                          const __nv_bfloat16* v, long long ldv, float* y,
                          float* partial, float* g, int nbr, int bs, int K,
                          int bw, int m, int mv, int n_groups, int variant,
                          void* stream) {
  return typed_gram<TQ8Bf16>(q, x, v, ldv, y, partial, g, nbr, bs, K, bw, m,
                             mv, n_groups, variant, nullptr, stream, scale,
                             diag);
}

}  // extern "C"
