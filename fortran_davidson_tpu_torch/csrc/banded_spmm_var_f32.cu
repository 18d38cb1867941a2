// Measurement variants of kernel 1 (banded_spmm.cuh) with f32 storage:
// the copy variant (kernel 9) only. One unit a type, so that the variants build in parallel
// beside kernel 1's own unit (banded_spmm.cu), whose code they do not
// touch. Launched by kernels.banded_spmm_variant; no path of the port
// calls them.

#include "banded_spmm.cuh"

extern "C" {

// blocks, x, y, colsum, nbr, bs, K, bw, m, variant, rows_per_cta, stages,
// store, evict_first, stream
int fdt_banded_spmm_variant_f32(const float* blocks, const float* x, float* y,
                                float* colsum, int nbr, int bs, int K, int bw,
                                int m, int variant, int rpc, int stages,
                                int store, int evict, void* stream) {
  return fdt1::variant(blocks, x, y, colsum, nbr, bs, K, bw, m, variant, rpc,
                       stages, store, evict, stream);
}

}  // extern "C"
