// The general block-sparse (block-ELL) SpMM kernel of the BSR operator,
// for Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with
// ctypes by fortran_davidson_tpu_torch/ops/kernels.py).
//
// Y = A @ X, where A is stored as (nbr, bs, K*bs) row-major block slabs:
// blocks[r, :, k*bs:(k+1)*bs] is the bs x bs block of block row r in slot k.
//
//   fdt_bsr_spmm_*         replaces bsr_spmm (pallas_kernels.py:101): the
//                          block row reads its own K column indices.
//
// (Kernel 1, the DIA-banded form, has its own unit: banded_spmm.cu.)
//
// Storage types: f64 and f32 accumulate in their own type; bf16 blocks and
// x (the JAX package's mixed-precision storage, ops/sparse.py:669-684)
// are widened to f32 when staged and accumulate in f32. Y is written in
// the accumulation type, so a bf16-storage apply returns f32 sums that
// were never rounded to bf16.
//
// What bounds it on the H100: every apply streams the whole block table
// once (at bs=128, K=3, f64 and 1M rows: 3.2 GB, ~1 ms at 3.35 TB/s) and
// does 2*m flops per stored entry, i.e. about 2*m/8 flop per block byte in
// f64 (2*m/2 in bf16). From m of about 64 on (about 16 in bf16), FMA on
// the CUDA cores is the limit, not HBM.
//
// The simple design is the tile of spmm_tile.cuh: one thread block per
// TM x TN output tile of one block row, the contraction staged through
// shared memory in kTK-wide chunks, Y written once. Any nbr, bs, K, m.
//
// Not tuned yet: no tensor cores (DMMA, or wgmma for bf16), no TMA, no
// double buffering and no persistent tiles. Those are later work.

#include "spmm_tile.cuh"

namespace {

using fdt::DenseBlocks;
using Bf16 = __nv_bfloat16;

template <typename T, typename Acc>
int general(const int* cols, const T* blocks, const T* x, Acc* y, int nbr,
            int bs, int K, long long x_rows, int m, void* stream) {
  return fdt::spmm(DenseBlocks<T, Acc>{blocks}, x, cols, nullptr, y, nbr, bs,
                   K, 0, x_rows, m, stream);
}

}  // namespace

extern "C" {

int fdt_bsr_spmm_f64(const int* cols, const double* blocks, const double* x,
                     double* y, int nbr, int bs, int K, long long x_rows, int m,
                     void* stream) {
  return general(cols, blocks, x, y, nbr, bs, K, x_rows, m, stream);
}

int fdt_bsr_spmm_f32(const int* cols, const float* blocks, const float* x,
                     float* y, int nbr, int bs, int K, long long x_rows, int m,
                     void* stream) {
  return general(cols, blocks, x, y, nbr, bs, K, x_rows, m, stream);
}

int fdt_bsr_spmm_bf16(const int* cols, const Bf16* blocks, const Bf16* x,
                      float* y, int nbr, int bs, int K, long long x_rows, int m,
                      void* stream) {
  return general(cols, blocks, x, y, nbr, bs, K, x_rows, m, stream);
}

}  // extern "C"
