// Kernel 2, the general block-sparse (block-ELL) SpMM of the BSR operator,
// for Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with
// ctypes by fortran_davidson_tpu_torch/ops/kernels.py), on kernel 1's
// template (banded_spmm.cuh).
//
//   fdt_bsr_spmm_{f64,f32,bf16}  replace bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:101, call :139): Y =
//       A @ X, where A is (nbr, bs, K*bs) row-major block slabs,
//       blocks[r, :, k*bs:(k+1)*bs] the block of block row r in block
//       column cols[r, k], for any K (from_block_coo pads every row to the
//       widest). x has x_rows rows, a multiple of bs; a block column outside
//       [0, x_rows / bs) reads zeros, and no x row that no column points at
//       is read.
//
// Types: f64 summed in f64, f32 in f32, bf16 blocks and x summed in f32
// (as the TPU kernel does); Y is written in the sum's type.
//
// What bounds it on the H100. At the main case (1,048,576 rows, bs 128,
// K 3, f64, m = 48) one apply moves 3.22 GB of blocks, 0.40 GB of x and
// 0.40 GB of Y: 1.202 ms at 3.35 TB/s, against 0.58 ms for its 3.9e10
// flops on DMMA (67 TFLOP/s). Bytes bound it, as they bound kernel 1.
// Where the table scatters the columns (a block-permuted matrix), a block
// row's K slices of x lie far apart: x (400 MB at m = 48) does not stay in
// the 50 MB L2, so each slice is read from HBM once for every slot that
// names it, K times in all (the count of the TPU kernel's own cost
// estimate, pallas_kernels.py:158-161): 4.82 GB, 1.44 ms.
//
// What the design does about it. It is kernel 1's, at one block row a
// thread block (RPC = 1) and kernel 1's tiles (TM 16 for bs <= 16, else
// 128; TN 8 to 64 by m):
// - the slab is streamed once, in slot order, through a ring of
//   shared-memory stages filled by cp.async, the next stages - 1 in
//   flight while one is multiplied;
// - window column j of the walk is slot j, its x rows staged from block
//   column cols[r, j] (the Table source): a KC-deep chunk lies in one
//   block column, so it reads one table entry and forms one pointer, and a
//   chunk of a scattered column costs no more copies than a banded one;
// - products on tensor cores, f64 on DMMA (mma.sync m8n8k4), bf16 on
//   mma.sync m16n8k16 with f32 sums; f32 on FFMA;
// - one thread sums each element, slot after slot: two calls give the same
//   bits, and on the DIA table (cols[r, k] = r - bw + k, out-of-range
//   columns included) every stage holds kernel 1's bytes, so Y is kernel
//   1's bit for bit.
// A shape the kernel refuses returns its CUDA error and the wrapper raises.

#include "banded_spmm.cuh"

namespace {

using fdt1::Bf16;
using fdt1::Math;

template <typename T>
int general(const int* cols, const T* blocks, const T* x,
            typename Math<T>::Acc* y, int nbr, int bs, int K,
            long long x_rows, int m, void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K < 0 || x_rows < 0 || x_rows % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fdt1::launch_full(
      blocks, x, fdt1::Table<T>{cols, K, x_rows}, y, nbr, nbr, bs, K, 0, m,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// cols, blocks, x, y, nbr, bs, K, x_rows, m, stream
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
