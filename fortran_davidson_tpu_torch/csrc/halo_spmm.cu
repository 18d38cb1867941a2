// Shard-local SpMM kernels of the row-sharded solve, for Hopper (sm_90a),
// in plain CUDA C++ with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py). Storage and the shared tile
// are described in spmm_tile.cuh.
//
//   fdt_banded_ext_bsr_spmm_*        replaces banded_ext_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1190, body :1130):
//       the DIA-banded SpMM of kernel 1 over a halo-extended input.
//   fdt_banded_q_ext_bsr_spmm_{f32,f64}  replaces banded_q_ext_bsr_spmm
//       (pallas_kernels.py:1059, body :997): the int8 form,
//       y = (Q o s) @ x_ext[window] + d o x_ext[centre], f32 or f64 x (the
//       f64 entry sums the band in f64 and rounds it to f32 as the plain
//       version does, banded_gram.cu).
//
// A shard owns nbr block rows of DIA storage (slot k of local block row r
// holds global block column r0 + r - bw + k). The caller (parallel/halo.py)
// frames the shard's (nbr*bs, m) rows with bw*bs rows of each ring
// neighbour, x_ext of (nbr + 2bw)*bs rows, so block row r contracts its K =
// 2bw+1 blocks with x_ext[r*bs, (r + K)*bs): every window is valid. The
// launch points x at the shard's first row, x_ext + bw*bs*m (still inside
// x_ext), and loads unmasked (the tile's kInside source): block row r reads
// x rows [(r - bw)*bs, (r + bw + 1)*bs), halo included. Kernel 1's masked
// load would zero x rows outside [0, nbr*bs) and wipe out the halo. At the
// ring's two ends the wrapped halo rows meet the zero blocks of
// out-of-range slots.
//
// Types as in kernels 1 and 4: f64, f32, or bf16 storage summed in f32 (Y
// written in the accumulation type); int8 storage with f32 scales and
// diagonal, and f32 or f64 x.
//
// What bounds them on the H100: the same as kernels 1 and 4 (banded_spmm.cu,
// banded_gram.cu) on nbr block rows, plus 2*bw*bs*m more x rows read: the
// block table in HBM at small m, f64/f32 FMA on the CUDA cores from m of
// about 64 in f64 (about 40 flop/B for int8 at m = 20). The design is that
// tile's, one thread block per output tile of one block row; not tuned
// (no tensor cores, no TMA), unlike kernel 1 since its redesign.

#include "spmm_tile.cuh"

namespace {

using fdt::DenseBlocks;
using fdt::Int8Blocks;
using fdt::Int8F64Blocks;
using Bf16 = __nv_bfloat16;

// The shard's first row in x_ext.
template <typename T>
const T* centre(const T* x_ext, int bs, int bw, int m) {
  return x_ext + static_cast<long long>(bw) * bs * m;
}

template <typename T, typename Acc>
int banded_ext(const T* blocks, const T* x_ext, Acc* y, int nbr, int bs, int K,
               int bw, int m, void* stream) {
  return fdt::spmm<DenseBlocks<T, Acc>, fdt::kInside>(
      DenseBlocks<T, Acc>{blocks}, centre(x_ext, bs, bw, m), nullptr, nullptr,
      y, nbr, bs, K, bw, static_cast<long long>(nbr) * bs, m, stream);
}

}  // namespace

extern "C" {

// blocks, x_ext, y, nbr, bs, K, bw, m, stream
int fdt_banded_ext_bsr_spmm_f64(const double* blocks, const double* x_ext,
                                double* y, int nbr, int bs, int K, int bw,
                                int m, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, stream);
}

int fdt_banded_ext_bsr_spmm_f32(const float* blocks, const float* x_ext,
                                float* y, int nbr, int bs, int K, int bw,
                                int m, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, stream);
}

int fdt_banded_ext_bsr_spmm_bf16(const Bf16* blocks, const Bf16* x_ext,
                                 float* y, int nbr, int bs, int K, int bw,
                                 int m, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, stream);
}

// q, scale_rows, diag, x_ext, y, nbr, bs, K, bw, m, stream
int fdt_banded_q_ext_bsr_spmm_f32(const int8_t* q, const float* scale,
                                  const float* diag, const float* x_ext,
                                  float* y, int nbr, int bs, int K, int bw,
                                  int m, void* stream) {
  return fdt::spmm<Int8Blocks, fdt::kInside>(
      Int8Blocks{q, scale}, centre(x_ext, bs, bw, m), nullptr, diag, y, nbr,
      bs, K, bw, static_cast<long long>(nbr) * bs, m, stream);
}

// The same with f64 x_ext (Int8F64Blocks in spmm_tile.cuh): Y in f64,
// holding the f32 values of the plain version.
int fdt_banded_q_ext_bsr_spmm_f64(const int8_t* q, const float* scale,
                                  const float* diag, const double* x_ext,
                                  double* y, int nbr, int bs, int K, int bw,
                                  int m, void* stream) {
  return fdt::spmm<Int8F64Blocks, fdt::kInside>(
      Int8F64Blocks{q, scale}, centre(x_ext, bs, bw, m), nullptr, diag, y,
      nbr, bs, K, bw, static_cast<long long>(nbr) * bs, m, stream);
}

}  // extern "C"
