// Kernel 7's float64-x entry, the int8 SpMM of the row-sharded solve over a
// halo-extended input, for Hopper (sm_90a), in plain CUDA C++ with a C
// interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/kernels.py),
// on the shared tile (spmm_tile.cuh).
//
//   fdt_banded_q_ext_bsr_spmm_f64  replaces banded_q_ext_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1059, body :997) for
//       float64 x: y = (Q o s) @ x_ext[window] + d o x_ext[centre], the
//       band summed in f64 and rounded to f32 as the plain version does
//       (Int8F64Blocks), Y in f64 holding those f32 values.
//
// Kernel 7's float32-x entry is kernel 4's tensor-core apply (q_spmm.cu);
// kernel 6, the dense form, is on kernel 1's design (ext_spmm.cu). The
// float64-x entries of kernels 4 and 5 stay on the tile as well
// (banded_gram.cu).
//
// A shard owns nbr block rows of DIA storage (slot k of local block row r
// holds global block column r0 + r - bw + k). The caller (parallel/halo.py)
// frames the shard's (nbr*bs, m) rows with bw*bs rows of each ring
// neighbour, x_ext of (nbr + 2bw)*bs rows, so block row r contracts its K =
// 2bw+1 blocks with x_ext[r*bs, (r + K)*bs): every window is valid. The
// launch points x at the shard's first row, x_ext + bw*bs*m (still inside
// x_ext), and loads unmasked (the tile's kInside source): block row r reads
// x rows [(r - bw)*bs, (r + bw + 1)*bs), halo included. At the ring's two
// ends the wrapped halo rows meet the zero blocks of out-of-range slots.
//
// What bounds it on the H100: kernel 4's float64-x entry's (banded_gram.cu)
// on nbr block rows, plus 2*bw*bs*m more x rows read. Not tuned: the tile,
// one thread block per output tile of one block row, FMAs on the CUDA cores.

#include "spmm_tile.cuh"

extern "C" {

// q, scale_rows, diag, x_ext, y, nbr, bs, K, bw, m, stream
int fdt_banded_q_ext_bsr_spmm_f64(const int8_t* q, const float* scale,
                                  const float* diag, const double* x_ext,
                                  double* y, int nbr, int bs, int K, int bw,
                                  int m, void* stream) {
  return fdt::spmm<fdt::Int8F64Blocks, fdt::kInside>(
      fdt::Int8F64Blocks{q, scale},
      x_ext + static_cast<long long>(bw) * bs * m, nullptr, diag, y, nbr, bs,
      K, bw, static_cast<long long>(nbr) * bs, m, stream);
}

}  // extern "C"
