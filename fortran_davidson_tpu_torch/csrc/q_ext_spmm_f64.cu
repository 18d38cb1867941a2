// Kernel 7 with float64 x, the int8 DIA-banded SpMM over a shard's
// halo-extended input, for Hopper (sm_90a), in plain CUDA C++ with a C
// interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py): kernel 4's float64-x kernel (q_spmm_f64.cu, where its design
// and what bounds it are written) with kernel 8's unmasked source.
//
//   fdt_banded_q_ext_bsr_spmm_f64  replaces banded_q_ext_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1059, body :997) for
//       float64 x: y = (Q o s) @ x_ext[window] + d o x_ext[centre], the
//       band summed in f64 and rounded to f32, d o x added in f32, Y in
//       f64 (the plain version's arithmetic).
//
// A shard owns nbr block rows of DIA storage; the caller (parallel/halo.py)
// frames its (nbr*bs, m) rows with bw*bs rows of each ring neighbour, x_ext
// of (nbr + 2bw)*bs rows. x is pointed at the shard's first row, x_ext +
// bw*bs*m, and read unmasked (Inside): block row r reads x_ext's rows
// [r*bs, (r + K)*bs), halo included. At the ring's two ends the wrapped
// halo rows meet the zero blocks (q 0, scale 1) of out-of-range slots,
// which add +0, so the shards' rows put together are kernel 4's Y bit for
// bit.

#include "banded_spmm.cuh"

extern "C" {

// q, scale_rows, diag, x_ext, y, nbr, bs, K, bw, m, stream
int fdt_banded_q_ext_bsr_spmm_f64(const int8_t* q, const float* scale,
                                  const float* diag, const double* x_ext,
                                  double* y, int nbr, int bs, int K, int bw,
                                  int m, void* stream) {
  const fdt1::Quant<fdt1::Inside<double>> src{
      {fdt1::RowRange{0, nbr, 0}}, scale, diag, fdt1::aligned16(scale)};
  return fdt1::launch_q8(q, x_ext + static_cast<long long>(bw) * bs * m, src,
                         y, nbr, bs, K, bw, m, stream);
}

}  // extern "C"
