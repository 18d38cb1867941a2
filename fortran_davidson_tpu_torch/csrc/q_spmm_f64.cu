// Kernels 4 and 7 with float64 x, the int8 DIA-banded SpMM and its form over
// a shard's halo-extended input, for Hopper (sm_90a), in plain CUDA C++ with
// a C interface (loaded with ctypes by fortran_davidson_tpu_torch/ops/
// kernels.py), on kernel 1's template (banded_spmm.cuh) with the int8 slab
// type QInt8. This unit holds kernel 4's entry and the layout query;
// kernel 7's is q_ext_spmm_f64.cu, so that the two build in parallel. Kernel
// 1's unit (banded_spmm.cu) instantiates neither, so no other kernel's code
// moves.
//
//   fdt_banded_q_bsr_spmm_f64      replaces banded_q_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:755, body :721) for
//       float64 x: y = (Q o s) @ x_window + d o x_centre. Q is the int8
//       off-diagonal part, s one f32 scale per (block row, slot) stored
//       over the slot's lanes (scale_rows), d the exact f32 diagonal.
//   fdt_banded_q_ext_bsr_spmm_f64  (q_ext_spmm_f64.cu) replaces
//       banded_q_ext_bsr_spmm (pallas_kernels.py:1059, body :997) for
//       float64 x: the same over x_ext, a shard's rows framed by bw*bs rows
//       of each ring neighbour (parallel/halo.py).
//   fdt_q_spmm_f64_plan            the layout of a launch
//       (kernels.q_spmm_f64_plan).
//
// Both compute what their plain versions compute (ops/kernels.py
// banded_q_bsr_spmm_plain, banded_q_ext_bsr_spmm_plain): q o s formed in
// f32 and widened to f64, the band product summed in f64, that sum rounded
// to f32, d o x_centre added in f32, Y returned in f64. The products are
// the plain version's bit for bit; only the order of the f64 sum differs,
// so the two part by at most one f32 ulp of a row's sum. The float32-x
// entries are q_spmm.cu's tensor-core kernel.
//
// What bounds them on the H100. At the main case (the 2M-row int8 matrix,
// bs 128, bw 1, m = 20) one apply does 2 * 16384 * 3 * 128^2 * 20 =
// 3.22e10 f64 flops: 0.48 ms at 67 TFLOP/s on DMMA. It moves 805 MB of
// int8 blocks, 25 MB of scales, 8 MB of diagonal, 336 MB of x and 336 MB
// of Y: 0.45 ms at 3.35 TB/s. Operations bound it, closely followed by
// bytes; so the products go to the f64 tensor cores, and the int8 entries
// are widened in registers, not stored wider.
//
// The design is kernel 1's (banded_spmm.cuh), at one block row a thread
// block and kernel 1's row tiles (16 rows for bs <= 16, else 128):
// - the int8 slab is streamed once through the cp.async ring, one 16-byte
//   copy a slab row a chunk where bs is a multiple of 16 (else byte by
//   byte), with the chunk's 16 lane scales beside its f64 x rows;
// - a lane loads its slab row of a chunk in one 16-byte load and builds
//   its 8 DMMA A values once: the byte as a float by integer and f32 adds
//   (the conversion instruction issues at a quarter of their rate), times
//   its lane's scale in f32, widened to f64; each A value feeds one DMMA
//   a column tile's n8 tile;
// - products on DMMA (mma.sync m8n8k4) in kernel 1's f64 fragments and
//   order, then the epilogue (finish in banded_spmm.cuh): the f64 sum
//   rounded to f32 plus d * x_centre in f32, d and x's centre rows read
//   from global memory (L2);
// - column tiles for the solves' widths (q8_column_tile): 8, 16, 24 or
//   40, the narrowest that covers m (the lowest-20 solve's m = 20 and 40
//   in 3 and 5 n8 tiles, none padded); above 40, 40 or 64, whichever pads
//   m less.
// Kernel 4's source is kernel 1's Masked: x rows outside [0, n) are
// zero-filled and never read. Kernel 7's is kernel 8's Inside, x pointed
// at the shard's first row x_ext + bw*bs*m: every window lies in x_ext, and
// at the ring's two ends the wrapped halo rows meet the zero blocks (q 0,
// scale 1) of out-of-range slots, which add +0. So a shard's rows put
// together are kernel 4's Y bit for bit, and one thread sums each element
// in a fixed order: the same bits on every call. A shape the kernel refuses
// returns its CUDA error and the wrapper raises; nothing takes its place.

#include "banded_spmm.cuh"

extern "C" {

// q, scale_rows, diag, x, y, nbr, bs, K, bw, m, stream
int fdt_banded_q_bsr_spmm_f64(const int8_t* q, const float* scale,
                              const float* diag, const double* x, double* y,
                              int nbr, int bs, int K, int bw, int m,
                              void* stream) {
  const fdt1::Quant<fdt1::Masked<double>> src{
      {}, scale, diag, fdt1::aligned16(scale)};
  return fdt1::launch_q8(q, x, src, y, nbr, bs, K, bw, m, stream);
}

// bs, m, out[4]: {row tile, column tile, ring depth, dynamic shared memory
// bytes} of a launch of either entry on the current device.
int fdt_q_spmm_f64_plan(int bs, int m, int* out) {
  const int tm = fdt1::small_rows(bs) ? 16 : 128;
  const int tn = fdt1::q8_column_tile(m);
  int stages = 0, smem = 0;
  const cudaError_t err = fdt1::plan_ring<fdt1::QInt8>(
      tm, tn, 1, fdt1::kFull, fdt1::kDirect, stages, smem);
  out[0] = tm;
  out[1] = tn;
  out[2] = stages;
  out[3] = smem;
  return static_cast<int>(err);
}

}  // extern "C"
