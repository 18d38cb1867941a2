// The shard-local SpMM of the row-sharded solve's "pallas-remote" backend,
// for Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with
// ctypes by fortran_davidson_tpu_torch/ops/kernels.py), on kernel 1's
// template (banded_spmm.cuh).
//
//   fdt_banded_remote_halo_spmm_*    replaces banded_remote_halo_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1416, body
//       _banded_remote_kernel :1260): the DIA-banded SpMM over a shard's
//       rows, with the predecessor's last bw*bs rows (top) and the
//       successor's first bw*bs rows (bot) spliced into the edge windows.
//
// It is kernel 1 over other x rows: block row r reads rows
// [(r - bw) * bs, (r + bw + 1) * bs) of the shard, rows below 0 from top
// and rows at nbr*bs or above from bot, through three pointers (the
// template's Split source), so no halo-extended copy x_ext is built. The
// loads are unmasked: at the ring's two ends the wrapped halos meet the
// zero blocks of out-of-range slots, as in the TPU kernel. The products and
// the order of the sums are kernel 1's, so a shard's rows put together give
// kernel 1's bits on the whole matrix.
//
// The TPU kernel pushes its boundary rows to its ring neighbours with
// remote DMAs from inside the kernel, lets the interior tiles run while
// they travel, waits for arrival before the two edge tiles, and ends on a
// neighbour barrier. On Hopper the exchange is ring-neighbour
// point-to-point outside the kernel (torch.distributed isend/irecv, NCCL
// on the card), the usual GPU form of in-kernel remote copies between
// chips (collectives outside the kernel), and the overlap is a row split: one launch takes the
// interior block rows [bw, nbr - bw), which read no halo, while the
// exchange runs; a second launch takes the 2*bw edge block rows once the
// halos have arrived (the stream waits on the exchange, the host does
// not). A kernel that spin-waits on a flag written by another GPU's
// transfer would hold its SMs, and its ordering across kernels and
// streams is not something CUDA promises; the stream wait between two
// launches is. Each launch covers a RowRange: [a0, a0 + na) then
// [b0, b0 + nb), so the two edges are one grid. A range whose windows all
// lie in the shard (the interior) loads through x alone (the Inside
// source), without the choice of pointer per chunk that the edge rows need.
//
// Types as kernel 1: f64 on DMMA, f32 on FFMA, bf16 storage on mma.sync
// summed in f32 (Y written in the accumulation type).
//
// What bounds it on the H100: kernel 1's bytes plus the 2*bw*bs*m halo
// rows: the block table once, x and the halos once, Y written once; HBM at
// the solver's widths, as kernel 1 (banded_spmm.cu). Its design is kernel
// 1's: the slab streamed once through a cp.async ring, products on tensor
// cores (f64, bf16).

#include "banded_spmm.cuh"

namespace {

using fdt1::Bf16;
using fdt1::Math;
using fdt1::RowRange;

template <typename T>
int remote(const T* blocks, const T* x, const T* top, const T* bot,
           typename Math<T>::Acc* y, int nbr, int bs, int K, int bw, int m,
           int a0, int na, int b0, int nb, void* stream) {
  const long long count = static_cast<long long>(na) + nb;
  if (count <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowRange rows{a0, na, b0};
  const bool inside = nb == 0 && a0 >= bw && a0 + na <= nbr - bw;
  const cudaError_t err =
      inside ? fdt1::launch_full(blocks, x, fdt1::Inside<T>{rows}, y, nbr,
                                 count, bs, K, bw, m, s)
             : fdt1::launch_full(blocks, x,
                                 fdt1::Split<T>{rows, top, bot,
                                                static_cast<long long>(bw) * bs},
                                 y, nbr, count, bs, K, bw, m, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// blocks, x, top, bot, y, nbr, bs, K, bw, m, a0, na, b0, nb, stream
int fdt_banded_remote_halo_spmm_f64(const double* blocks, const double* x,
                                    const double* top, const double* bot,
                                    double* y, int nbr, int bs, int K, int bw,
                                    int m, int a0, int na, int b0, int nb,
                                    void* stream) {
  return remote(blocks, x, top, bot, y, nbr, bs, K, bw, m, a0, na, b0, nb,
                stream);
}

int fdt_banded_remote_halo_spmm_f32(const float* blocks, const float* x,
                                    const float* top, const float* bot,
                                    float* y, int nbr, int bs, int K, int bw,
                                    int m, int a0, int na, int b0, int nb,
                                    void* stream) {
  return remote(blocks, x, top, bot, y, nbr, bs, K, bw, m, a0, na, b0, nb,
                stream);
}

int fdt_banded_remote_halo_spmm_bf16(const Bf16* blocks, const Bf16* x,
                                     const Bf16* top, const Bf16* bot,
                                     float* y, int nbr, int bs, int K, int bw,
                                     int m, int a0, int na, int b0, int nb,
                                     void* stream) {
  return remote(blocks, x, top, bot, y, nbr, bs, K, bw, m, a0, na, b0, nb,
                stream);
}

}  // extern "C"
