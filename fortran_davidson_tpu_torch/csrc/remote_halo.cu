// The shard-local SpMM of the row-sharded solve's "pallas-remote" backend,
// for Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with
// ctypes by fortran_davidson_tpu_torch/ops/kernels.py). Storage and the
// shared tile are described in spmm_tile.cuh.
//
//   fdt_banded_remote_halo_spmm_*    replaces banded_remote_halo_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1416, body
//       _banded_remote_kernel :1260): kernel 6's DIA-banded SpMM over a
//       shard's rows, with the predecessor's last bw*bs rows (top) and
//       the successor's first bw*bs rows (bot) spliced into the edge
//       windows.
//
// The shard's rows x, top and bot come through three pointers (the tile's
// kSplit source), so no halo-extended copy x_ext is built. Block row r
// reads rows [(r - bw) * bs, (r + bw + 1) * bs) of the shard, rows below
// 0 from top and rows at nbr*bs or above from bot. The loads are unmasked:
// at the ring's two ends the wrapped halos meet the zero blocks of
// out-of-range slots, as in the TPU kernel. Values and summation order are
// kernel 6's, so on the same rows the two give the same bits.
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
// lie in the shard (the interior) loads through x alone (the tile's
// kInside source): the same loads as kernel 6's, without the choice of
// pointer per element that the edge rows need.
//
// Types as kernel 6: f64, f32, or bf16 storage summed in f32 (Y written in
// the accumulation type).
//
// What bounds it on the H100: kernel 6's bytes less the x_ext copy: the
// block table once, x once and the 2*bw*bs*m halo rows, Y written once;
// HBM at small m, f64/f32 FMA on the CUDA cores from m of about 64 in
// f64. The design is the shared tile's, not tuned (no tensor cores, no
// TMA), like the kernels it extends.

#include "spmm_tile.cuh"

namespace {

using fdt::DenseBlocks;
using Bf16 = __nv_bfloat16;

template <int kRows, typename T, typename Acc>
int launch(const T* blocks, const T* x, const T* top, const T* bot, Acc* y,
           int nbr, int bs, int K, int bw, int m, int a0, int na, int b0,
           int nb, void* stream) {
  return fdt::spmm_rows<DenseBlocks<T, Acc>, kRows>(
      DenseBlocks<T, Acc>{blocks}, {x, top, bot}, nullptr, nullptr, y,
      fdt::RowRange{a0, na, b0}, static_cast<long long>(na) + nb, bs, K, bw,
      static_cast<long long>(nbr) * bs, m, stream);
}

template <typename T, typename Acc>
int remote(const T* blocks, const T* x, const T* top, const T* bot, Acc* y,
           int nbr, int bs, int K, int bw, int m, int a0, int na, int b0,
           int nb, void* stream) {
  const bool inside = nb == 0 && a0 >= bw && a0 + na <= nbr - bw;
  return inside ? launch<fdt::kInside>(blocks, x, top, bot, y, nbr, bs, K, bw,
                                       m, a0, na, b0, nb, stream)
                : launch<fdt::kSplit>(blocks, x, top, bot, y, nbr, bs, K, bw,
                                      m, a0, na, b0, nb, stream);
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
