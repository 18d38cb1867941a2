// The shard-local SpMM of the row-sharded solve's "pallas-remote" backend,
// for Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with
// ctypes by fortran_davidson_tpu_torch/ops/kernels.py), on kernel 1's
// template (banded_spmm.cuh).
//
//   fdt_banded_remote_push_spmm_*, fdt_banded_remote_halo_spmm_*
//       replace banded_remote_halo_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1416, body
//       _banded_remote_kernel :1260, its push :1290-1301 and :1358-1362,
//       its waits :1370-1378, its barrier :1398-1413): the DIA-banded SpMM
//       over a shard's rows, with the predecessor's last bw*bs rows (top)
//       and the successor's first bw*bs rows (bot) spliced into the edge
//       windows.
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
// neighbour barrier. Two forms here, on one template:
//
//   fdt_banded_remote_push_spmm_*    that kernel's form, in one launch
//       (HaloBSROperator's "push" route: every ring neighbour's GPU on
//       this host and peer-accessible). Each rank exposes a window
//       (peer_window.cu; layout in remote_push.cuh): two halo slots, top
//       and bot, double-buffered by epoch parity, and epoch flags. The
//       grid's first CTAs, the pushers, copy the shard's first and last
//       bw*bs rows of x (each a contiguous run of x) into the neighbours'
//       slots of parity epoch % 2 through the peer pointers, each its
//       share (16-byte stores over NVLink, the rank's own memory at world
//       size 1), fence at system scope, and the last of them stores
//       arrived = epoch into both neighbours' windows with a release at
//       system scope. Before writing, a pusher waits (ld.acquire.sys)
//       until the neighbour has read that buffer's previous rows:
//       consumed >= epoch - 2, stored by the neighbour's last reader of
//       the slot once its rows are in shared memory. This replaces the
//       TPU kernel's tail barrier: no CTA waits at the end. (While a
//       rank's launches run one after another on one stream, the arrival
//       waits already order a buffer's reuse; the consumed wait keeps the
//       rule local to the buffer, and holds where a rank's pushes run
//       ahead of its reads, the schedule that tests/test_torch_halo.py
//       model-checks.) Only the edge CTAs, those of the first and last bw
//       block rows (the grid's first rows), wait for arrival (one thread
//       spins on its own arrived flag, then a barrier), and they read the
//       slots by cp.async, the generic proxy, so the acquire orders them
//       (no proxy fence; TMA reads would need one, as kernel 6's did). The
//       interior CTAs read x alone and never wait.
//
//       It always makes progress, at any width and bandwidth. The pushers
//       are the edge CTAs up to one an SM, the grid's first CTAs, so the
//       card holds all of them at once, and CTAs are dispatched in grid
//       order: they are resident before any other CTA is. Each pushes
//       before it waits, and waits before that only for consumed flags of
//       earlier epochs. So every arrival a spinner waits for is made: on
//       this card (at world size 1 the pushes into a spinner's slot come
//       from the pushers of the same launch) and on the neighbours', whose
//       pushers likewise push first. The other edge CTAs, however many the
//       width and bandwidth make, may spin on every SM: they wait only for
//       pushers that are resident already. Interior CTAs finish without
//       waiting. Every spin is bounded by %globaltimer: past the bound
//       (the wrapper's, 10 s) the CTA writes rank, epoch, slot and what it
//       waited for into a fault record in host memory and traps, so a rank
//       that applies the operator fewer times than its neighbours fails
//       with that record instead of hanging. The epoch is the operator's
//       host counter, the same on every rank, which apply in lockstep.
//
//   fdt_banded_remote_halo_spmm_*    the "exchange" route (meshes that span
//       hosts, where NVLink does not reach): the halos come by
//       ring-neighbour point-to-point outside the kernel (torch.distributed
//       isend/irecv, NCCL), and the overlap is a row split: one launch
//       takes the interior block rows [bw, nbr - bw), which read no halo,
//       while the exchange runs; a second takes the 2*bw edge block rows
//       once the halos have arrived (the stream waits on the exchange, the
//       host does not). Each launch covers a RowRange: [a0, a0 + na) then
//       [b0, b0 + nb), so the two edges are one grid. A range whose
//       windows all lie in the shard (the interior) loads through x alone
//       (the Inside source), without the choice of pointer per chunk that
//       the edge rows need.
//
// Types as kernel 1: f64 on DMMA, f32 on FFMA, bf16 storage on mma.sync
// summed in f32 (Y written in the accumulation type).
//
// What bounds it on the H100: kernel 1's bytes plus the 2*bw*bs*m halo
// rows: the block table once, x and the halos once, Y written once (the
// push form also writes the halo rows once, into the neighbours'
// windows); HBM at the solver's widths, as kernel 1 (banded_spmm.cu). Its
// design is kernel 1's: the slab streamed once through a cp.async ring,
// products on tensor cores (f64, bf16).

#include "banded_spmm.cuh"
#include "remote_push.cuh"

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

// One launch of the push form over all nbr block rows; the window's
// buffers of this epoch's parity are the Push source's top and bot. The
// epoch fixes the rest (kernels.push_plan): its parity, and the consumed
// epoch its pushes wait for.
template <typename T>
int push(const T* blocks, const T* x, typename Math<T>::Acc* y, int nbr,
         int bs, int K, int bw, int m, void* own, void* left, void* right,
         void* fault, long long slot_bytes, long long epoch, int rank,
         long long timeout_ns, void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1 || bw < 1 || bw > nbr || epoch < 1 ||
      slot_bytes < static_cast<long long>(bw) * bs * m *
                       static_cast<long long>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The pushers: the grid's first CTAs, the edge CTAs (first in the grid)
  // up to one an SM, so that all of them are resident at once.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tm = fdt1::small_rows(bs) ? 16 : 128;  // launch_full's tiles
  const int tn = fdt1::column_tile(m);
  const long long edge = static_cast<long long>(nbr < 2 * bw ? nbr : 2 * bw) *
                         ((bs + tm - 1) / tm) * ((m + tn - 1) / tn);
  const int pushers = static_cast<int>(edge < sms ? edge : sms);
  auto* w = static_cast<unsigned char*>(own);
  const int parity = static_cast<int>(epoch % 2);
  const fdt1::PushRing ring{w,
                            static_cast<unsigned char*>(left),
                            static_cast<unsigned char*>(right),
                            static_cast<long long*>(fault),
                            slot_bytes,
                            epoch,
                            epoch - 2,
                            timeout_ns,
                            parity,
                            rank,
                            pushers};
  const fdt1::Push<T> src{
      fdt1::slot_rows<T>(w, fdt1::kTop, parity, slot_bytes),
      fdt1::slot_rows<T>(w, fdt1::kBot, parity, slot_bytes),
      static_cast<long long>(bw) * bs, nbr, bw, ring};
  return static_cast<int>(fdt1::launch_full(
      blocks, x, src, y, nbr, nbr, bs, K, bw, m,
      static_cast<cudaStream_t>(stream)));
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

// blocks, x, y, nbr, bs, K, bw, m, own, left, right, fault, slot_bytes,
// epoch, rank, timeout_ns, stream
int fdt_banded_remote_push_spmm_f64(
    const double* blocks, const double* x, double* y, int nbr, int bs, int K,
    int bw, int m, void* own, void* left, void* right, void* fault,
    long long slot_bytes, long long epoch, int rank, long long timeout_ns,
    void* stream) {
  return push(blocks, x, y, nbr, bs, K, bw, m, own, left, right, fault,
              slot_bytes, epoch, rank, timeout_ns, stream);
}

int fdt_banded_remote_push_spmm_f32(
    const float* blocks, const float* x, float* y, int nbr, int bs, int K,
    int bw, int m, void* own, void* left, void* right, void* fault,
    long long slot_bytes, long long epoch, int rank, long long timeout_ns,
    void* stream) {
  return push(blocks, x, y, nbr, bs, K, bw, m, own, left, right, fault,
              slot_bytes, epoch, rank, timeout_ns, stream);
}

int fdt_banded_remote_push_spmm_bf16(
    const Bf16* blocks, const Bf16* x, float* y, int nbr, int bs, int K,
    int bw, int m, void* own, void* left, void* right, void* fault,
    long long slot_bytes, long long epoch, int rank, long long timeout_ns,
    void* stream) {
  return push(blocks, x, y, nbr, bs, K, bw, m, own, left, right, fault,
              slot_bytes, epoch, rank, timeout_ns, stream);
}

}  // extern "C"
