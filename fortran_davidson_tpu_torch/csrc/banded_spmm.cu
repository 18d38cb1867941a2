// Kernel 1, the DIA-banded SpMM of the BSR operator, rebuilt for Hopper
// (sm_90a), in plain CUDA C++ with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py). The template is in
// banded_spmm.cuh; this translation unit holds kernel 1's three entries
// and its host-side layout query alone, so that no other kernel's code
// moves its code generation.
//
//   fdt_banded_bsr_spmm_{f64,f32,bf16}  replace banded_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:438): Y = A @ X, where
//       slot k of block row r holds block column r - bw + k, so a block row
//       contracts the contiguous x rows [(r - bw) * bs, (r + bw + 1) * bs).
//       x rows outside [0, n) load as zeros; 0 * Inf never enters a sum.
//
// Types: f64 summed in f64, f32 in f32, bf16 blocks and x summed in f32
// (as the TPU kernel does); Y is written in the sum's type.
//
// What bounds it on the H100. At the main case (1,048,576 rows, bs 128,
// bw 1, f64, m = 48) one apply moves 3.22 GB of blocks, 0.40 GB of x and
// Y: 1.202 ms at 3.35 TB/s. Its 3.9e10 flops take ~1.1 ms on the f64 CUDA
// cores (~34 TFLOP/s of FMA), so a SIMT kernel cannot hide them under the
// block stream; on the f64 tensor cores (DMMA, 67 TFLOP/s) they take 0.58
// ms, which a pipelined stream can overlap. Bytes bound it.
//
// What the design does about it (banded_spmm.cuh):
// - the slab is streamed once, through a ring of shared-memory stages
//   filled by cp.async (16-byte copies, zero-filled at the edges), the next
//   stages - 1 in flight while one is multiplied (4 stages, 3 where two
//   blocks an SM would not fit otherwise): at m = 6 (the lowest-3 width),
//   where the blocks are nearly all the bytes, a block of 256 threads
//   keeps ~60 KB of f64 slab in flight, two blocks an SM. cp.async's commit groups and a block barrier take the place of
//   mbarriers: each thread waits for its own copies, the barrier publishes
//   them;
// - products on tensor cores: f64 on DMMA (mma.sync m8n8k4), bf16 storage
//   on mma.sync m16n8k16 with f32 sums;
// - f32 on FFMA (CUDA cores), not 3xTF32: FFMA keeps the plain version's
//   float32 sums (3xTF32 drops the lo*lo term), and the port's f32 apply
//   runs at the solver's widths (m <= 48 at lowest-20), where FFMA's
//   2*m flops a 4-byte entry stay under the stream (the operations pass
//   the bytes at m of about 40). At bench.py's shape (m = 256) FFMA's
//   1.4e11 flops take ~2.6 ms at 67 TFLOP/s against ~1.0 ms of bytes:
//   3xTF32 is the step there, later work;
// - a block row of bs <= 128 is one row tile of 128 rows (8 warps), so the
//   x window is staged once per column tile; column tiles of 8 to 64 (48
//   at the main case, one tile) run next to each other, so a slab read more
//   than once comes from L2;
// - one thread sums each output element in a fixed order: two calls give
//   the same bits. A refused launch returns cudaGetLastError() and the
//   wrapper raises.

#include "banded_spmm.cuh"

namespace {

using fdt1::Bf16;
using fdt1::Math;

template <typename T>
int banded(const T* blocks, const T* x, typename Math<T>::Acc* y, int nbr,
           int bs, int K, int bw, int m, void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fdt1::launch_full(
      blocks, x, fdt1::Masked<T>{}, y, nbr, nbr, bs, K, bw, m,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// blocks, x, y, nbr, bs, K, bw, m, stream
int fdt_banded_bsr_spmm_f64(const double* blocks, const double* x, double* y,
                            int nbr, int bs, int K, int bw, int m, void* stream) {
  return banded(blocks, x, y, nbr, bs, K, bw, m, stream);
}

int fdt_banded_bsr_spmm_f32(const float* blocks, const float* x, float* y,
                            int nbr, int bs, int K, int bw, int m, void* stream) {
  return banded(blocks, x, y, nbr, bs, K, bw, m, stream);
}

int fdt_banded_bsr_spmm_bf16(const Bf16* blocks, const Bf16* x, float* y,
                             int nbr, int bs, int K, int bw, int m, void* stream) {
  return banded(blocks, x, y, nbr, bs, K, bw, m, stream);
}

// The layout of a launch of kernel 1 (kernel1 != 0) or of a variant, for
// kernels.banded_spmm_plan; dtype 0 f64, 1 f32, 2 bf16 storage.
// dtype, kernel1, bs, m, variant, rows_per_cta, store, stages, out[4]
int fdt_banded_spmm_plan(int dtype, int kernel1, int bs, int m, int var,
                         int rpc, int store, int stages, int* out) {
  switch (dtype) {
    case 0:
      return fdt1::plan_entry<double>(kernel1, bs, m, var, rpc, store, stages, out);
    case 1:
      return fdt1::plan_entry<float>(kernel1, bs, m, var, rpc, store, stages, out);
    case 2:
      return fdt1::plan_entry<Bf16>(kernel1, bs, m, var, rpc, store, stages, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
