// Block-sparse (block-ELL) SpMM kernels of the BSR operator, for Hopper
// (sm_90a), in plain CUDA C++ with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py).
//
// Y = A @ X, where A is stored as (nbr, bs, K*bs) row-major block slabs:
// blocks[r, :, k*bs:(k+1)*bs] is the bs x bs block of block row r in slot k.
//
//   fdt_banded_bsr_spmm_*  replaces banded_bsr_spmm
//                          (fortran_davidson_tpu/ops/pallas_kernels.py:438):
//                          DIA-aligned band, slot k of block row r holds
//                          block column r - bw + k, so a block row reads the
//                          contiguous x rows [(r - bw) * bs, (r + bw + 1) * bs).
//   fdt_bsr_spmm_*         replaces bsr_spmm (pallas_kernels.py:101): the
//                          block row reads its own K column indices.
//
// What bounds it on the H100: every apply streams the whole block table
// once (at bs=128, bw=1, f64 and 1M rows: 3.2 GB, ~1 ms at 3.35 TB/s) and
// does 2*m flops per stored entry, i.e. about 2*m/8 flop per block byte in
// f64. From m of about 64 on, f64 FMA on the CUDA cores (~34 TFLOP/s) is
// the limit, not HBM.
//
// The simple design: one thread block computes a TM x TN tile of one block
// row's (bs, m) output. It walks the contraction dimension K*bs in chunks
// of kTK, stages the matching (TM, kTK) slice of the slab and (kTK, TN)
// slice of the x window in shared memory, and accumulates a small register
// tile per thread with plain FMAs, in the output type; Y is written once.
// Column tiles are the fastest grid index, so the tiles of one block row
// run together and read its slab from L2 after the first. x rows outside
// [0, x_rows) load as zeros: a banded edge window multiplies zero blocks
// there, and 0 * Inf must not enter the sum. Any nbr, bs, bw and m work.
//
// Not tuned yet: no f64 tensor cores (DMMA), no wgmma/TMA, no double
// buffering and no persistent tiles. Those are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTK = 16;        // contraction chunk staged per step
constexpr int kThreadsM = 16;  // threads along the tile's rows

template <int TM, int TN>
struct Tile {
  static constexpr int kThreadsN = TN < 16 ? TN : 16;
  static constexpr int kThreads = kThreadsM * kThreadsN;
  static constexpr int RM = TM / kThreadsM;  // rows per thread
  static constexpr int RN = TN / kThreadsN;  // columns per thread
};

// cols == nullptr selects the banded rule (block column r - bw + k).
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(Tile<TM, TN>::kThreads)
spmm_kernel(const int* __restrict__ cols, const T* __restrict__ blocks,
            const T* __restrict__ x, T* __restrict__ y, int bs, int K, int bw,
            long long x_rows, int m, int col_tiles, int row_tiles) {
  using P = Tile<TM, TN>;
  __shared__ T As[kTK][TM + 1];  // slab chunk, transposed; +1 avoids bank conflicts
  __shared__ T Xs[kTK][TN];

  const long long bid = blockIdx.x;
  const int ct = static_cast<int>(bid % col_tiles);
  const long long rt = bid / col_tiles;
  const long long r = rt / row_tiles;                     // block row
  const int i0 = static_cast<int>(rt % row_tiles) * TM;   // first row of the tile
  const int c0 = ct * TN;
  const int L = K * bs;
  const int tid = threadIdx.x;
  const int tm = tid / P::kThreadsN;
  const int tn = tid % P::kThreadsN;

  const T* slab = blocks + r * bs * static_cast<long long>(L);
  const long long win0 = (r - bw) * bs;

  T acc[P::RM][P::RN];
#pragma unroll
  for (int i = 0; i < P::RM; ++i)
#pragma unroll
    for (int j = 0; j < P::RN; ++j) acc[i][j] = T(0);

  for (int l0 = 0; l0 < L; l0 += kTK) {
    for (int e = tid; e < TM * kTK; e += P::kThreads) {
      const int i = e / kTK;
      const int l = e % kTK;
      const int gi = i0 + i;
      const int gl = l0 + l;
      As[l][i] = (gi < bs && gl < L)
                     ? slab[static_cast<long long>(gi) * L + gl] : T(0);
    }
    for (int e = tid; e < kTK * TN; e += P::kThreads) {
      const int l = e / TN;
      const int c = e % TN;
      const int gl = l0 + l;
      const int gc = c0 + c;
      T v = T(0);
      if (gl < L && gc < m) {
        long long xr;
        if (cols != nullptr) {
          const int k = gl / bs;
          xr = static_cast<long long>(cols[r * K + k]) * bs + (gl - k * bs);
        } else {
          xr = win0 + gl;
        }
        if (xr >= 0 && xr < x_rows) v = x[xr * m + gc];
      }
      Xs[l][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kTK; ++l) {
      T a[P::RM];
      T b[P::RN];
#pragma unroll
      for (int i = 0; i < P::RM; ++i) a[i] = As[l][tm + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < P::RN; ++j) b[j] = Xs[l][tn + j * P::kThreadsN];
#pragma unroll
      for (int i = 0; i < P::RM; ++i)
#pragma unroll
        for (int j = 0; j < P::RN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  T* out = y + r * bs * static_cast<long long>(m);
#pragma unroll
  for (int i = 0; i < P::RM; ++i) {
    const int gi = i0 + tm + i * kThreadsM;
#pragma unroll
    for (int j = 0; j < P::RN; ++j) {
      const int gc = c0 + tn + j * P::kThreadsN;
      if (gi < bs && gc < m) out[static_cast<long long>(gi) * m + gc] = acc[i][j];
    }
  }
}

template <typename T, int TM, int TN>
cudaError_t launch(const int* cols, const T* blocks, const T* x, T* y,
                   int nbr, int bs, int K, int bw, long long x_rows, int m,
                   cudaStream_t stream) {
  const int col_tiles = (m + TN - 1) / TN;
  const int row_tiles = (bs + TM - 1) / TM;
  const long long grid = static_cast<long long>(nbr) * row_tiles * col_tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  spmm_kernel<T, TM, TN><<<static_cast<unsigned>(grid),
                           Tile<TM, TN>::kThreads, 0, stream>>>(
      cols, blocks, x, y, bs, K, bw, x_rows, m, col_tiles, row_tiles);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t by_width(const int* cols, const T* blocks, const T* x, T* y,
                     int nbr, int bs, int K, int bw, long long x_rows, int m,
                     cudaStream_t s) {
  if (m <= 8) return launch<T, TM, 8>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s);
  if (m <= 16) return launch<T, TM, 16>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s);
  if (m <= 32) return launch<T, TM, 32>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s);
  return launch<T, TM, 64>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s);
}

template <typename T>
int spmm(const int* cols, const T* blocks, const T* x, T* y, int nbr, int bs,
         int K, int bw, long long x_rows, int m, void* stream) {
  if (nbr <= 0 || bs <= 0 || K <= 0 || m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bs <= 16 ? by_width<T, 16>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s)
               : by_width<T, 64>(cols, blocks, x, y, nbr, bs, K, bw, x_rows, m, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int fdt_banded_bsr_spmm_f64(const double* blocks, const double* x, double* y,
                            int nbr, int bs, int K, int bw, int m, void* stream) {
  return spmm<double>(nullptr, blocks, x, y, nbr, bs, K, bw,
                      static_cast<long long>(nbr) * bs, m, stream);
}

int fdt_banded_bsr_spmm_f32(const float* blocks, const float* x, float* y,
                            int nbr, int bs, int K, int bw, int m, void* stream) {
  return spmm<float>(nullptr, blocks, x, y, nbr, bs, K, bw,
                     static_cast<long long>(nbr) * bs, m, stream);
}

int fdt_bsr_spmm_f64(const int* cols, const double* blocks, const double* x,
                     double* y, int nbr, int bs, int K, long long x_rows, int m,
                     void* stream) {
  return spmm<double>(cols, blocks, x, y, nbr, bs, K, 0, x_rows, m, stream);
}

int fdt_bsr_spmm_f32(const int* cols, const float* blocks, const float* x,
                     float* y, int nbr, int bs, int K, long long x_rows, int m,
                     void* stream) {
  return spmm<float>(cols, blocks, x, y, nbr, bs, K, 0, x_rows, m, stream);
}

}  // extern "C"
