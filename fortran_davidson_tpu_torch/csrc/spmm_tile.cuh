// The SIMT tile of the one fused SpMM + Gram kernel that has not been
// redesigned for Hopper (sm_90a): kernel 5's float64-x entry in
// banded_gram.cu (gram_kernel). Every other kernel is on kernel 1's
// template (banded_spmm.cuh: kernels 1, 2, 8, kernel 6's cp.async route
// and the float64-x entries of kernels 4 and 7), on the tensor-core apply
// of fused_apply.cuh (float32 kernels 3-5 and 7), on fused_gram_typed.cuh
// (kernel 3's bf16 and float64 entries), kernel 6 also on its TMA stream
// (ext_spmm.cu).
//
// A stored operator is (nbr, bs, K*bs) row-major block slabs: row i of
// block row r is the contiguous run slab(r)[i, 0:K*bs], and slot k of
// block row r holds block column r - bw + k, so the slab contracts the
// contiguous x window [(r - bw) * bs, (r + bw + 1) * bs).
//
// One thread block computes a TM x TN tile of one block row's (bs, m)
// output: it walks the contraction dimension K*bs in chunks of kTK,
// stages the (TM, kTK) slab slice and the (kTK, TN) x slice in shared
// memory, converted to the accumulation type, and accumulates a small
// register tile per thread with plain FMAs. The block loader is int8
// blocks times the (block row, slot) f32 scale, dequantized when staged,
// with f64 x (Int8F64Blocks); the kernel's epilogue adds the exactly
// stored diagonal d[r, i] * x[r*bs + i, c], stores Y, and feeds the gram
// G = V^T Y (banded_gram.cu).
//
// x rows outside [0, x_rows) load as zeros: a banded edge window
// multiplies zero blocks there, and 0 * Inf must not enter the sum
// (the counterpart of fortran_davidson_tpu/ops/pallas_kernels.py:233-244).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fdt {

constexpr int kTK = 16;        // contraction chunk staged per step
constexpr int kThreadsM = 16;  // threads along the tile's rows

template <int TM, int TN>
struct Tile {
  static constexpr int kThreadsN = TN < 16 ? TN : 16;
  static constexpr int kThreads = kThreadsM * kThreadsN;
  static constexpr int RM = TM / kThreadsM;  // rows per thread
  static constexpr int RN = TN / kThreadsN;  // columns per thread
};

// Element conversion into the accumulation type.
template <typename Acc, typename T>
__device__ __forceinline__ Acc cvt(T v) {
  return static_cast<Acc>(v);
}

// int8 off-diagonal blocks times one f32 scale per (block row, slot),
// stored broadcast over the slot's lanes as scale[r, l], with float64 x
// (kernel 5 on a float64 solve), as the plain version computes it
// (ops/kernels.py banded_q_bsr_spmm_plain):
// q * s formed in f32 and widened, the band product summed in f64, and the
// diagonal epilogue (add_diag) rounding that sum to f32 and adding d * x
// in f32; Y holds those f32 values widened to f64.
struct Int8F64Blocks {
  using X = double;
  using Acc = double;
  const int8_t* q;
  const float* scale;
  __device__ __forceinline__ double at(long long r, int i, int bs, int L,
                                       int l) const {
    return static_cast<double>(
        static_cast<float>(q[(r * bs + i) * static_cast<long long>(L) + l]) *
        scale[r * L + l]);
  }
};

// The diagonal epilogue acc + d * x, in Acc.
template <typename Load>
__device__ __forceinline__ typename Load::Acc add_diag(
    typename Load::Acc acc, float d, typename Load::X x) {
  using Acc = typename Load::Acc;
  return acc + static_cast<Acc>(d) * cvt<Acc>(x);
}
template <>
__device__ __forceinline__ double add_diag<Int8F64Blocks>(double acc, float d,
                                                          double x) {
  return static_cast<double>(
      __fadd_rn(static_cast<float>(acc), __fmul_rn(d, static_cast<float>(x))));
}

// acc = slab(r)[i0:i0+TM, :] @ x_window(r)[:, c0:c0+TN] (+ d * x_centre
// when diag is given).
template <typename Load, int TM, int TN>
__device__ __forceinline__ void tile_product(
    const Load& ld, const typename Load::X* __restrict__ x,
    const float* __restrict__ diag,
    long long r, int i0, int c0, int bs, int K, int bw, long long x_rows,
    int m, typename Load::Acc (&acc)[Tile<TM, TN>::RM][Tile<TM, TN>::RN]) {
  using Acc = typename Load::Acc;
  using P = Tile<TM, TN>;
  __shared__ Acc As[kTK][TM + 1];  // slab chunk, transposed; +1 avoids bank conflicts
  __shared__ Acc Xs[kTK][TN];

  const int L = K * bs;
  const int tid = threadIdx.x;
  const int tm = tid / P::kThreadsN;
  const int tn = tid % P::kThreadsN;
  const long long win0 = (r - bw) * bs;
  const long long ctr0 = r * bs;

#pragma unroll
  for (int i = 0; i < P::RM; ++i)
#pragma unroll
    for (int j = 0; j < P::RN; ++j) acc[i][j] = Acc(0);

  for (int l0 = 0; l0 < L; l0 += kTK) {
    for (int e = tid; e < TM * kTK; e += P::kThreads) {
      const int i = e / kTK;
      const int l = e % kTK;
      const int gi = i0 + i;
      const int gl = l0 + l;
      As[l][i] = (gi < bs && gl < L) ? ld.at(r, gi, bs, L, gl) : Acc(0);
    }
    for (int e = tid; e < kTK * TN; e += P::kThreads) {
      const int l = e / TN;
      const int c = e % TN;
      const int gl = l0 + l;
      const int gc = c0 + c;
      Acc v = Acc(0);
      if (gl < L && gc < m) {
        const long long xr = win0 + gl;
        if (xr >= 0 && xr < x_rows) {
          v = cvt<Acc>(x[xr * m + gc]);
        }
      }
      Xs[l][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int l = 0; l < kTK; ++l) {
      Acc a[P::RM];
      Acc b[P::RN];
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

  if (diag != nullptr) {
#pragma unroll
    for (int i = 0; i < P::RM; ++i) {
      const int gi = i0 + tm + i * kThreadsM;
#pragma unroll
      for (int j = 0; j < P::RN; ++j) {
        const int gc = c0 + tn + j * P::kThreadsN;
        if (gi < bs && gc < m) {
          acc[i][j] = add_diag<Load>(acc[i][j], diag[r * bs + gi],
                                     x[(ctr0 + gi) * m + gc]);
        }
      }
    }
  }
}

template <typename Acc, int TM, int TN>
__device__ __forceinline__ void store_tile(
    Acc* __restrict__ y, const Acc (&acc)[Tile<TM, TN>::RM][Tile<TM, TN>::RN],
    long long r, int i0, int c0, int bs, int m) {
  using P = Tile<TM, TN>;
  const int tm = threadIdx.x / P::kThreadsN;
  const int tn = threadIdx.x % P::kThreadsN;
  Acc* out = y + r * bs * static_cast<long long>(m);
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

}  // namespace fdt
