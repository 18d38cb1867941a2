// Kernel 5 with float64 x, the one fused banded SpMM + Gram kernel that
// stays on the shared SIMT tile, for Hopper (sm_90a), in plain CUDA C++
// with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py). Storage and the shared tile
// are described in spmm_tile.cuh.
//
//   fdt_banded_q_bsr_spmm_gram_f64 kernel 5 (banded_q_bsr_spmm_gram,
//       fortran_davidson_tpu/ops/pallas_kernels.py:886) with f64 x and v:
//       y = (Q o s) @ x_window + d o x_centre with q o s formed in f32, the
//       band product summed in f64 and rounded to f32, d o x added in f32,
//       Y in f64 (the plain version's arithmetic, that of kernel 4's
//       float64-x entry, q_spmm_f64.cu), then G = V^T Y summed in f64.
//
// Kernel 3 (banded_bsr_spmm_gram, pallas_kernels.py:592) in every type and
// kernel 5 with float32 x are the tensor-core kernels of fused_gram.cu
// (float32, int8) and fused_gram_typed.cuh (bf16, float64).
//
// v may be null: G = X^T A X, with the window's centre rows of x (the
// rows of Y's tile) as the gram operand, read through the same pointer
// right after the window load, so from L2. y may be null (write_out=False):
// Y is never stored, only G returns. G is (mv, m) and float32; it
// accumulates in f64.
//
// What bounds it on the H100. int8 apply with f64 x: 1 byte per stored
// entry and 2*m f64 flops on it; at m=20 that is ~40 flop/B, so the f64
// operations are the limit, not HBM. Gram: 2*mv*m flops per row of Y on
// top of the apply's 2*K*bs*m; at mv >= K*bs the gram's FMAs dominate.
//
// The design, simple and deterministic. Grid: n_groups x mv_tiles x
// col_tiles thread blocks (column tiles fastest). Thread block (g, vt, ct)
// walks the row units u = g, g + n_groups, ... (a unit is one TM-row tile
// of one block row) in that fixed order. For each unit it computes the
// (TM, TN) tile of Y with the shared tile product, stores it (vt == 0
// only), stages it in shared memory, and adds v[unit rows, mv tile]^T @
// Y_tile into its (mv_tile, TN) partial of G, held in dynamic shared
// memory for the whole walk. The partial is written once to a scratch
// buffer; a second kernel sums the n_groups partials in group order. No
// atomics: two runs give the same bits. The scratch that the wrapper
// allocates is n_groups * mv * m * 8 bytes, with n_groups = min(nbr,
// 2 * SMs). mv_tile is the most rows the shared memory left beside the
// static tiles holds, so mv_tiles is 1 up to that width; a wider v
// recomputes the apply once per mv tile.
//
// Not tuned: no tensor cores, a gram inner loop fed from shared memory
// with little register reuse, one resident block per SM at the widest mv.
// No solve reaches it (the fused engine is float32 only).

#include "reduce_partials.cuh"
#include "spmm_tile.cuh"

namespace {

using fdt::Int8F64Blocks;
using fdt::Tile;
using fdt::kThreadsM;

constexpr int kGramTA = 64;  // granule of the mv tile width

// Y rounded to the gram operand's type (the TPU kernel's ybuf dtype): a
// no-op for the f64 entry.
template <typename V, typename Acc>
__device__ __forceinline__ Acc round_to(Acc v) {
  return v;
}

template <typename Load, typename V, int TM, int TN>
__global__ void __launch_bounds__(Tile<TM, TN>::kThreads)
gram_kernel(Load ld, const typename Load::X* __restrict__ x,
            const float* __restrict__ diag, const V* __restrict__ v,
            long long ldv, typename Load::Acc* __restrict__ y,
            typename Load::Acc* __restrict__ partial, int nbr, int bs, int K,
            int bw, int m, int mv, int mv_tile, int n_groups, int col_tiles,
            int mv_tiles, int row_tiles) {
  using Acc = typename Load::Acc;
  using P = Tile<TM, TN>;
  // Columns of v staged per gram step: fewer for f64, so that the static
  // shared tiles stay under the 48 KB a block may declare statically.
  constexpr int TA = sizeof(Acc) == 8 ? 32 : 64;
  constexpr int RA = TA / kThreadsM;  // v columns per thread and step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* Gs = reinterpret_cast<Acc*>(smem_raw);  // (mv_tile, TN) partial of G
  __shared__ Acc Ys[TM][TN];
  __shared__ Acc Vs[TM][TA];

  const int ct = static_cast<int>(blockIdx.x % col_tiles);
  const int rest = static_cast<int>(blockIdx.x / col_tiles);
  const int vt = rest % mv_tiles;
  const int g = rest / mv_tiles;
  const int c0 = ct * TN;
  const int a_base = vt * mv_tile;
  const int mvw = min(mv_tile, mv - a_base);
  const int tid = threadIdx.x;
  const int tm = tid / P::kThreadsN;
  const int tn = tid % P::kThreadsN;
  const long long x_rows = static_cast<long long>(nbr) * bs;

  for (int e = tid; e < mvw * TN; e += P::kThreads) Gs[e] = Acc(0);

  const long long units = static_cast<long long>(nbr) * row_tiles;
  for (long long u = g; u < units; u += n_groups) {
    const long long r = u / row_tiles;
    const int i0 = static_cast<int>(u % row_tiles) * TM;
    Acc acc[P::RM][P::RN];
    fdt::tile_product<Load, TM, TN>(ld, x, diag, r, i0, c0, bs, K, bw,
                                    x_rows, m, acc);
    if (y != nullptr && vt == 0)
      fdt::store_tile<Acc, TM, TN>(y, acc, r, i0, c0, bs, m);
#pragma unroll
    for (int i = 0; i < P::RM; ++i) {
      const int li = tm + i * kThreadsM;
#pragma unroll
      for (int j = 0; j < P::RN; ++j) {
        const int lj = tn + j * P::kThreadsN;
        Ys[li][lj] = (i0 + li < bs && c0 + lj < m) ? round_to<V>(acc[i][j])
                                                   : Acc(0);
      }
    }
    const long long row0 = r * bs + i0;
    const int rows = min(TM, bs - i0);
    for (int a0 = 0; a0 < mvw; a0 += TA) {
      __syncthreads();  // Ys complete; the previous step's Vs reads done
      for (int e = tid; e < TM * TA; e += P::kThreads) {
        const int i = e / TA;
        const int a = e % TA;
        Vs[i][a] = (i < rows && a0 + a < mvw)
                       ? fdt::cvt<Acc>(v[(row0 + i) * ldv + a_base + a0 + a])
                       : Acc(0);
      }
      __syncthreads();
      Acc gacc[RA][P::RN];
#pragma unroll
      for (int ra = 0; ra < RA; ++ra) {
        const int la = a0 + tm + ra * kThreadsM;
#pragma unroll
        for (int j = 0; j < P::RN; ++j)
          gacc[ra][j] = la < mvw ? Gs[la * TN + tn + j * P::kThreadsN] : Acc(0);
      }
#pragma unroll 4
      for (int i = 0; i < TM; ++i) {
        Acc b[P::RN];
#pragma unroll
        for (int j = 0; j < P::RN; ++j) b[j] = Ys[i][tn + j * P::kThreadsN];
#pragma unroll
        for (int ra = 0; ra < RA; ++ra) {
          const Acc a = Vs[i][tm + ra * kThreadsM];
#pragma unroll
          for (int j = 0; j < P::RN; ++j) gacc[ra][j] += a * b[j];
        }
      }
#pragma unroll
      for (int ra = 0; ra < RA; ++ra) {
        const int la = a0 + tm + ra * kThreadsM;
#pragma unroll
        for (int j = 0; j < P::RN; ++j)
          if (la < mvw) Gs[la * TN + tn + j * P::kThreadsN] = gacc[ra][j];
      }
    }
  }
  __syncthreads();
  Acc* out = partial + static_cast<long long>(g) * mv * m;
  for (int e = tid; e < mvw * TN; e += P::kThreads) {
    const int a = e / TN;
    const int c = e % TN;
    if (c0 + c < m) out[static_cast<long long>(a_base + a) * m + c0 + c] = Gs[e];
  }
}

template <typename Load, typename V, int TM, int TN>
cudaError_t launch_gram(const Load& ld, const typename Load::X* x,
                        const float* diag, const V* v, long long ldv,
                        typename Load::Acc* y, typename Load::Acc* partial,
                        float* g, int nbr, int bs, int K, int bw, int m, int mv,
                        int n_groups, cudaStream_t stream) {
  using Acc = typename Load::Acc;
  auto kernel = gram_kernel<Load, V, TM, TN>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int dev = 0;
  int optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int row_bytes = TN * static_cast<int>(sizeof(Acc));
  const int cap =
      (optin - static_cast<int>(attr.sharedSizeBytes)) / row_bytes / kGramTA * kGramTA;
  if (cap < kGramTA) return cudaErrorInvalidConfiguration;
  const int mv_tile = min((mv + kGramTA - 1) / kGramTA * kGramTA, cap);
  const int mv_tiles = (mv + mv_tile - 1) / mv_tile;
  const int dyn = mv_tile * row_bytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  const int col_tiles = (m + TN - 1) / TN;
  const int row_tiles = (bs + TM - 1) / TM;
  const long long grid = static_cast<long long>(n_groups) * mv_tiles * col_tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), Tile<TM, TN>::kThreads, dyn, stream>>>(
      ld, x, diag, v, ldv, y, partial, nbr, bs, K, bw, m, mv, mv_tile,
      n_groups, col_tiles, mv_tiles, row_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long count = static_cast<long long>(mv) * m;
  const long long blocks = (count + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  reduce_partials<Acc><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      partial, g, n_groups, count);
  return cudaGetLastError();
}

template <typename Load, typename V, int TM>
cudaError_t gram_by_width(const Load& ld, const typename Load::X* x,
                          const float* diag, const V* v, long long ldv,
                          typename Load::Acc* y, typename Load::Acc* partial,
                          float* g, int nbr, int bs, int K, int bw, int m,
                          int mv, int n_groups, cudaStream_t s) {
  if (m <= 8)
    return launch_gram<Load, V, TM, 8>(ld, x, diag, v, ldv, y, partial, g, nbr,
                                       bs, K, bw, m, mv, n_groups, s);
  if (m <= 16)
    return launch_gram<Load, V, TM, 16>(ld, x, diag, v, ldv, y, partial, g, nbr,
                                        bs, K, bw, m, mv, n_groups, s);
  return launch_gram<Load, V, TM, 32>(ld, x, diag, v, ldv, y, partial, g, nbr,
                                      bs, K, bw, m, mv, n_groups, s);
}

// v == nullptr: the gram operand is x itself (ldv = m, mv = m).
template <typename Load, typename V>
int gram(const Load& ld, const typename Load::X* x, const float* diag,
         const V* v, long long ldv, typename Load::Acc* y,
         typename Load::Acc* partial, float* g, int nbr, int bs, int K, int bw,
         int m, int mv, int n_groups, void* stream) {
  if (nbr <= 0 || bs <= 0 || K <= 0 || m <= 0 || mv <= 0 || n_groups <= 0)
    return 0;
  if (v == nullptr) {
    v = reinterpret_cast<const V*>(x);
    ldv = m;
    mv = m;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bs <= 16 ? gram_by_width<Load, V, 16>(ld, x, diag, v, ldv, y, partial, g,
                                            nbr, bs, K, bw, m, mv, n_groups, s)
               : gram_by_width<Load, V, 64>(ld, x, diag, v, ldv, y, partial, g,
                                            nbr, bs, K, bw, m, mv, n_groups, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, scale_rows, diag, x, v (nullable), ldv, y (nullable), partial, g, nbr,
// bs, K, bw, m, mv, n_groups, stream: kernel 5 with float64 x and v on the
// SIMT tile (the tensor-core kernel 5 of fused_gram.cu is float32): the f64
// int8 apply (Int8F64Blocks in spmm_tile.cuh), then G = V^T Y summed in
// f64.
int fdt_banded_q_bsr_spmm_gram_f64(const int8_t* q, const float* scale,
                                   const float* diag, const double* x,
                                   const double* v, long long ldv, double* y,
                                   double* partial, float* g, int nbr, int bs,
                                   int K, int bw, int m, int mv, int n_groups,
                                   void* stream) {
  return gram(Int8F64Blocks{q, scale}, x, diag, v, ldv, y, partial, g, nbr,
              bs, K, bw, m, mv, n_groups, stream);
}

}  // extern "C"
