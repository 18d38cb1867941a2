// Kernel 4's float32 entry, the int8 DIA-banded SpMM, and kernel 7's, the
// same over a shard's halo-extended input, on tensor cores for Hopper
// (sm_90a), in plain CUDA C++ with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py).
//
//   fdt_banded_q_bsr_spmm_f32   replaces banded_q_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:755, body :721):
//       y = (Q o s) @ x_window + d o x_centre. Q is the int8 off-diagonal
//       part, s one f32 scale per (block row, slot), d the exact f32
//       diagonal; x and y are f32. (The float64-x entry is q_spmm_f64.cu's,
//       on kernel 1's template with products on DMMA.)
//   fdt_banded_q_ext_bsr_spmm_f32  replaces banded_q_ext_bsr_spmm
//       (pallas_kernels.py:1059, body :997): the same over x_ext, the
//       shard's rows framed by bw*bs rows of each ring neighbour
//       (parallel/halo.py), f32 x. (The float64-x entry is
//       q_ext_spmm_f64.cu's, kernel 4's float64-x kernel over x_ext.)
//   fdt_q_spmm_plan             the layout of a launch (kernels.q_spmm_plan).
//
// What bounds it on the H100. One byte a stored entry and 2*m flops on it.
// At the main case (the 2M-row int8 matrix, bs 128, bw 1, m = 20) one
// apply moves 805 MB of blocks and 336 MB of x and Y: 0.35 ms at 3.35
// TB/s. Its 3.2e10 flops, as two TF32 products each (x hi and lo), are
// 1.3e11 TF32 flops: 0.26 ms at 495 TFLOP/s (data-sheet rates). As f32
// FMAs on the CUDA cores (the SIMT tile that this kernel replaced) the
// apply took 4.010 ms on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
// chip_smoke.py). Bytes bound it, the tensor-core products close behind.
//
// The design is kernel 5's int8 apply (fused_apply.cuh: the Int8 loader,
// the staging, the slot loop), with no V, no gram and no cluster:
// - n_groups blocks a column tile, as many as the card holds at once (two
//   an SM: 256 threads and four ring stages of 20 KB at TN = 24); block g
//   walks one contiguous range of block rows, and for each computes all
//   its bs rows at its column tile, in one pass where bs <= 128;
// - per block row, the slab chunks and the x window chunks stream through
//   the cp.async ring once; Q is exact in TF32, x is split into hi and lo
//   (two TF32 products on mma.sync m16n8k8), the slot's f32 scale
//   multiplies the slot's partial, d o x is added on the CUDA cores in
//   f32, and Y is written once;
// - column tiles of 8, 16, 24 or 32 (the narrowest that covers m; above
//   32, more column tiles of 24 or 32, whichever pads m less), each a
//   pass of eight 16-row tiles, so the x window is staged once per block
//   row and column tile (kernel 5 at its main case stages it in every
//   block of its 8-block cluster); the column tiles of one row group run
//   side by side, so the slab a second tile reads comes from L2;
// - the sums and their order are kernel 5's: the same Y bits as kernel 5
//   on the same inputs, and the same bits on every call.
//
// Kernel 7 is this kernel with x pointed at the centre of x_ext and every
// one of the K slots applied (kAll): a shard does not know where it lies
// in the ring, and at the ring's two ends the wrapped halo rows meet the
// zero blocks of out-of-range slots (scale 1, q 0), as in the TPU kernel.
// Such a slot adds +0 to the sum, so a shard's rows put together are
// kernel 4's Y on the whole matrix exactly. Kernel 4 applies the in-range
// slots only, and never reads x rows outside [0, n).

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_apply.cuh"

namespace {

// Blocks an SM: the register budget (launch bounds) and the ring's shared
// memory of the widest tile allow two.
constexpr int kBlocksPerSM = 2;

template <int TN, bool kAll>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
q_spmm_kernel(Int8 ld, const float* __restrict__ x, float* __restrict__ y,
              int nbr, int bs, int K, int bw, int m, int n_groups, int a_bytes,
              int YP, int off_x) {
  using W = Warps<TN>;
  constexpr int NTN = TN / 8;
  constexpr int KC = Int8::kc<TN>();
  constexpr int AU = W::AU;
  constexpr int PR = kWarps * AU / NTN;  // row tiles a pass
  static_assert(NTN % AU == 0 && PR >= 1, "a warp's units share one row tile");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                              // [kNA][a_bytes]
  float* xs = reinterpret_cast<float*>(smem + off_x);    // [kNA][KC][YP]
  const int grp = static_cast<int>(blockIdx.x);
  const int c0 = static_cast<int>(blockIdx.y) * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int L = K * bs;
  const int RT = (bs + 15) / 16;
  const int cps = (bs + KC - 1) / KC;
  const long long r0 = static_cast<long long>(grp) * nbr / n_groups;
  const long long r1 = static_cast<long long>(grp + 1) * nbr / n_groups;

  for (long long rr = r0; rr < r1; ++rr) {
    const int klo = kAll ? 0 : static_cast<int>(max(0LL, bw - rr));
    const int khi = kAll ? K
                         : static_cast<int>(min(static_cast<long long>(K),
                                                nbr + bw - rr));
    const int n_chunks = (khi - klo) * cps;
    for (int j0 = 0; j0 < RT; j0 += PR) {
      const int ntile = min(PR, RT - j0);
      const int units = ntile * NTN;
      const int lt_w = min(warp * AU / NTN, ntile - 1);
      const int nt_w = warp * AU % NTN;
      float acc[AU][4];
      apply_pass<Int8, TN>(ld, x, rr, j0 * 16, 16, ntile, bs, L, m, c0, bw,
                           klo, n_chunks, as, xs, a_bytes, YP, lt_w, nt_w,
                           acc);
      // Epilogue: d o x on the CUDA cores, Y written once.
#pragma unroll
      for (int a = 0; a < AU; ++a) {
        const int u = warp * AU + a;
        if (u >= units) continue;
        const int col = c0 + (u % NTN) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (j0 + u / NTN) * 16 + g + 8 * h;
          if (row >= bs) continue;
          const long long gr = rr * bs + row;
          const float d = ld.diag[gr];
          if (col < m) y[gr * m + col] = acc[a][2 * h] + d * x[gr * m + col];
          if (col + 1 < m)
            y[gr * m + col + 1] = acc[a][2 * h + 1] + d * x[gr * m + col + 1];
        }
      }
    }
  }
}

// The column tile at width m: the narrowest of 8, 16, 24, 32 that covers
// it; above 32, 24 or 32, whichever pads m less (32 on a tie).
int column_tile(int m) {
  if (m <= 32) return m <= 8 ? 8 : m <= 16 ? 16 : m <= 24 ? 24 : 32;
  return (m + 23) / 24 * 24 < (m + 31) / 32 * 32 ? 24 : 32;
}

struct Layout {
  int TN, a_bytes, YP, off_x, smem, blocks_per_sm, col_tiles, n_groups;
};

template <int TN, bool kAll>
cudaError_t layout_at(int nbr, int m, Layout* out) {
  constexpr int KC = Int8::kc<TN>();
  constexpr int PR = kWarps * Warps<TN>::AU / (TN / 8);
  Layout& l = *out;
  l.TN = TN;
  l.a_bytes = (PR * 16 * Int8::row_bytes<KC>() + 15) / 16 * 16;
  l.YP = frag_stride(TN);
  l.off_x = kNA * l.a_bytes;
  l.smem = l.off_x + kNA * KC * l.YP * 4;
  auto kernel = q_spmm_kernel<TN, kAll>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&l.blocks_per_sm, kernel,
                                                      kThreads, l.smem);
  if (err != cudaSuccess) return err;
  if (l.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  l.col_tiles = (m + TN - 1) / TN;
  l.n_groups = max(1, min(nbr, l.blocks_per_sm * sms / l.col_tiles));
  return cudaSuccess;
}

template <bool kAll>
cudaError_t make_layout(int nbr, int m, Layout* l) {
  switch (column_tile(m)) {
    case 8: return layout_at<8, kAll>(nbr, m, l);
    case 16: return layout_at<16, kAll>(nbr, m, l);
    case 24: return layout_at<24, kAll>(nbr, m, l);
    default: return layout_at<32, kAll>(nbr, m, l);
  }
}

template <int TN, bool kAll>
cudaError_t run(const Int8& ld, const float* x, float* y, int nbr, int bs,
                int K, int bw, int m, const Layout& l, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(l.n_groups),
                  static_cast<unsigned>(l.col_tiles), 1);
  q_spmm_kernel<TN, kAll><<<grid, kThreads, l.smem, s>>>(
      ld, x, y, nbr, bs, K, bw, m, l.n_groups, l.a_bytes, l.YP, l.off_x);
  return cudaGetLastError();
}

// One launch; x holds the rows of every window the K slots read (kAll)
// or of the in-range ones.
template <bool kAll>
int apply(const int8_t* q, const float* scale, const float* diag,
          const float* x, float* y, int nbr, int bs, int K, int bw, int m,
          void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  cudaError_t err = make_layout<kAll>(nbr, m, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Int8 ld{q, scale, diag};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (l.TN) {
    case 8: err = run<8, kAll>(ld, x, y, nbr, bs, K, bw, m, l, s); break;
    case 16: err = run<16, kAll>(ld, x, y, nbr, bs, K, bw, m, l, s); break;
    case 24: err = run<24, kAll>(ld, x, y, nbr, bs, K, bw, m, l, s); break;
    default: err = run<32, kAll>(ld, x, y, nbr, bs, K, bw, m, l, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// q, scale_rows, diag, x, y, nbr, bs, K, bw, m, stream
int fdt_banded_q_bsr_spmm_f32(const int8_t* q, const float* scale,
                              const float* diag, const float* x, float* y,
                              int nbr, int bs, int K, int bw, int m,
                              void* stream) {
  return apply<false>(q, scale, diag, x, y, nbr, bs, K, bw, m, stream);
}

// q, scale_rows, diag, x_ext, y, nbr, bs, K, bw, m, stream: x at the
// shard's first row, x_ext + bw*bs*m.
int fdt_banded_q_ext_bsr_spmm_f32(const int8_t* q, const float* scale,
                                  const float* diag, const float* x_ext,
                                  float* y, int nbr, int bs, int K, int bw,
                                  int m, void* stream) {
  return apply<true>(q, scale, diag,
                     x_ext + static_cast<long long>(bw) * bs * m, y, nbr, bs,
                     K, bw, m, stream);
}

// The layout of a launch at (nbr, m) on the current device, into out[5]:
// column tile, dynamic shared memory a block, blocks an SM, column tiles,
// row groups (blocks a column tile).
int fdt_q_spmm_plan(int nbr, int m, int* out) {
  Layout l;
  const cudaError_t err = make_layout<false>(max(nbr, 1), max(m, 1), &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.TN;
  out[1] = l.smem;
  out[2] = l.blocks_per_sm;
  out[3] = l.col_tiles;
  out[4] = l.n_groups;
  return 0;
}

}  // extern "C"
