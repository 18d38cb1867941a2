// The float32 fused banded SpMM + Gram kernels for Hopper (sm_90a), on
// tensor cores, in plain CUDA C++ with a C interface (loaded with ctypes by
// fortran_davidson_tpu_torch/ops/kernels.py). Storage: (nbr, bs, K*bs)
// row-major block slabs, slot k of block row r holding block column
// r - bw + k.
//
//   fdt_fused_gram_f32    replaces banded_bsr_spmm_gram for float32
//       (fortran_davidson_tpu/ops/pallas_kernels.py:592, body :513):
//       Y = A @ X and G = V^T Y in one sweep over the blocks.
//   fdt_fused_q_gram_f32  replaces banded_q_bsr_spmm_gram
//       (pallas_kernels.py:886, body :834): the same with int8 blocks Q,
//       one f32 scale s per (block row, slot) and the exact f32 diagonal d:
//       Y = sum_k s[r,k] (Q_k @ x_k) + d o x_centre.
//
// The apply, its loaders and staging are fused_apply.cuh's (shared with
// kernel 4's float32 entry, q_spmm.cu); the gram, the cluster and the
// partials are this unit's.
//
// v may be null: G = X^T A X (the gram operand is x itself, ldv = m,
// mv = m, read right after the apply staged the same rows, so from L2).
// y may be null (write_out=False). G is (mv, m) float32.
//
// What bounds them on the H100. G = V^T Y is a split-K GEMM (M = mv,
// N = m, K = n): at mv = 1408, m = 128, n = 2^20 it is 3.8e11 flops against
// 1.3 GB of V. On CUDA cores (67 TFLOP/s) that is 5.6 ms; float32 accuracy
// on the tensor cores costs three TF32 products per product (3xTF32), a
// third of 495 TFLOP/s, 2.3 ms; the bytes take 0.5 ms. So operations bound
// kernel 3, and the tensor cores are the way down. The int8 kernel at
// m = 20, mv = 220 moves 0.8 GB of blocks and 0.9 GB of V and x: bytes.
//
// The design.
// - 3xTF32 mma.sync (m16n8k8, f32 accumulators): each f32 operand splits
//   into hi = tf32(a) and lo = tf32(a - hi), rounded (cvt.rna), and a*b is
//   lo*hi + hi*lo + hi*hi. wgmma would take tf32 operands K-major from
//   shared memory only; V arrives row-major, and the split goes through
//   registers anyway, which suits mma.sync fragments.
// - The int8 apply runs slot by slot: |q| <= 127 is exact in TF32, so
//   Q_k @ x_k is two TF32 products (x hi and lo); the f32 scale multiplies
//   the slot's f32 partial; d o x is added on the CUDA cores in f32.
// - G lives in registers. A thread block cluster of C blocks (C <= 8,
//   from mv and m) walks one contiguous range of block rows; block c owns
//   rows [c*MB, (c+1)*MB) of G (and a column tile of width TN). For each
//   block row the cluster computes the (bs, TN) tile of Y once: block c
//   the 16-row tiles c, c+C, ..., stored to HBM (when y is given) and
//   written into every member's shared memory (distributed shared memory;
//   a cluster barrier after the tile is whole, and one before the next
//   tile's first write, so that the next depth loop overlaps the gram).
//   Then each block adds V[block row, its MB columns]^T @ Y_tile to its
//   registers. So V is read exactly once when one column tile covers m
//   (TN = 128 up to m = 128), and Y is computed once. Each block of a cluster reads the
//   whole x window of the block row (from L2 after the first).
// - Where mv * m is more than one cluster's registers hold (cap(TN) rows
//   per block, times 8), the wrapper takes a narrower TN and the grid
//   splits m into column tiles, each re-reading V. That is the general
//   case, not a fallback. Where the V ring's stages would not fit shared
//   memory, C grows (fewer G rows a block). A v wider than eight blocks
//   hold at TN = 8 (mv > 12288) returns cudaErrorInvalidValue.
// - V streams through a ring of shared-memory stages (cp.async, 16-byte
//   copies where the row stride and bounds allow, 4-byte otherwise), the
//   next stages in flight while the current one is multiplied; the apply
//   stages its slab chunks and x chunks through a ring the same way.
// - Partials: one (mv, m) per cluster (about 2 * SMs / C of them), summed
//   by a second kernel in a fixed order: the same inputs give the same
//   bits.
// - Edge windows: a slot whose block column lies outside [0, nbr) is
//   skipped (its block is zero), so x rows outside [0, n) are never read
//   and 0 * Inf never enters the sum; columns past m and rows past bs are
//   staged as zeros and never loaded.
//
// Variants (template argument, for measurement only; chip_smoke.py times
// them): kNoV reads no V and reduces Y to its column sums (G row 0);
// kNoGram streams V through the ring as the full kernel does but skips
// the gram product (G row 0 again holds Y's column sums). With the full
// kernel they split its time into apply, V stream and gram (the
// counterparts of experiments/fused_probe.py's nov and nogram).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_apply.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kVS = 32;        // gram: V rows per ring stage (4 k-steps)
constexpr int kNS = 3;         // gram: ring stages
constexpr int kFlush = 2;      // gram: block rows between partial flushes

enum Variant { kFull = 0, kNoV = 1, kNoGram = 2 };

// Stage rows x cols floats of V (a run-time width) as stage_f32 does: a
// warp a row, a lane a quad.
__device__ __forceinline__ void stage_rows_f32(float* dst, int dp,
                                               const float* src, long long ld,
                                               int rows, int cols,
                                               int valid_rows, int valid_cols) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < rows; i += kWarps)
    for (int c = lane * 4; c < cols; c += 128)
      quad_f32(dst + i * dp + c, src + i * ld + c,
               i < valid_rows ? valid_cols - c : 0);
}


struct Params {
  const float* x;
  const float* v;  // the gram operand (x itself for G = X^T A X)
  long long ldv;
  float* y;        // nullable
  float* partial;  // (n_groups, mv, m)
  int nbr, bs, K, bw, m, mv;
  int C, MB, n_groups;  // cluster size, G rows per block, row groups
  int RT, PR;           // 16-row tiles of a block row; tiles per apply pass
  int YP, VP;           // row strides (floats) of the Y tile and V stages
  int ys_rows;          // rows of the Y tile: RT * 16, rounded up to kVS
  int off_v, off_a, off_x, a_bytes;  // dynamic shared memory layout
};

template <class Ld, int TN, int kVar>
__global__ void __launch_bounds__(kThreads, 1)
fused_gram_kernel(Ld ld, Params p) {
  using W = Warps<TN>;
  constexpr int NTN = TN / 8;
  constexpr int WM = kWarps / W::WN;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = static_cast<int>(blockIdx.x) / p.C;
  const int c0 = static_cast<int>(blockIdx.y) * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bs = p.bs;
  const int L = p.K * bs;
  const int m = p.m;
  const int bs8 = (bs + 7) & ~7;
  const int a_base = rank * p.MB;
  const int mbv = min(p.MB, p.mv - a_base);  // this block's rows of G
  const long long r0 = static_cast<long long>(grp) * p.nbr / p.n_groups;
  const long long r1 = static_cast<long long>(grp + 1) * p.nbr / p.n_groups;

  float* ys = reinterpret_cast<float*>(smem);  // [ys_rows][YP]
  // Rows past the row tiles are read by the gram's last stage, never
  // written: zeros.
  for (int e = p.RT * 16 * p.YP + threadIdx.x; e < p.ys_rows * p.YP; e += kThreads)
    ys[e] = 0.f;
  float* vs = reinterpret_cast<float*>(smem + p.off_v);  // [kNS][kVS][VP]
  unsigned char* as = smem + p.off_a;                    // [kNA][a_bytes]
  float* xs = reinterpret_cast<float*>(smem + p.off_x);  // [kNA][KC][YP]

  // -- the V ring: item j is stage j % stages of block row r0 + j / stages
  const int stages = (bs8 + kVS - 1) / kVS;
  const long long n_items = kVar == kNoV ? 0 : (r1 - r0) * stages;
  auto issue_v = [&](long long j) {
    if (j < n_items) {
      const long long rr = r0 + j / stages;
      const int s0 = static_cast<int>(j % stages) * kVS;
      stage_rows_f32(vs + static_cast<int>(j % kNS) * kVS * p.VP, p.VP,
                     p.v + (rr * bs + s0) * p.ldv + a_base, p.ldv, kVS, p.MB,
                     min(kVS, bs - s0), max(0, mbv));
    }
    commit();
  };
#pragma unroll
  for (int j = 0; j < kNS - 1; ++j) issue_v(j);

  float gacc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
  float colsum = 0.f;
  // This block's slice of the cluster's partial of G.
  float* out = p.partial + static_cast<long long>(grp) * p.mv * m;
  const int wm = warp / W::WN;
  const int wn = warp % W::WN;

  // -- the apply's row tiles: rank, rank + C, ... < RT, PR of them a pass
  constexpr int KC = Ld::template kc<TN>();
  constexpr int AU = W::AU;
  const int my_tiles = rank < p.RT ? (p.RT - 1 - rank) / p.C + 1 : 0;
  const int passes = (my_tiles + p.PR - 1) / p.PR;
  const int cps = (bs + KC - 1) / KC;  // depth chunks per slot (apply_pass)

  for (long long rr = r0; rr < r1; ++rr) {
    float* ytile = ys;
    // The members still read the previous block row's tile until they
    // reach this barrier: the first write of this row's tile waits for it
    // (so this row's depth loop overlaps their gram).
    bool released = rr == r0;
    const int klo = static_cast<int>(max(0LL, p.bw - rr));
    const int khi = static_cast<int>(min(static_cast<long long>(p.K),
                                         p.nbr + p.bw - rr));
    const int n_chunks = (khi - klo) * cps;

    for (int ps = 0; ps < passes; ++ps) {
      const int j0 = ps * p.PR;
      const int ntile = min(p.PR, my_tiles - j0);
      // Warp w takes units w*AU .. w*AU + AU - 1 of the pass: row tile
      // lt_w, n-tiles nt_w .. nt_w + AU - 1 (AU divides NTN).
      static_assert(NTN % AU == 0, "a warp's units share one row tile");
      const int units = ntile * NTN;
      const int lt_w = min(warp * AU / NTN, ntile - 1);
      const int nt_w = warp * AU % NTN;
      float acc[AU][4];
      apply_pass<Ld, TN>(ld, p.x, rr, (rank + j0 * p.C) * 16, p.C * 16,
                         ntile, bs, L, m, c0, p.bw, klo, n_chunks, as, xs,
                         p.a_bytes, p.YP, lt_w, nt_w, acc);

      // Epilogue: d o x (int8), Y to HBM, the tile to every member.
      if (!released) {
        cluster.sync();
        released = true;
      }
#pragma unroll
      for (int a = 0; a < AU; ++a) {
        const int u = warp * AU + a;
        if (u >= units) continue;
        const int tile = rank + (j0 + u / NTN) * p.C;
        const int col = (u % NTN) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tile * 16 + g + 8 * h;
          float v0 = acc[a][2 * h];
          float v1 = acc[a][2 * h + 1];
          const long long gr = rr * bs + row;
          if constexpr (Ld::kQuant) {
            if (row < bs) {
              const float d = ld.diag[gr];
              if (c0 + col < m) v0 += d * p.x[gr * m + c0 + col];
              if (c0 + col + 1 < m) v1 += d * p.x[gr * m + c0 + col + 1];
            }
          }
          if (p.y != nullptr && row < bs) {
            if (c0 + col < m) p.y[gr * m + c0 + col] = v0;
            if (c0 + col + 1 < m) p.y[gr * m + c0 + col + 1] = v1;
          }
          for (int q = 0; q < p.C; ++q) {
            float* dst = cluster.map_shared_rank(ytile, q);
            *reinterpret_cast<float2*>(dst + row * p.YP + col) =
                make_float2(v0, v1);
          }
        }
      }
    }
    if (!released) cluster.sync();  // a member without row tiles
    cluster.sync();  // the Y tile is whole in every member

    if (kVar != kFull && rank == 0 && threadIdx.x < TN)
      for (int i = 0; i < bs; ++i) colsum += ytile[i * p.YP + threadIdx.x];
    if (kVar == kNoV) continue;

    // -- the gram: G[a_base + i, c0 + c] += sum_k V[rr*bs + k, a_base + i] Y[k, c]
    for (int s = 0; s < stages; ++s) {
      const long long j = (rr - r0) * stages + s;
      wait_group<kNS - 2>();
      __syncthreads();  // stage j landed; stage j - 1's slot is free
      issue_v(j + kNS - 1);
      if (kVar != kFull || mbv <= 0) continue;
      const float* vb = vs + static_cast<int>(j % kNS) * kVS * p.VP;
      const float* yb = ytile + s * kVS * p.YP;
      const int last_mt = (mbv - 1) / 16;
      // Every k-step of the stage (rows past bs are zeros in both
      // operands); the warp's m-tiles (wm, wm + WM, ...) two at a time, the
      // second of a pair past the block's last repeating it (dropped when G
      // is written), so that a pair's eight product chains interleave.
#pragma unroll
      for (int ks = 0; ks < kVS / 8; ++ks) {
        uint32_t bh[W::NT][2], bl[W::NT][2];
#pragma unroll
        for (int jn = 0; jn < W::NT; ++jn) {
          const int n = (wn * W::NT + jn) * 8 + g;
          split(yb[(ks * 8 + t) * p.YP + n], bh[jn][0], bl[jn][0]);
          split(yb[(ks * 8 + t + 4) * p.YP + n], bh[jn][1], bl[jn][1]);
        }
#pragma unroll
        for (int ip = 0; ip < W::MT; ip += 2) {
          if ((wm + ip * WM) * 16 >= mbv) break;
          constexpr int kPair = 2;
          uint32_t ah[kPair][4], al[kPair][4];
#pragma unroll
          for (int h = 0; h < kPair; ++h) {
            if (ip + h >= W::MT) break;
            const int mt = min(wm + (ip + h) * WM, last_mt);
            const float* va = vb + ks * 8 * p.VP + mt * 16 + g;
            split(va[t * p.VP], ah[h][0], al[h][0]);
            split(va[t * p.VP + 8], ah[h][1], al[h][1]);
            split(va[(t + 4) * p.VP], ah[h][2], al[h][2]);
            split(va[(t + 4) * p.VP + 8], ah[h][3], al[h][3]);
          }
#pragma unroll
          for (int h = 0; h < kPair; ++h) {
            if (ip + h >= W::MT) break;
#pragma unroll
            for (int jn = 0; jn < W::NT; ++jn) mma(gacc[ip + h][jn], al[h], bh[jn]);
#pragma unroll
            for (int jn = 0; jn < W::NT; ++jn) mma(gacc[ip + h][jn], ah[h], bl[jn]);
#pragma unroll
            for (int jn = 0; jn < W::NT; ++jn) mma(gacc[ip + h][jn], ah[h], bh[jn]);
          }
        }
      }
    }

    // Every kFlush block rows (and at the end), add the registers into
    // this block's slice of the cluster's partial (a rounded f32 add) and
    // restart them. The tensor cores' f32 accumulation does not round to
    // nearest: on a sum of positive terms (G = X^T A X) it loses about
    // 2^-25 of the sum per product added, 1.1e-5 over 8 block rows of
    // bs = 128 (3 * 16 * 8 products, measured on the H100). Two block rows
    // keep that near 3e-6.
    if (kVar == kFull && ((rr - r0 + 1) % kFlush == 0 || rr + 1 == r1)) {
      const bool first = rr - r0 < kFlush;
      // Two m-tiles' loads before their stores: MT / 2 round trips.
#pragma unroll
      for (int ip = 0; ip < W::MT; ip += 2) {
        constexpr int kPair = 2;
        float old[kPair][W::NT][4];
#pragma unroll
        for (int h = 0; h < kPair; ++h)
#pragma unroll
          for (int jn = 0; jn < W::NT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = (wm + (ip + h) * WM) * 16 + g + (e >= 2 ? 8 : 0);
              const int col = c0 + (wn * W::NT + jn) * 8 + 2 * t + (e & 1);
              old[h][jn][e] =
                  !first && ip + h < W::MT && row < mbv && col < m
                      ? out[static_cast<long long>(a_base + row) * m + col]
                      : 0.f;
            }
#pragma unroll
        for (int h = 0; h < kPair; ++h) {
          if (ip + h >= W::MT) break;
#pragma unroll
          for (int jn = 0; jn < W::NT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = (wm + (ip + h) * WM) * 16 + g + (e >= 2 ? 8 : 0);
              const int col = c0 + (wn * W::NT + jn) * 8 + 2 * t + (e & 1);
              if (row < mbv && col < m)
                out[static_cast<long long>(a_base + row) * m + col] =
                    old[h][jn][e] + gacc[ip + h][jn][e];
              gacc[ip + h][jn][e] = 0.f;
            }
        }
      }
    }
  }
  wait_group<0>();

  if (kVar != kFull) {
    for (int e = threadIdx.x; e < max(0, mbv) * TN; e += kThreads) {
      const int col = c0 + e % TN;
      if (col < m) out[static_cast<long long>(a_base + e / TN) * m + col] = 0.f;
    }
    __syncthreads();
    if (rank == 0 && threadIdx.x < TN && c0 + static_cast<int>(threadIdx.x) < m)
      out[c0 + threadIdx.x] = colsum;
  }
}


// -- host side ---------------------------------------------------------------

struct Plan {
  int TN, C, MB, col_tiles, smem;
  Params p;
};

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The layout at column tile width TN with the fewest blocks a cluster
// (C <= 8) whose G rows fit their registers and whose shared memory fits
// a block; false if none does.
template <class Ld, int TN>
bool plan_at(int bs, int mv, int optin, Plan* plan) {
  using W = Warps<TN>;
  constexpr int KC = Ld::template kc<TN>();
  const int cap = cap_rows<TN>();
  for (int C = (mv + cap - 1) / cap; C <= 8; ++C) {
    Params& p = plan->p;
    p.C = C;
    p.MB = round_up((mv + C - 1) / C, 16);
    p.RT = (bs + 15) / 16;
    p.PR = max(1, kWarps * W::AU / (TN / 8));
    p.YP = frag_stride(TN);
    p.VP = frag_stride(p.MB);
    p.a_bytes = round_up(p.PR * 16 * Ld::template row_bytes<KC>(), 16);
    p.ys_rows = round_up(p.RT * 16, kVS);
    p.off_v = p.ys_rows * p.YP * 4;
    p.off_a = p.off_v + kNS * kVS * p.VP * 4;
    p.off_x = p.off_a + kNA * p.a_bytes;
    plan->smem = p.off_x + kNA * KC * p.YP * 4;
    if (plan->smem > optin) continue;
    plan->TN = TN;
    plan->C = C;
    plan->MB = p.MB;
    return true;
  }
  return false;
}

// The widest column tile TN (m rounded up to 8, at most 128) that has a
// layout, narrower ones after it; the grid then has ceil(m / TN) column
// tiles.
template <class Ld>
cudaError_t make_plan(int bs, int m, int mv, Plan* plan) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int want = round_up(min(m, 128), 8);
  bool ok = false;
  if (!ok && want <= 128 && want > 64) ok = plan_at<Ld, 128>(bs, mv, optin, plan);
  if (!ok && want > 32) ok = plan_at<Ld, 64>(bs, mv, optin, plan);
  if (!ok && want > 24) ok = plan_at<Ld, 32>(bs, mv, optin, plan);
  if (!ok && want > 16) ok = plan_at<Ld, 24>(bs, mv, optin, plan);
  if (!ok && want > 8) ok = plan_at<Ld, 16>(bs, mv, optin, plan);
  if (!ok) ok = plan_at<Ld, 8>(bs, mv, optin, plan);
  if (!ok) return cudaErrorInvalidValue;
  plan->col_tiles = (m + plan->TN - 1) / plan->TN;
  return cudaSuccess;
}

// Launch (or, with n_groups_out, size the grid and report the layout:
// n_groups, TN, C, MB, shared bytes, clusters resident): clusters of C blocks,
// n_groups of them over the block rows times col_tiles, then the fixed-order
// sum of the partials.
template <class Ld, int TN, int kVar>
cudaError_t run(const Ld& ld, Plan plan, float* g, int* n_groups_out,
                cudaStream_t stream) {
  auto kernel = fused_gram_kernel<Ld, TN, kVar>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  Params& p = plan.p;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (n_groups_out != nullptr) {
    cfg.gridDim = dim3(plan.C, 1, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    n_groups_out[0] = max(1, min(p.nbr, clusters / plan.col_tiles));
    n_groups_out[1] = TN;
    n_groups_out[2] = plan.C;
    n_groups_out[3] = plan.MB;
    n_groups_out[4] = plan.smem;
    n_groups_out[5] = clusters;
    return cudaSuccess;
  }
  if (p.n_groups < 1 || p.n_groups > p.nbr) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(p.n_groups * plan.C, plan.col_tiles, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, ld, p);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long count = static_cast<long long>(p.mv) * p.m;
  const long long blocks = (count + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  reduce_partials<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      p.partial, g, p.n_groups, count);
  return cudaGetLastError();
}

// The full kernel at every width; the measurement variants at the main
// cases' widths only (128 for f32 blocks; 24 for int8 at m = 20, and 128
// at experiments/fused_probe.py's m = 256).
template <class Ld>
cudaError_t dispatch(const Ld& ld, const Plan& plan, int variant, float* g,
                     int* n_groups_out, cudaStream_t s) {
  if (variant == kFull) {
    switch (plan.TN) {
      case 8: return run<Ld, 8, kFull>(ld, plan, g, n_groups_out, s);
      case 16: return run<Ld, 16, kFull>(ld, plan, g, n_groups_out, s);
      case 24: return run<Ld, 24, kFull>(ld, plan, g, n_groups_out, s);
      case 32: return run<Ld, 32, kFull>(ld, plan, g, n_groups_out, s);
      case 64: return run<Ld, 64, kFull>(ld, plan, g, n_groups_out, s);
      default: return run<Ld, 128, kFull>(ld, plan, g, n_groups_out, s);
    }
  }
  if (variant != kNoV && variant != kNoGram) return cudaErrorInvalidValue;
  if constexpr (Ld::kQuant) {
    if (plan.TN == 24)
      return variant == kNoV ? run<Ld, 24, kNoV>(ld, plan, g, n_groups_out, s)
                             : run<Ld, 24, kNoGram>(ld, plan, g, n_groups_out, s);
  }
  if (plan.TN != 128) return cudaErrorNotSupported;
  return variant == kNoV ? run<Ld, 128, kNoV>(ld, plan, g, n_groups_out, s)
                         : run<Ld, 128, kNoGram>(ld, plan, g, n_groups_out, s);
}

template <class Ld>
int fused(const Ld& ld, const float* x, const float* v, long long ldv, float* y,
          float* partial, float* g, int nbr, int bs, int K, int bw, int m,
          int mv, int n_groups, int variant, int* n_groups_out, void* stream) {
  if (nbr <= 0 || bs <= 0 || K <= 0 || m <= 0 || mv <= 0) return 0;
  if (v == nullptr && variant != kNoV) {  // G = X^T A X: mv == m
    v = x;
    ldv = m;
  }
  Plan plan;
  cudaError_t err = make_plan<Ld>(bs, m, mv, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params& p = plan.p;
  p.x = x;
  p.v = v;
  p.ldv = ldv;
  p.y = y;
  p.partial = partial;
  p.nbr = nbr;
  p.bs = bs;
  p.K = K;
  p.bw = bw;
  p.m = m;
  p.mv = mv;
  p.n_groups = n_groups;
  return static_cast<int>(dispatch(ld, plan, variant, g, n_groups_out,
                                   static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// The layout of a call, into out[6]: the number of partials (row groups;
// the wrapper allocates n_groups * mv * m floats of scratch), the column
// tile TN, the cluster size C, the G rows a block MB, the dynamic shared
// memory a block, and the clusters the card holds at once. quant: 0 for
// f32 blocks, 1 for int8.
int fdt_fused_gram_plan(int quant, int variant, int nbr, int bs, int K, int m,
                        int mv, int* n_groups) {
  for (int i = 0; i < 6; ++i) n_groups[i] = 0;
  if (quant)
    return fused(Int8{nullptr, nullptr, nullptr}, nullptr, nullptr, 0, nullptr,
                 nullptr, nullptr, nbr, bs, K, 0, m, mv, 0, variant, n_groups,
                 nullptr);
  return fused(DenseF32{nullptr}, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
               nbr, bs, K, 0, m, mv, 0, variant, n_groups, nullptr);
}

// blocks, x, v (nullable), ldv, y (nullable), partial, g, nbr, bs, K, bw, m,
// mv, n_groups, variant, stream
int fdt_fused_gram_f32(const float* blocks, const float* x, const float* v,
                       long long ldv, float* y, float* partial, float* g,
                       int nbr, int bs, int K, int bw, int m, int mv,
                       int n_groups, int variant, void* stream) {
  return fused(DenseF32{blocks}, x, v, ldv, y, partial, g, nbr, bs, K, bw, m,
               mv, n_groups, variant, nullptr, stream);
}

// q, scale_rows, diag, then the dense entry's arguments from x on
int fdt_fused_q_gram_f32(const int8_t* q, const float* scale,
                         const float* diag, const float* x, const float* v,
                         long long ldv, float* y, float* partial, float* g,
                         int nbr, int bs, int K, int bw, int m, int mv,
                         int n_groups, int variant, void* stream) {
  return fused(Int8{q, scale, diag}, x, v, ldv, y, partial, g, nbr, bs, K, bw,
               m, mv, n_groups, variant, nullptr, stream);
}

}  // extern "C"
