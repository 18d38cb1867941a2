// The bf16-dequant measurement variants of kernel 5 (the int8 fused banded
// SpMM + Gram) for Hopper (sm_90a), in plain CUDA C++ with a C interface
// (loaded with ctypes by fortran_davidson_tpu_torch/ops/kernels.py,
// kernels.fused_gram_variant). No path of the port calls them.
//
//   fdt_fused_q_gram_bf16   the counterparts of experiments/fused_probe.py's
//       bf16deq, tg_bf16deq and nov_bf16 (the pallas_call at :170 and
//       :191; row math :44-77, modes :85-130): int8 blocks Q, one f32 scale
//       s per (block row, slot), the exact f32 diagonal d; x (n, m) and
//       v (n, mv) bf16. For block row r:
//         W   = bf16(bf16(q) * bf16(s))        (the dequantized blocks)
//         y_r = W @ x_window (bf16 products, f32 sums) + d o x_centre (f32)
//       bf16deq:    G += v[rows]^T @ bf16(y_r), one block row at a time;
//       tg_bf16deq: the same function, bf16(y) of kTileRows block rows
//                   staged first, then one gram of depth kTileRows * bs;
//       nov_bf16:   no v; G's row 0 is the column sums of y in f32, the
//                   other rows are 0.
//       G is (mv, m) f32 (mv = m for nov_bf16).
//   fdt_fused_bf16_plan     the layout of a call (kernels.fused_bf16_plan).
//
// What they measure. Kernel 5 applies Q slot by slot on TF32 tensor cores,
// two products a k-step (x hi and lo), and keeps the gram in 3xTF32; these
// variants run the apply as one bf16 product a k-step (m16n8k16) on the
// dequantized blocks, and the gram as one bf16 product on bf16(y): the
// question fused_probe.py asked, whether a one-product apply is the faster
// one, and how much of the sweep the gram is on Hopper (chip_smoke.py times
// them beside kernel 5, nov and nogram).
//
// The design keeps kernel 5's schedule (fused_gram.cu): a cluster of C
// blocks walks a contiguous range of block rows; block c owns G rows
// [c*MB, (c+1)*MB) at a column tile of TN, in registers for the whole
// walk. The Y tile of a block row is computed once: block c the 16-row
// tiles c, c + C, ..., from the int8 slab chunks and bf16 x chunks staged
// through fused_apply.cuh's cp.async ring (Int8::stage, kNA stages), the
// int8 bytes dequantized to bf16 in registers, B fragments by
// ldmatrix.trans (kernel 1's b_frag, banded_spmm.cuh), d o x added in f32;
// bf16(Y) is written into every member's shared memory. V's rows of the
// block row (tg_bf16deq: of kTileRows block rows) are staged once a block
// by cp.async while Y is computed; then each block adds V^T bf16(Y) for
// its G rows on mma.sync m16n8k16 (A fragments of V^T by ldmatrix.trans),
// f32 sums. Partials: one (mv, m) a cluster, written once at the end of the
// walk, summed in a fixed order by reduce_partials: the same inputs give
// the same bits. nov_bf16 runs clusters of one block: Y in f32 in shared
// memory, its column sums in a fixed order. Simple, not tuned: V is staged
// whole per block row (no ring), a member waits for the others' gram
// before it writes the next Y tile, as kernel 5 does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "banded_spmm.cuh"
#include "fused_apply.cuh"

namespace cg = cooperative_groups;

namespace {

using fdt1::Bf16;

enum BVariant { kRowGram = 0, kTileGram = 1, kNoVBf16 = 2 };
constexpr int kTileRows = 2;  // tg_bf16deq: block rows a gram

// Row stride (bf16 elements) of a [row][col] tile read by ldmatrix: rows
// 16-byte aligned, an odd number of 16-byte units apart (conflict-free).
__host__ __device__ constexpr int bstride(int cols) {
  return ((cols + 8) / 8) % 2 == 1 ? cols + 8 : cols + 16;
}

__device__ __forceinline__ void ldsm_x4_trans(const Bf16* p, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// Two neighbouring int8 entries q[0], q[1] as bf16(bf16(q) * sb) (sb the
// bf16-rounded scale: q * sb is exact in f32, one rounding to bf16), packed
// as an mma operand (q[0] in the low half).
__device__ __forceinline__ uint32_t deq2(const int8_t* q, float sb) {
  const __nv_bfloat162 w = __floats2bfloat162_rn(static_cast<float>(q[0]) * sb,
                                                 static_cast<float>(q[1]) * sb);
  return *reinterpret_cast<const uint32_t*>(&w);
}

struct BParams {
  const Bf16* x;
  const Bf16* v;   // nullable (nov_bf16)
  long long ldv;
  float* partial;  // (n_groups, mv, m)
  int nbr, bs, K, bw, m, mv;
  int C, MB, n_groups;  // cluster size, G rows per block, row groups
  int RT, PR;           // 16-row tiles of a block row; tiles per apply pass
  int XP, YP, VP;       // row strides of the x chunks, Y tile, V stage
  int off_v, off_a, off_x, a_bytes;  // dynamic shared memory layout
  int vec_x, vec_v;     // 16-byte copies of x, v allowed
};

// One pass of the bf16 apply (fused_apply.cuh's apply_pass with W in bf16):
// acc = this warp's units (row tile lt_w, n-tiles nt_w .. + AU - 1) of
// block row rr at column tile c0; ends with every copy landed.
template <int TN>
__device__ __forceinline__ void apply_bf16(
    const Int8& ld, const BParams& p, long long rr, int i0, int tstride,
    int ntile, int L, int c0, int klo, int n_chunks, unsigned char* as,
    Bf16* xs, int lt_w, int nt_w, float (&acc)[Warps<TN>::AU][4]) {
  constexpr int KC = Int8::kc<TN>();
  constexpr int AU = Warps<TN>::AU;
  constexpr int P = a_stride_i8(KC);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bs = p.bs;
  const int m = p.m;
  const int cps = (bs + KC - 1) / KC;
  auto issue_chunk = [&](int it) {
    if (it < n_chunks) {
      const int k = klo + it / cps;
      const int d0 = (it % cps) * KC;
      const int kc = min(KC, bs - d0);
      const int b = it % kNA;
      ld.stage<KC>(as + b * p.a_bytes, rr, i0, ntile * 16, tstride, bs, L,
                   k * bs + d0, kc);
      const long long xr = (rr - p.bw + k) * bs + d0;
      fdt1::stage_tile<Bf16, false>(xs + b * KC * p.XP, p.XP,
                                    p.x + xr * m + c0, p.x, m, KC, TN, 0, kc,
                                    m - c0, p.vec_x != 0, 0);
    }
    commit();
  };
#pragma unroll
  for (int a = 0; a < AU; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;

  __syncthreads();  // the ring's stages are free (previous pass, row)
#pragma unroll
  for (int it = 0; it < kNA - 1; ++it) issue_chunk(it);
  for (int it = 0; it < n_chunks; ++it) {
    wait_group<kNA - 2>();
    __syncthreads();  // chunk it landed; chunk it - 1's stage is free
    issue_chunk(it + kNA - 1);
    const int8_t* ab = reinterpret_cast<const int8_t*>(as + (it % kNA) * p.a_bytes);
    const Bf16* xb = xs + (it % kNA) * KC * p.XP;
    const int k = klo + it / cps;  // a chunk lies in one slot
    const float sb = __bfloat162float(__float2bfloat16_rn(ld.scale[rr * L + k * bs]));
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int8_t* q = ab + (lt_w * 16 + g) * P + ks * 16 + 2 * t;
      const uint32_t a[4] = {deq2(q, sb), deq2(q + 8 * P, sb), deq2(q + 8, sb),
                             deq2(q + 8 * P + 8, sb)};
      const Bf16* xrow = xb + (ks * 16 + (lane & 15)) * p.XP;
#pragma unroll
      for (int u = 0; u < AU; ++u) {
        uint32_t b0, b1;
        fdt1::b_frag(xrow + (nt_w + u) * 8, b0, b1);
        fdt1::bmma(acc[u], a, b0, b1);
      }
    }
  }
  wait_group<0>();
}

// Rows i * rows_t + k of vs (k < rows_t, i < nrows) hold V[row0 + i * bs + k,
// a_base + c] for k < bs and c < mbv, else zero: 16-byte copies where the
// source allows, element loads otherwise.
__device__ __forceinline__ void stage_v(Bf16* vs, const BParams& p,
                                        long long row0, int nrows, int rows_t,
                                        int a_base, int mbv) {
  const int segs = p.MB / 8;
  for (int e = threadIdx.x; e < nrows * rows_t * segs; e += kThreads) {
    const int rk = e / segs;
    const int c = (e % segs) * 8;
    const int i = rk / rows_t;
    const int k = rk % rows_t;
    Bf16* d = vs + rk * p.VP + c;
    if (k >= p.bs || c >= mbv) {
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      continue;
    }
    const Bf16* s = p.v + (row0 + static_cast<long long>(i) * p.bs + k) * p.ldv
                    + a_base + c;
    if (p.vec_v && c + 8 <= mbv) {
      cp16(d, s);
    } else {
      for (int j = 0; j < 8; ++j)
        d[j] = c + j < mbv ? s[j] : __float2bfloat16(0.f);
    }
  }
}

template <int TN, int kVar>
__global__ void __launch_bounds__(kThreads, 1)
bf16_gram_kernel(Int8 ld, BParams p) {
  using W = Warps<TN>;
  constexpr int NTN = TN / 8;
  constexpr int WM = kWarps / W::WN;
  constexpr int AU = W::AU;
  constexpr int R = kVar == kTileGram ? kTileRows : 1;
  static_assert(NTN % AU == 0, "a warp's units share one row tile");
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
  const int rows_t = p.RT * 16;
  const int a_base = rank * p.MB;
  const int mbv = max(0, min(p.MB, p.mv - a_base));  // this block's G rows
  const long long r0 = static_cast<long long>(grp) * p.nbr / p.n_groups;
  const long long r1 = static_cast<long long>(grp + 1) * p.nbr / p.n_groups;

  Bf16* ys = reinterpret_cast<Bf16*>(smem);     // [R][rows_t][YP] bf16(Y)
  float* yf = reinterpret_cast<float*>(smem);   // nov_bf16: [rows_t][YP] Y
  Bf16* vs = reinterpret_cast<Bf16*>(smem + p.off_v);  // [R][rows_t][VP]
  unsigned char* as = smem + p.off_a;                  // [kNA][a_bytes]
  Bf16* xs = reinterpret_cast<Bf16*>(smem + p.off_x);  // [kNA][KC][XP]

  float gacc[W::MT][W::NT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i)
#pragma unroll
    for (int j = 0; j < W::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gacc[i][j][e] = 0.f;
  float colsum = 0.f;
  const int wm = warp / W::WN;
  const int wn = warp % W::WN;
  const int my_tiles = rank < p.RT ? (p.RT - 1 - rank) / p.C + 1 : 0;
  const int passes = (my_tiles + p.PR - 1) / p.PR;
  constexpr int KC = Int8::kc<TN>();
  const int cps = (bs + KC - 1) / KC;

  for (long long g0 = r0; g0 < r1; g0 += R) {
    const int nrows = static_cast<int>(min(static_cast<long long>(R), r1 - g0));
    __syncthreads();  // this block's gram of the previous rows read vs
    if (kVar != kNoVBf16) {
      stage_v(vs, p, g0 * bs, nrows, rows_t, a_base, mbv);
      commit();
    }
    // The members still read the previous rows' Y tile until they reach
    // this barrier: the first write of these rows' tile waits for it.
    bool released = g0 == r0;
    for (int i = 0; i < nrows; ++i) {
      const long long rr = g0 + i;
      const int klo = static_cast<int>(max(0LL, p.bw - rr));
      const int khi = static_cast<int>(min(static_cast<long long>(p.K),
                                           p.nbr + p.bw - rr));
      const int n_chunks = (khi - klo) * cps;
      for (int ps = 0; ps < passes; ++ps) {
        const int j0 = ps * p.PR;
        const int ntile = min(p.PR, my_tiles - j0);
        const int units = ntile * NTN;
        const int lt_w = min(warp * AU / NTN, ntile - 1);
        const int nt_w = warp * AU % NTN;
        float acc[AU][4];
        apply_bf16<TN>(ld, p, rr, (rank + j0 * p.C) * 16, p.C * 16, ntile, L,
                       c0, klo, n_chunks, as, xs, lt_w, nt_w, acc);
        if (!released) {
          cluster.sync();
          released = true;
        }
        // Epilogue: d o x in f32; bf16(Y) to every member (nov_bf16: Y).
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
            if (row < bs) {
              const long long gr = rr * bs + row;
              const float d = ld.diag[gr];
              if (c0 + col < m)
                v0 += d * __bfloat162float(p.x[gr * m + c0 + col]);
              if (c0 + col + 1 < m)
                v1 += d * __bfloat162float(p.x[gr * m + c0 + col + 1]);
            }
            if constexpr (kVar == kNoVBf16) {
              *reinterpret_cast<float2*>(yf + row * p.YP + col) =
                  make_float2(v0, v1);
            } else {
              const __nv_bfloat162 w = __floats2bfloat162_rn(v0, v1);
              for (int q = 0; q < p.C; ++q) {
                Bf16* dst = cluster.map_shared_rank(ys, q);
                *reinterpret_cast<__nv_bfloat162*>(
                    dst + (i * rows_t + row) * p.YP + col) = w;
              }
            }
          }
        }
      }
    }
    if (!released) cluster.sync();  // a member without row tiles
    cluster.sync();  // the Y tiles are whole in every member

    if constexpr (kVar == kNoVBf16) {
      if (threadIdx.x < TN)
        for (int i = 0; i < bs; ++i) colsum += yf[i * p.YP + threadIdx.x];
      continue;
    }
    wait_group<0>();
    __syncthreads();  // V landed
    // G[a_base + a, c0 + c] += sum_k V[row k, a_base + a] bf16(Y)[k, c]
    for (int k0 = 0; k0 < nrows * rows_t; k0 += 16) {
      uint32_t b[W::NT][2];
#pragma unroll
      for (int jn = 0; jn < W::NT; ++jn)
        fdt1::b_frag(ys + (k0 + (lane & 15)) * p.YP + (wn * W::NT + jn) * 8,
                     b[jn][0], b[jn][1]);
#pragma unroll
      for (int ip = 0; ip < W::MT; ++ip) {
        const int mt = wm + ip * WM;
        if (mt * 16 >= mbv) break;
        uint32_t a[4];
        ldsm_x4_trans(vs + (k0 + (lane & 7) + 8 * (lane >> 4)) * p.VP + mt * 16
                          + 8 * ((lane >> 3) & 1),
                      a);
#pragma unroll
        for (int jn = 0; jn < W::NT; ++jn)
          fdt1::bmma(gacc[ip][jn], a, b[jn][0], b[jn][1]);
      }
    }
  }
  wait_group<0>();

  // This block's slice of the cluster's partial of G.
  float* out = p.partial + static_cast<long long>(grp) * p.mv * m;
  if constexpr (kVar == kNoVBf16) {
    for (int e = threadIdx.x; e < p.mv * TN; e += kThreads) {
      const int col = c0 + e % TN;
      if (col < m) out[static_cast<long long>(e / TN) * m + col] = 0.f;
    }
    __syncthreads();
    if (threadIdx.x < TN && c0 + static_cast<int>(threadIdx.x) < m)
      out[c0 + threadIdx.x] = colsum;
  } else {
#pragma unroll
    for (int ip = 0; ip < W::MT; ++ip)
#pragma unroll
      for (int jn = 0; jn < W::NT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = (wm + ip * WM) * 16 + g + (e >= 2 ? 8 : 0);
          const int col = c0 + (wn * W::NT + jn) * 8 + 2 * t + (e & 1);
          if (row < mbv && col < m)
            out[static_cast<long long>(a_base + row) * m + col] = gacc[ip][jn][e];
        }
  }
}

// -- host side ---------------------------------------------------------------

struct BPlan {
  int TN, col_tiles, smem;
  BParams p;
};

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The layout at column tile TN with the fewest blocks a cluster (C <= 8;
// nov_bf16: 1) whose G rows fit their registers and whose shared memory
// fits a block; false if none does.
template <int TN>
bool plan_at(int variant, int bs, int mv, int optin, BPlan* plan) {
  using W = Warps<TN>;
  constexpr int KC = Int8::kc<TN>();
  const int cap = cap_rows<TN>();
  const bool nov = variant == kNoVBf16;
  const int R = variant == kTileGram ? kTileRows : 1;
  const int c_lo = nov ? 1 : (mv + cap - 1) / cap;
  for (int C = c_lo; C <= (nov ? 1 : 8); ++C) {
    BParams& p = plan->p;
    p.C = C;
    p.MB = nov ? mv : round_up((mv + C - 1) / C, 16);
    p.RT = (bs + 15) / 16;
    p.PR = max(1, kWarps * W::AU / (TN / 8));
    p.XP = bstride(TN);
    p.YP = nov ? TN : bstride(TN);
    p.VP = bstride(p.MB);
    p.a_bytes = round_up(p.PR * 16 * Int8::row_bytes<KC>(), 16);
    const int rows_t = p.RT * 16;
    p.off_v = round_up(nov ? rows_t * p.YP * 4 : R * rows_t * p.YP * 2, 16);
    p.off_a = p.off_v + (nov ? 0 : round_up(R * rows_t * p.VP * 2, 16));
    p.off_x = p.off_a + kNA * p.a_bytes;
    plan->smem = p.off_x + kNA * KC * p.XP * 2;
    if (plan->smem > optin) continue;
    plan->TN = TN;
    return true;
  }
  return false;
}

// The widest column tile TN (m rounded up to 8, at most 128) that has a
// layout, narrower ones after it.
cudaError_t make_plan(int variant, int bs, int m, int mv, BPlan* plan) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int want = round_up(min(m, 128), 8);
  bool ok = false;
  if (!ok && want > 64) ok = plan_at<128>(variant, bs, mv, optin, plan);
  if (!ok && want > 32) ok = plan_at<64>(variant, bs, mv, optin, plan);
  if (!ok && want > 24) ok = plan_at<32>(variant, bs, mv, optin, plan);
  if (!ok && want > 16) ok = plan_at<24>(variant, bs, mv, optin, plan);
  if (!ok && want > 8) ok = plan_at<16>(variant, bs, mv, optin, plan);
  if (!ok) ok = plan_at<8>(variant, bs, mv, optin, plan);
  if (!ok) return cudaErrorInvalidValue;
  plan->col_tiles = (m + plan->TN - 1) / plan->TN;
  return cudaSuccess;
}

// Launch (or, with out, report the layout: n_groups, TN, C, MB, shared
// bytes, clusters resident), then the fixed-order sum of the partials.
template <int TN, int kVar>
cudaError_t run(const Int8& ld, BPlan plan, float* g, int* out,
                cudaStream_t stream) {
  auto kernel = bf16_gram_kernel<TN, kVar>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  BParams& p = plan.p;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (out != nullptr) {
    cfg.gridDim = dim3(p.C, 1, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    out[0] = max(1, min(p.nbr, clusters / plan.col_tiles));
    out[1] = TN;
    out[2] = p.C;
    out[3] = p.MB;
    out[4] = plan.smem;
    out[5] = clusters;
    return cudaSuccess;
  }
  if (p.n_groups < 1 || p.n_groups > p.nbr) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(p.n_groups * p.C, plan.col_tiles, 1);
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

template <int kVar>
cudaError_t by_width(const Int8& ld, const BPlan& plan, float* g, int* out,
                     cudaStream_t s) {
  switch (plan.TN) {
    case 8: return run<8, kVar>(ld, plan, g, out, s);
    case 16: return run<16, kVar>(ld, plan, g, out, s);
    case 24: return run<24, kVar>(ld, plan, g, out, s);
    case 32: return run<32, kVar>(ld, plan, g, out, s);
    case 64: return run<64, kVar>(ld, plan, g, out, s);
    default: return run<128, kVar>(ld, plan, g, out, s);
  }
}

int fused_bf16(const Int8& ld, const Bf16* x, const Bf16* v, long long ldv,
               float* partial, float* g, int nbr, int bs, int K, int bw, int m,
               int mv, int n_groups, int variant, int* out, void* stream) {
  if (nbr <= 0 || bs <= 0 || K <= 0 || m <= 0 || mv <= 0) return 0;
  if (variant < kRowGram || variant > kNoVBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((variant == kNoVBf16) != (v == nullptr) || (v == nullptr && mv != m))
    return static_cast<int>(cudaErrorInvalidValue);
  BPlan plan;
  cudaError_t err = make_plan(variant, bs, m, mv, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  BParams& p = plan.p;
  p.x = x;
  p.v = v;
  p.ldv = ldv;
  p.partial = partial;
  p.nbr = nbr;
  p.bs = bs;
  p.K = K;
  p.bw = bw;
  p.m = m;
  p.mv = mv;
  p.n_groups = n_groups;
  p.vec_x = fdt1::aligned16(x) && m % 8 == 0;
  p.vec_v = v != nullptr && fdt1::aligned16(v) && ldv % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kRowGram: err = by_width<kRowGram>(ld, plan, g, out, s); break;
    case kTileGram: err = by_width<kTileGram>(ld, plan, g, out, s); break;
    default: err = by_width<kNoVBf16>(ld, plan, g, out, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The layout of a call, into out[6], as fdt_fused_gram_plan reports it:
// row groups (the wrapper allocates n_groups * mv * m floats of scratch),
// TN, C, MB, dynamic shared memory a block, clusters resident. variant:
// 0 bf16deq, 1 tg_bf16deq, 2 nov_bf16 (mv = m).
int fdt_fused_bf16_plan(int variant, int nbr, int bs, int K, int m, int mv,
                        int* out) {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  const int8_t q = 0;
  const Bf16* v = variant == kNoVBf16 ? nullptr : reinterpret_cast<const Bf16*>(&q);
  return fused_bf16(Int8{nullptr, nullptr, nullptr}, nullptr, v, 0, nullptr,
                    nullptr, nbr, bs, K, 0, m, mv, 0, variant, out, nullptr);
}

// q, scale_rows, diag, x, v (null for nov_bf16), ldv, partial, g, nbr, bs,
// K, bw, m, mv, n_groups, variant, stream
int fdt_fused_q_gram_bf16(const int8_t* q, const float* scale,
                          const float* diag, const Bf16* x, const Bf16* v,
                          long long ldv, float* partial, float* g, int nbr,
                          int bs, int K, int bw, int m, int mv, int n_groups,
                          int variant, void* stream) {
  return fused_bf16(Int8{q, scale, diag}, x, v, ldv, partial, g, nbr, bs, K,
                    bw, m, mv, n_groups, variant, nullptr, stream);
}

}  // extern "C"
