// The fused banded SpMM + Gram on Hopper (sm_90a) in bf16 and float64, on
// dense or int8 blocks: one template, instantiated for kernel 3's bf16 and
// float64 entries (fused_gram_bf16.cu, fused_gram_f64.cu) and for kernel
// 5's int8 entries with float64 x (fused_gram_q8f64.cu) and with bf16 x
// (fused_gram_q8bf16.cu, the bf16-dequant variants). Storage as in
// fused_apply.cuh: (nbr, bs, K*bs) row-major block slabs, slot k of block
// row r holding block column r - bw + k.
//
// They replace banded_bsr_spmm_gram (fortran_davidson_tpu/ops/
// pallas_kernels.py:592, body _banded_gram_kernel :513) for bf16 and
// float64 storage, and banded_q_bsr_spmm_gram (pallas_kernels.py:886) for
// float64 x and experiments/fused_probe.py's bf16-dequant modes (:170,
// :191): Y = A @ X and G = V^T Y in one sweep over the blocks, with the
// TPU kernels' types:
// - bf16 (TBf16): blocks, x and v bf16; Y summed in f32 (written as f32);
//   the gram on bf16(Y) (the TPU kernel's ybuf has v's type), G summed in
//   f32;
// - float64 (TF64): blocks, x, v, Y and G's sums f64; G rounded to f32
//   once, when the partials are summed;
// - int8 with float64 x (TQ8F64): each int8 entry times its lane's f32
//   scale in f32, widened to f64; the band summed in f64 on DMMA in kernel
//   4's order, rounded to f32, d o x added in f32, Y in f64 (the plain
//   version's arithmetic, and kernel 4's float64-x Y bit for bit,
//   q_spmm_f64.cu); G as for float64;
// - int8 with bf16 x (TQ8Bf16): the blocks bf16(bf16(q) * bf16(s)), times
//   the bf16 x window with f32 sums, plus d o x in f32; the gram as for
//   bf16. Variants: the full kernel (bf16deq); kTileT (tg_bf16deq), the
//   same function with the gram's pass spanning two ring tiles (depth
//   2 * bs) before it frees them; kNoVT (nov_bf16), no V, G's row 0 the f32
//   column sums of Y, the other rows zero.
// v may be null (G = X^T A X, x itself the gram operand), y may be null
// (write_out=False). G is (mv, m) float32.
//
// What bounds them on the H100:
// - bf16 at the fused engine's widest call (n = 2^20, bs = 128, bw = 1,
//   m = 128, mv = 1408): 4.6 GB moved (V 2.95 GB of it), 1.36 ms at 3.35
//   TB/s; the products, 4.8e11 flops, take 0.5 ms on the bf16 tensor
//   cores. Bytes.
// - float64 there: 4.8e11 flops (the gram 3.8e11 of them), 7.2 ms at
//   DMMA's 67 TFLOP/s; V is 11.5 GB, 3.4 ms a read. Operations.
// - int8 with float64 x at the lowest-20 solve's call (n = 2,097,152,
//   bs = 128, bw = 1, m = 20, mv = 220): the slab 0.81 GB, x and Y 0.34 GB
//   each, V 3.69 GB: 1.55 ms at 3.35 TB/s; ~5e10 f64 flops, 0.75 ms on
//   DMMA. Bytes, V most of them: V is read once where one column tile
//   covers m (TN = 24 at m = 20). The slab is a quarter of float32's and
//   an eighth of float64's bytes; its entries are widened in registers as
//   the A fragments are formed, never stored wider.
// - int8 with bf16 x at the probe's shape (n = 524,288, bs = 128, bw = 2,
//   m = mv = 256): the slab 0.34 GB, x and V 0.27 GB each, ~0.87 GB, 0.26
//   ms; 2.4e11 bf16 flops, 0.24 ms. Bytes, closely followed by operations;
//   the dequantization (an integer and an f32 add per byte, a bf16 multiply
//   per pair) runs on the CUDA cores beside the tensor cores.
//
// The design is fused_gram.cu's cluster, with Hopper's copy engine and
// two roles a block:
// - A thread-block cluster of C blocks walks a contiguous range of block
//   rows. Block c owns rows [c*MB, (c+1)*MB) of G at a column tile of TN,
//   in the registers of its gram role for the whole walk: eight warps
//   WM x WN, each MT m-tiles by NT n8-tiles (m16 tiles of mma.sync
//   m16n8k16 for bf16, m8 tiles of DMMA m8n8k4 for f64), every V fragment
//   reused across the warp's n-tiles and every Y fragment across its
//   m-tiles.
// - A block's apply role (four warps) computes its rows of each block
//   row's (bs, TN) tile of Y, in units of 16 rows by AU n8-tiles, 4 * UW
//   units a pass (UW a warp), the passes dealt round the cluster; it
//   writes them to HBM (when y is given) and into the block's copy of the
//   tile (bf16(Y) for bf16; rows past bs as zeros), and the copy engine
//   sends those rows to every other member (bulk shared-to-shared copies
//   that complete on the member's tile barrier). The tiles are a ring of
//   kTiles: the apply role runs up to kTiles - 1 block rows ahead of the
//   gram role, and writes a tile again only once every member's gram role
//   has arrived on its empty barrier. No cluster-wide barrier a row.
// - The apply streams the slab chunks and x chunks of the block row's
//   in-range slots through a ring of NA stages; the gram streams V through
//   a ring of NS stages of VS rows. Each stage is one box of the copy
//   engine (TMA; the slab as a 3-D map, so columns past its slot load as
//   zeros), issued by one thread, where the shapes allow; else the role's
//   threads' cp.async. B fragments of x by ldmatrix.trans (bf16) or by
//   direct loads (f64), two sets of apply sums (even and odd k-steps; one
//   for int8 with f64 x, kernel 4's order), A fragments of V^T by
//   ldmatrix.trans (bf16) or by direct loads (f64). V is read once where
//   one column tile covers m.
// - The int8 slab: a stage holds the chunk's bytes (rows of SA bytes) and
//   its KC f32 scales (a box of the copy engine, or the threads'
//   cp.async). An int8 type's unit spans up to kMaxAU n8-tiles of the
//   column tile (16 rows by 32 columns for f64 x, 64 for bf16; TN = 24 at
//   m = 20), one or two a warp, so that a pass covers 64 or 128 rows and a
//   lane dequantizes each of its A values once for the unit's columns: for
//   f64 x kernel 4's (16-byte loads of its row, each byte a float by an
//   integer and an f32 add, times its column's scale in f32, widened; the
//   products on DMMA m16n8k4); for bf16 x two bytes a register, times the
//   bf16-rounded scales by one bf16 multiply (exact products, one
//   rounding). One chain of sums; the apply role keeps 152 registers (a
//   unit's sums), the gram role 176. Where the slab, x and the scales all
//   come by the copy engine, a stage's one arrival is the producer's. The
//   diagonal's d o x is added as the units are written, d and x's centre
//   rows read from global memory (L2).
// - Each ring stage has an mbarrier on which the copies land (the engine's
//   bytes, the threads' cp.async.mbarrier.arrive); a role frees a stage
//   with its own named barrier after a proxy fence in every reader.
// - bf16 sums: the f32 accumulation of mma.sync does not round to nearest,
//   so every kFlush block rows the registers are added into the cluster's
//   partial (a rounded f32 add) and restart, as fused_gram.cu does. DMMA
//   rounds each step: the f64 registers are written once, at the end.
// - Partials: one (mv, m) a cluster, summed by reduce_partials in a fixed
//   order: the same inputs give the same bits. The int8 entries' kNoVT
//   column sums: each thread's running sums of its columns, then the
//   lanes, the units and the cluster's members in a fixed order, into the
//   partial's row 0.
// - Edge windows: a slot whose block column lies outside [0, nbr) is
//   skipped (its block is zero), so no x row outside [0, n) is read; rows
//   and columns past the tensors' edges load as zeros; what a box reads
//   past a chunk (x rows past its depth, V columns past MB) is never used
//   or meets zeros.
// - A width no layout holds (G rows past the cluster's registers, or the
//   rings past shared memory) returns cudaErrorInvalidValue; the wrapper
//   raises.
//
// A cluster holds at most kMaxCluster blocks (the portable size). The
// plan takes the widest
// column tile (m rounded up to 8, at most 128) whose layout fits, at that
// tile the fewest blocks a cluster whose G rows fit the registers and
// whose apply passes split evenly across the cluster, and the deepest
// apply ring (NA, at least 3 stages) that shared memory holds beside the
// tiles and the V ring. At row 3's shape bf16 takes TN = 128, C = 8;
// float64 TN = 64, C = 8: its G (1.44 MB) needs two column tiles, so V is
// read twice (at TN = 128 a pass of float64 would cover half the tile's
// width, and a cluster of 8 would not hold G).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#include "banded_spmm.cuh"
#include "fused_apply.cuh"

namespace cg = cooperative_groups;

namespace {

using fdt1::Bf16;

// The block's two roles: kApplyThreads (four warps) compute the Y tiles,
// kGramThreads (eight warps, G's holders) the gram; one block of
// kRoleThreads an SM.
constexpr int kApplyThreads = 128;
constexpr int kGramThreads = 256;
constexpr int kRoleThreads = kApplyThreads + kGramThreads;

// A barrier of one role's threads alone (named barrier id: 1 apply, 2
// gram).
__device__ __forceinline__ void role_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row stride (elements) of a bf16 [row][col] tile read by ldmatrix (cols a
// multiple of 8): rows 16-byte aligned, an odd number of 16-byte units
// apart, so the eight rows of a matrix lie on distinct banks.
__host__ __device__ constexpr int bf16_stride(int cols) {
  return ((cols + 8) / 8) % 2 == 1 ? cols + 8 : cols + 16;
}

// Row stride (doubles) of an f64 tile read as DMMA fragments at (row t,
// column g): 4 (mod 16) puts the 16 lanes of a half warp on 16 banks.
__host__ __device__ constexpr int f64_stride(int cols) {
  return cols + ((4 - cols % 16) + 16) % 16;
}

// The types. T: x's, v's and the Y tile's element; S: the slab's; kQ: an
// int8 slab (scales and the diagonal beside it). kTiles: Y tiles in flight
// (the apply role runs up to kTiles - 1 block rows ahead of the gram
// role); KC, NA: apply depth a chunk and the apply ring's stages
// (deep enough that the chunks in flight cover L2's latency); VS, NS: V
// rows a ring stage and stages; MTR: rows of a gram m-tile (m16n8k16, DMMA m8n8k4); E: the
// accumulators a thread holds per gram tile; SA: row stride of a staged slab chunk
// (kernel 1's, conflict-free for its A fragments); kFlush: block rows
// between partial flushes (0: one write at the end).
struct TBf16 {
  using T = Bf16;
  using S = Bf16;
  static constexpr bool kQ = false;
  using Acc = float;
  static constexpr int KC = 64;
  static constexpr int VS = 32;
  static constexpr int NS = 4;
  static constexpr int NA = 4;
  static constexpr int kTiles = 3;
  static constexpr int MTR = 16;
  static constexpr int E = 4;
  static constexpr int SA = KC + 8;
  static constexpr int kFlush = 8;
  __host__ __device__ static constexpr int stride(int cols) {
    return bf16_stride(cols);
  }
};
struct TF64 {
  using T = double;
  using S = double;
  static constexpr bool kQ = false;
  using Acc = double;
  static constexpr int KC = 16;
  static constexpr int VS = 8;
  static constexpr int NS = 4;
  static constexpr int NA = 4;
  static constexpr int kTiles = 2;
  static constexpr int MTR = 8;
  static constexpr int E = 2;
  static constexpr int SA = KC + 4;
  static constexpr int kFlush = 0;
  __host__ __device__ static constexpr int stride(int cols) {
    return f64_stride(cols);
  }
};
// The int8 slabs, on the dense types' gram layouts. Their apply units span
// up to kMaxAU n8-tiles of the column tile (Lay), so a chunk's A
// fragments are dequantized once for all of a unit's columns; kAccUnits:
// the apply sums a thread holds, in units of 16 x 8 tiles (UW * AU at
// most: 32 doubles or 64 floats). Deeper chunks for f64 x (64: each
// chunk's fixed cost, its barrier, the named barrier and the issue, over
// four times the products); for bf16 x a deeper apply ring where shared
// memory holds it. SA in bytes: for f64 x the unpadded rows (four 16-byte
// runs of kernel 4's bytes); for bf16 x 80 (20 words: the two-byte loads
// of rows g = 0..7 fall on distinct banks).
struct TQ8F64 : TF64 {
  using S = int8_t;
  static constexpr bool kQ = true;
  static constexpr int KC = 64;
  static constexpr int kMaxAU = 4;
  static constexpr int kAccUnits = 8;
  static constexpr int SA = KC;
};
struct TQ8Bf16 : TBf16 {
  using S = int8_t;
  static constexpr bool kQ = true;
  static constexpr int kMaxAU = 8;
  static constexpr int kAccUnits = 16;
  static constexpr int NA = 8;
  static constexpr int SA = KC + 16;
};

// The layout at column tile TN. Gram: WN warps along N with NT n8-tiles
// each, WM = 8 / WN along M with MT m-tiles each (warp wm takes m-tiles wm,
// wm + WM, ...). Apply: a unit is 16 rows by AU n8-tiles (the int8
// types: the whole tile, AU = TN / 8); NG units a row tile; a pass is
// UP = 4 * UW consecutive units (UW a warp: 2, or for the int8 types as
// many as kAccUnits allows, at most 2), which span PR row tiles and XW
// columns of x.
template <class M, int TN>
constexpr int unit_tiles() {
  if constexpr (M::kQ) {
    return TN / 8 < M::kMaxAU ? TN / 8 : M::kMaxAU;
  } else {
    return !(M::MTR == 8) && TN == 128 ? 2 : 1;
  }
}
template <class M>
constexpr int units_a_warp(int au) {
  if constexpr (M::kQ) {
    return M::kAccUnits / au >= 2 ? 2 : 1;
  } else {
    return 2;
  }
}

template <class M, int TN>
struct Lay {
  static constexpr bool kF64 = M::MTR == 8;
  static constexpr int WN = TN >= 128 ? 4 : TN == 64 ? 2 : 1;
  static constexpr int NT = TN / 8 / WN;
  static constexpr int WM = kWarps / WN;
  static constexpr int MT = kF64 ? (TN == 8 ? 16 : TN == 16 ? 12 : 6)
                                 : (TN == 8 ? 12 : TN == 16 ? 8
                                    : TN == 128 ? 6 : 5);
  static constexpr int AU = unit_tiles<M, TN>();
  static constexpr int UW = units_a_warp<M>(AU);
  static constexpr int NG = TN / 8 / AU;
  static constexpr int UP = 4 * UW;
  static constexpr int XW = NG >= UP ? UP * AU * 8 : TN;
  static constexpr int PR = NG >= UP ? 1 : UP / NG;
  static constexpr int cap = WM * MT * M::MTR;  // G rows a block holds
};

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.0f);
}

// The int8 slab's tables: scale[r, l], block row r's f32 scale over lane
// l ((nbr, K*bs)), and the exact f32 diagonal diag[r*bs + i]; none for a
// dense slab (an empty base).
template <bool kQ>
struct QTables {};
template <>
struct QTables<true> {
  const float* scale;
  const float* diag;
  int off_cs;  // kNoVT's column sums: [5][TN] sums (4 warps', the block's)
  // The scales by the copy engine ((nbr, K*bs), boxes of KC of a row);
  // with the slab's and x's a stage's one arrival is thread 0's.
  int tma_s;
  CUtensorMap map_s;
};

template <class M>
struct TParams : QTables<M::kQ> {
  using T = typename M::T;
  using Acc = typename M::Acc;
  const typename M::S* blocks;
  const T* x;
  const T* v;  // the gram operand (x itself for G = X^T A X)
  long long ldv;
  Acc* y;        // nullable
  Acc* partial;  // (n_groups, mv, m)
  int nbr, bs, K, bw, m, mv;
  int C, MB, n_groups;  // cluster size, G rows a block, row groups
  int RT, Q;            // 16-row tiles of a block row; passes a block row
  int YP, VP, XP;       // row strides of the Y tile, V stages, x chunks
  int ys_rows;          // rows of the Y tile: RT * 16 rounded up to VS
  int off_v, off_a, off_x, off_bar, a_bytes;  // dynamic shared memory layout
  int vec_a, vec_x, vec_v;           // 16-byte copies allowed
  int NA;                            // apply ring stages (<= M::NA)
  int variant;                       // TVariant
  // The copy engine's maps of x ((n, m), boxes of KC rows by XP columns),
  // of V ((n, mv), VS rows by VP columns) and of the slab ((rows, K, bs),
  // boxes of PR * 16 rows of one slot by SA columns: the columns past bs
  // load as zeros), where the shapes allow (tma_x, tma_v, tma_a); else the
  // threads stage them by cp.async.
  int tma_x, tma_v, tma_a;
  CUtensorMap map_x, map_v, map_a;
};

// The full kernel and two measurement variants, fused_gram.cu's (a
// run-time switch): kNoGramT streams V through the ring but skips the
// gram's products; kNoVT reads no V (the int8 entries: G's row 0 the
// column sums of Y). kTileT (int8 entries): the full kernel's function,
// the gram's pass spanning two ring tiles.
enum TVariant { kFullT = 0, kNoGramT = 1, kNoVT = 2, kTileT = 3 };

// Copy the 16 bytes at s to d, `valid` elements of them readable (the
// rest zeros): one 16-byte copy where vec allows and the run is whole,
// element copies otherwise (bf16 synchronously).
template <typename T>
__device__ __forceinline__ void copy16(T* d, const T* s, int valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (valid <= 0) {
    *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
  } else if (vec && valid >= V) {
    cp16(d, s);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < valid) {
        if constexpr (sizeof(T) == 8) {
          fdt1::cp_async<8>(d + j, s + j, true);
        } else {
          d[j] = s[j];
        }
      } else {
        d[j] = zero<T>();
      }
    }
  }
}

// Stage ROWS x COLS elements (COLS a multiple of 16 bytes, DP the row
// stride of dst) from src (row stride ld): element (i, c) is src[i * ld +
// c] for i < vrows and c < vcols, else zero (not read). The shape is the
// kernel's, so the walk has no division.
template <typename T, int ROWS, int COLS, int DP, int NTHR>
__device__ __forceinline__ void stage_fixed(T* dst, const T* src, long long ld,
                                            int vrows, int vcols, bool vec,
                                            int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CQ = COLS / V;
#pragma unroll
  for (int e = tid; e < ROWS * CQ; e += NTHR) {
    const int i = e / CQ;
    const int c = (e % CQ) * V;
    copy16(dst + i * DP + c, src + i * ld + c, i < vrows ? vcols - c : 0,
           vec);
  }
}

// A thread's walk over the 16-byte chunks of a rows x cols tile (cols a
// run-time width): chunk e = tid + k * nthr is (row i, column c), stepped
// without division.
struct Walk {
  int cq, di, dc, i0, c0;
  __device__ __forceinline__ Walk(int cq_, int tid, int nthr)
      : cq(cq_), di(nthr / cq_), dc(nthr % cq_), i0(tid / cq_),
        c0(tid % cq_) {}
};

// Stage rows x (w.cq chunks) elements as stage_fixed does, with the walk.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dp, const T* src,
                                      long long ld, int rows, const Walk& w,
                                      int vrows, int vcols, bool vec) {
  constexpr int V = 16 / sizeof(T);
  int c = w.c0;
  for (int i = w.i0; i < rows;) {
    copy16(dst + i * dp + c * V, src + i * ld + c * V,
           i < vrows ? vcols - c * V : 0, vec);
    i += w.di;
    c += w.dc;
    if (c >= w.cq) {
      c -= w.cq;
      ++i;
    }
  }
}

// The rings' completion: one mbarrier a stage, initialised to the block's
// threads; each thread's copies into the stage arrive on it when they land
// (cp.async.mbarrier.arrive.noinc), so a stage waits on its own copies and
// older ones, never on a later stage's.
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();  // a stage that never lands
  }
}

// Thread 0's arrival on a stage barrier that also expects `bytes` from the
// copy engine, and one 2-D box of `map` at (column c0, row c1) into dst.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// Arrivals on every member's barrier at bar's offset: one release fence
// at cluster scope for this block's earlier accesses, then relaxed
// arrivals (a release on each of them was slow, one per member a row).
__device__ __forceinline__ void arrive_members(uint32_t bar, int C) {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  for (int q = 0; q < C; ++q) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r)
                 : "r"(bar), "r"(q));
    asm volatile(
        "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
            r)
        : "memory");
  }
}
// Wait for a phase of a barrier that other members arrive on.
__device__ __forceinline__ void bar_wait_cluster(uint32_t bar,
                                                 uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();  // a phase that never ends
  }
}
// One 3-D box of `map` at (c0, c1, c2) into dst.
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16) from this block's shared
// memory at src to member `rank`'s at the same offset, completing that
// many bytes of the member's barrier at the offset of `bar`; the copies a
// thread issues are one group (bulk_wait_read waits until the engine has
// read their sources).
__device__ __forceinline__ void bulk_to_member(const void* src, uint32_t bar,
                                               uint32_t bytes, int rank) {
  uint32_t dst_r, bar_r;
  const uint32_t s = smem_u32(src);
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst_r)
               : "r"(s), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(bar_r)
               : "r"(bar), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst_r),
      "r"(s), "r"(bytes), "r"(bar_r)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Order this thread's reads of shared memory before the copy engine's
// later writes to it (another proxy's): every reader, before a stage is
// freed.
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += a b, DMMA m8n8k4 and mma.sync m16n8k16 (bf16, f32 sums), without
// kernel 1's volatile, so that the compiler may hoist the next fragments'
// loads above them.
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}
// d += a b on DMMA m16n8k4 (sm_90): rows g and g + 8 of two m8n8k4 in one
// instruction, the same products and sums (kernel 4's bits).
__device__ __forceinline__ void dmma16(double (&c)[4], double a0, double a1,
                                       double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}
__device__ __forceinline__ void bmma(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The apply's chunks of one pass: chunk it (slot klo + it / cps, depth
// (it % cps) * KC) of block row rr, the pass's PR row tiles staged from
// slab row i0 on and x's columns from xc0 on. The ring's chunks are
// numbered across passes and rows: chunk it of this pass is number
// base + it, in ring stage (base + it) % NA (as: NA stages of a_bytes;
// xs: NA stages of KC rows of XP elements; bars: their mbarriers), whose
// barrier completes its ((base + it) / NA)-th phase when it lands. The
// apply role's threads issue them: the copy engine's boxes by its thread
// 0, or every thread's cp.async.
template <class M, int TN>
struct Chunks {
  const TParams<M>& p;
  long long rr;
  int i0, xc0, klo, n_chunks, base;
  unsigned char* as;
  typename M::T* xs;
  uint32_t bars;
  // Chunk it into ring stage b.
  __device__ __forceinline__ void issue(int it, int b) const {
    using T = typename M::T;
    using S = typename M::S;
    using L = Lay<M, TN>;
    constexpr int KC = M::KC;
    constexpr int XP = M::stride(L::XW);
    if (it >= n_chunks) return;
    const int tid = threadIdx.x;
    const int bs = p.bs;
    const long long ldl = static_cast<long long>(p.K) * bs;
    const int cps = (bs + KC - 1) / KC;
    const int k = klo + it / cps;
    const int d0 = (it - (it / cps) * cps) * KC;
    const int kc = min(KC, bs - d0);
    S* ad = reinterpret_cast<S*>(as + b * p.a_bytes);
    const long long xr = (rr - p.bw + k) * bs + d0;
    T* xd = xs + b * KC * XP;
    const uint32_t bar = bars + 8 * b;
    // The int8 slab's KC scales follow its rows (zeros past its depth).
    float* sd = reinterpret_cast<float*>(ad + L::PR * 16 * M::SA);
    if (tid == 0) {
      // Rows past kc and columns past XW of x are read and never used: the
      // slab's columns past kc are zeros, and no fragment reads past XW.
      // The slab's rows past bs feed Y's rows past bs, which are zeroed.
      uint32_t bytes = (p.tma_a ? L::PR * 16 * M::SA * sizeof(S) : 0) +
                       (p.tma_x ? KC * XP * sizeof(T) : 0);
      if constexpr (M::kQ) bytes += p.tma_s ? KC * 4 : 0;
      bar_expect(bar, bytes);
      if (p.tma_a)
        tma_box3(ad, &p.map_a, d0, k, static_cast<int>(rr * bs + i0), bar);
      if (p.tma_x) tma_box(xd, &p.map_x, xc0, static_cast<int>(xr), bar);
      if constexpr (M::kQ) {
        // Scales past the slot's lanes meet the slab's zeros.
        if (p.tma_s)
          tma_box(sd, &p.map_s, k * bs + d0, static_cast<int>(rr), bar);
      }
    }
    if (!p.tma_a)
      stage_fixed<S, L::PR * 16, KC, M::SA, kApplyThreads>(
          ad, p.blocks + (rr * bs + i0) * ldl + k * bs + d0, ldl, bs - i0, kc,
          p.vec_a != 0, tid);
    if (!p.tma_x)
      stage_fixed<T, KC, L::XW, XP, kApplyThreads>(
          xd, p.x + xr * p.m + xc0, p.m, kc, p.m - xc0, p.vec_x != 0, tid);
    if constexpr (M::kQ) {
      if (!p.tma_s) {
        const float* sc = p.scale + rr * ldl + k * bs + d0;
        for (int e = tid; e < KC; e += kApplyThreads)
          fdt1::cp_async<4>(sd + e, e < kc ? sc + e : p.scale, e < kc);
      }
      if (p.tma_a && p.tma_x && p.tma_s) return;  // no thread's copies
    }
    bar_arrive_copies(bar);
  }
  // The pass's first NA - 1 chunks (the caller has freed their stages).
  __device__ __forceinline__ void prime() const {
    int b = base % p.NA;
    for (int it = 0; it < p.NA - 1; ++it) {
      issue(it, b);
      b = b + 1 == p.NA ? 0 : b + 1;
    }
  }
};

// Two int8 entries (the low two bytes of w) as bf16(bf16(q) * s), packed
// as an mma operand (the first in the low half): q is exact in bf16, the
// product of two bf16 values is rounded once.
__device__ __forceinline__ uint32_t deq_pair(uint32_t w,
                                             __nv_bfloat162 s) {
  w ^= 0x8080u;
  const __nv_bfloat162 d = __hmul2(
      __floats2bfloat162_rn(fdt1::biased_s8(w, 0x7440u),
                            fdt1::biased_s8(w, 0x7441u)),
      s);
  return *reinterpret_cast<const uint32_t*>(&d);
}

// The products of one int8 slab chunk (ab: its rows of SA bytes, then its
// KC f32 scales; xb: its x chunk) for the units of a pass, as apply_pass
// takes them. A unit spans the column tile, so a lane forms its A values
// of the chunk once and applies them to all AU n8-tiles; one chain of sums.
// - f64 x: kernel 4's A values and order (stage_product<QInt8>,
//   banded_spmm.cuh): a lane's row of the chunk in 16-byte loads, each
//   byte times its column's scale in f32, widened; the k-steps in order on
//   DMMA m16n8k4 (kernel 4's two m8n8k4 in one instruction), so that Y is
//   kernel 4's bit for bit.
// - bf16 x: a lane's two-byte pairs (columns 2t, 2t + 1 and 2t + 8, 2t + 9
//   of a k-step) times the bf16-rounded scales; each B fragment serves
//   the warp's units.
template <class M, int TN>
__device__ __forceinline__ void q_product(
    const unsigned char* ab, const typename M::T* xb,
    const int (&lt)[Lay<M, TN>::UW], const int (&nt0)[Lay<M, TN>::UW],
    int nu, typename M::Acc (&acc)[Lay<M, TN>::UW][Lay<M, TN>::AU][4]) {
  using L = Lay<M, TN>;
  constexpr int KC = M::KC;
  constexpr int SA = M::SA;
  constexpr int AU = L::AU;
  constexpr int XP = M::stride(L::XW);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* sc = reinterpret_cast<const float*>(ab + L::PR * 16 * SA);
  if constexpr (L::kF64) {
    static_assert(KC % 16 == 0 && SA == KC, "16-byte runs of slab rows");
    const uint32_t sel = 0x7440u | static_cast<uint32_t>(t);
    float s[KC / 4];
#pragma unroll
    for (int ks = 0; ks < KC / 4; ++ks) s[ks] = sc[ks * 4 + t];
#pragma unroll
    for (int i = 0; i < L::UW; ++i) {
      if (i >= nu) break;
      double a[2][KC / 4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int q = 0; q < KC / 16; ++q) {
          const uint4 w = *reinterpret_cast<const uint4*>(
              ab + (lt[i] * 16 + mt * 8 + g) * SA + 16 * q);
          const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                     w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[mt][4 * q + j] = static_cast<double>(
                __fmul_rn(fdt1::biased_s8(words[j], sel), s[4 * q + j]));
        }
      }
#pragma unroll
      for (int ks = 0; ks < KC / 4; ++ks) {
#pragma unroll
        for (int u = 0; u < AU; ++u)
          dmma16(acc[i][u], a[0][ks], a[1][ks],
                 xb[(ks * 4 + t) * XP + (nt0[i] + u) * 8 + g]);
      }
    }
  } else {
    static_assert(4 % L::NG == 0, "a warp's units share one column group");
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const __nv_bfloat162 s_lo = __float22bfloat162_rn(
          *reinterpret_cast<const float2*>(sc + ks * 16 + 2 * t));
      const __nv_bfloat162 s_hi = __float22bfloat162_rn(
          *reinterpret_cast<const float2*>(sc + ks * 16 + 8 + 2 * t));
      uint32_t af[L::UW][4];
#pragma unroll
      for (int i = 0; i < L::UW; ++i) {
        if (i >= nu) break;
        const unsigned char* lo = ab + (lt[i] * 16 + g) * SA + ks * 16 + 2 * t;
        const unsigned char* hi = lo + 8 * SA;
        af[i][0] = deq_pair(*reinterpret_cast<const uint16_t*>(lo), s_lo);
        af[i][1] = deq_pair(*reinterpret_cast<const uint16_t*>(hi), s_lo);
        af[i][2] = deq_pair(*reinterpret_cast<const uint16_t*>(lo + 8), s_hi);
        af[i][3] = deq_pair(*reinterpret_cast<const uint16_t*>(hi + 8), s_hi);
      }
      const Bf16* xrow = xb + (ks * 16 + (lane & 15)) * XP;
#pragma unroll
      for (int u = 0; u < AU; ++u) {
        uint32_t b0, b1;
        fdt1::b_frag(xrow + (nt0[0] + u) * 8, b0, b1);
#pragma unroll
        for (int i = 0; i < L::UW; ++i) {
          if (i >= nu) break;
          bmma(acc[i][u], af[i], b0, b1);
        }
      }
    }
  }
}

// One pass of the apply over primed chunks, by the apply role: its warp w
// computes units w, w + 4, ... (UW of them) of the pass (local row tiles
// lt[i], local n8-tiles nt0[i] .. nt0[i] + AU - 1; nu of them). acc[i][a]
// is kernel 1's layout: [0..1] row g, [2..3] row g + 8, columns 2t, 2t + 1
// of n8-tile nt0[i] + a. Dense slabs: two sets of sums, even and odd
// k-steps, so that product chains interleave; added in a fixed order at
// the end.
template <class M, int TN>
__device__ __forceinline__ void apply_pass(
    const Chunks<M, TN>& ch, const int (&lt)[Lay<M, TN>::UW],
    const int (&nt0)[Lay<M, TN>::UW], int nu,
    typename M::Acc (&acc)[Lay<M, TN>::UW][Lay<M, TN>::AU][4]) {
  using T = typename M::T;
  using Acc = typename M::Acc;
  using L = Lay<M, TN>;
  constexpr int KC = M::KC;
  constexpr int AU = L::AU;
  constexpr int SA = M::SA;
  constexpr int XP = M::stride(L::XW);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int NA = ch.p.NA;
  Acc odd[L::UW][AU][4];
#pragma unroll
  for (int i = 0; i < L::UW; ++i)
#pragma unroll
    for (int a = 0; a < AU; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][a][e] = odd[i][a][e] = Acc(0);

  // Chunk it's stage and phase parity, stepped without division.
  int b = ch.base % NA;
  uint32_t parity = (ch.base / NA) & 1;
  for (int it = 0; it < ch.n_chunks; ++it) {
    bar_wait(ch.bars + 8 * b, parity);
    fence_proxy();                        // reads of chunk it - 1 are done
    role_sync(1, kApplyThreads);          // chunk it - 1's stage is free
    ch.issue(it + NA - 1, b == 0 ? NA - 1 : b - 1);
    const T* ab = reinterpret_cast<const T*>(ch.as + b * ch.p.a_bytes);
    const T* xb = ch.xs + b * KC * XP;
    if (++b == NA) {
      b = 0;
      parity ^= 1;
    }
    if constexpr (M::kQ) {
      q_product<M, TN>(reinterpret_cast<const unsigned char*>(ab), xb, lt,
                       nt0, nu, acc);
    } else {
#pragma unroll
      for (int i = 0; i < L::UW; ++i) {
        if (i >= nu) break;
        if constexpr (L::kF64) {
          // DMMA m8n8k4: A (rows g, g + 8; k t), B (k t; column g).
#pragma unroll
          for (int ks = 0; ks < KC / 4; ++ks) {
            const double a0 = ab[(lt[i] * 16 + g) * SA + ks * 4 + t];
            const double a1 = ab[(lt[i] * 16 + 8 + g) * SA + ks * 4 + t];
#pragma unroll
            for (int a = 0; a < AU; ++a) {
              const double bx = xb[(ks * 4 + t) * XP + (nt0[i] + a) * 8 + g];
              double (&c)[4] = ks % 2 ? odd[i][a] : acc[i][a];
              dmma(c[0], c[1], a0, bx);
              dmma(c[2], c[3], a1, bx);
            }
          }
        } else {
          // mma.sync m16n8k16: A by 32-bit loads (kernel 1's), B by
          // ldmatrix.trans.
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) {
            const Bf16* a_lo = ab + (lt[i] * 16 + g) * SA + ks * 16 + 2 * t;
            const Bf16* a_hi = a_lo + 8 * SA;
            const uint32_t af[4] = {
                *reinterpret_cast<const uint32_t*>(a_lo),
                *reinterpret_cast<const uint32_t*>(a_hi),
                *reinterpret_cast<const uint32_t*>(a_lo + 8),
                *reinterpret_cast<const uint32_t*>(a_hi + 8)};
            const Bf16* xrow = xb + (ks * 16 + (lane & 15)) * XP;
#pragma unroll
            for (int a = 0; a < AU; ++a) {
              uint32_t b0, b1;
              fdt1::b_frag(xrow + (nt0[i] + a) * 8, b0, b1);
              bmma(ks % 2 ? odd[i][a] : acc[i][a], af, b0, b1);
            }
          }
        }
      }
    }
  }
  if constexpr (!M::kQ) {  // (q_product: one chain)
#pragma unroll
    for (int i = 0; i < L::UW; ++i)
#pragma unroll
      for (int a = 0; a < AU; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][a][e] += odd[i][a][e];
  }
}

__device__ __forceinline__ void ldsm_x4_trans(const Bf16* p, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// gacc += V[stage rows, this block's G rows]^T @ Y[stage rows, :] for one
// ring stage (vb: VS rows of VP; yb: the Y tile's rows of the stage, YP).
// Rows of V past mbv are skipped a whole m-tile at a time (their staged
// columns are zeros).
template <class M, int TN>
__device__ __forceinline__ void gram_stage(
    const typename M::T* vb, const typename M::T* yb, int VP, int YP, int wm,
    int wn, int mbv,
    typename M::Acc (&gacc)[Lay<M, TN>::MT][Lay<M, TN>::NT][M::E]) {
  using L = Lay<M, TN>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  if constexpr (L::kF64) {
#pragma unroll
    for (int ks = 0; ks < M::VS / 4; ++ks) {
      double b[L::NT];
#pragma unroll
      for (int jn = 0; jn < L::NT; ++jn)
        b[jn] = yb[(ks * 4 + t) * YP + (wn * L::NT + jn) * 8 + g];
#pragma unroll
      for (int ip = 0; ip < L::MT; ++ip) {
        const int mt = wm + ip * L::WM;
        if (mt * 8 >= mbv) break;
        const double a = vb[(ks * 4 + t) * VP + mt * 8 + g];
#pragma unroll
        for (int jn = 0; jn < L::NT; ++jn)
          dmma(gacc[ip][jn][0], gacc[ip][jn][1], a, b[jn]);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < M::VS / 16; ++ks) {
      uint32_t b[L::NT][2];
#pragma unroll
      for (int jn = 0; jn < L::NT; ++jn)
        fdt1::b_frag(yb + (ks * 16 + (lane & 15)) * YP + (wn * L::NT + jn) * 8,
                     b[jn][0], b[jn][1]);
#pragma unroll
      for (int ip = 0; ip < L::MT; ++ip) {
        const int mt = wm + ip * L::WM;
        if (mt * 16 >= mbv) break;
        uint32_t a[4];
        ldsm_x4_trans(vb + (ks * 16 + (lane & 7) + 8 * (lane >> 4)) * VP +
                          mt * 16 + 8 * ((lane >> 3) & 1),
                      a);
#pragma unroll
        for (int jn = 0; jn < L::NT; ++jn)
          bmma(gacc[ip][jn], a, b[jn][0], b[jn][1]);
      }
    }
  }
}

// Add the registers into this block's slice of the cluster's partial
// (first: write them) and restart them. Two m-tiles' loads before their
// stores: MT / 2 round trips.
template <class M, int TN>
__device__ __forceinline__ void flush(
    typename M::Acc* out, bool first, int wm, int wn, int a_base, int mbv,
    int c0, int m,
    typename M::Acc (&gacc)[Lay<M, TN>::MT][Lay<M, TN>::NT][M::E]) {
  using L = Lay<M, TN>;
  using Acc = typename M::Acc;
  constexpr int E = M::E;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ip = 0; ip < L::MT; ip += 2) {
    Acc old[2][L::NT][E];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jn = 0; jn < L::NT; ++jn)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int row = (wm + (ip + h) * L::WM) * M::MTR + g + (e >= 2 ? 8 : 0);
          const int col = c0 + (wn * L::NT + jn) * 8 + 2 * t + (e & 1);
          old[h][jn][e] = !first && ip + h < L::MT && row < mbv && col < m
                              ? out[static_cast<long long>(a_base + row) * m + col]
                              : Acc(0);
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ip + h >= L::MT) break;
#pragma unroll
      for (int jn = 0; jn < L::NT; ++jn)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int row = (wm + (ip + h) * L::WM) * M::MTR + g + (e >= 2 ? 8 : 0);
          const int col = c0 + (wn * L::NT + jn) * 8 + 2 * t + (e & 1);
          if (row < mbv && col < m)
            out[static_cast<long long>(a_base + row) * m + col] =
                old[h][jn][e] + gacc[ip + h][jn][e];
          gacc[ip + h][jn][e] = Acc(0);
        }
    }
  }
}

// The int8 slab's last step of Y's elements (row gr, columns c and
// c + 1), as the units are written: plus d o x_centre in f32 (d the row's
// diagonal entry), x read from global memory (L2). f64 x: the band's f64
// sum rounded to f32 first, the result widened (kernel 4's finish,
// banded_spmm.cuh); bf16 x: the f32 sum.
template <class M>
__device__ __forceinline__ void q_finish(const TParams<M>& p, long long gr,
                                         int c, float d, typename M::Acc& v0,
                                         typename M::Acc& v1) {
  const typename M::T* xr = p.x + gr * p.m + c;
  if constexpr (sizeof(typename M::T) == 8) {
    if (c < p.m)
      v0 = static_cast<double>(__fadd_rn(
          static_cast<float>(v0), __fmul_rn(d, static_cast<float>(__ldg(xr)))));
    if (c + 1 < p.m)
      v1 = static_cast<double>(
          __fadd_rn(static_cast<float>(v1),
                    __fmul_rn(d, static_cast<float>(__ldg(xr + 1)))));
  } else {
    if (c < p.m) v0 = __fadd_rn(v0, __fmul_rn(d, __bfloat162float(__ldg(xr))));
    if (c + 1 < p.m)
      v1 = __fadd_rn(v1, __fmul_rn(d, __bfloat162float(__ldg(xr + 1))));
  }
}

// The int8 entries' kNoVT: a warp's column sums of Y, running in its row
// of shared memory csw[warp][TN]: the two values (columns c, c + 1) a
// lane holds of a unit's n8-tile, summed over the eight lanes of each
// column in a fixed order and added by the first lane of each column, pass
// after pass.
template <typename Acc>
__device__ __forceinline__ void q_colsum_add(Acc* csw, int col, Acc c0,
                                             Acc c1) {
#pragma unroll
  for (int o = 4; o < 32; o *= 2) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
  }
  if ((threadIdx.x & 31) < 4) {
    csw[col] += c0;
    csw[col + 1] += c1;
  }
}

template <class M, int TN>
__global__ void __launch_bounds__(kRoleThreads, 1)
typed_gram_kernel(const __grid_constant__ TParams<M> p) {
  using T = typename M::T;
  using Acc = typename M::Acc;
  using L = Lay<M, TN>;
  constexpr int VS = M::VS;
  constexpr int NS = M::NS;
  constexpr int KC = M::KC;
  constexpr int AU = L::AU;
  constexpr int E = M::E;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = static_cast<int>(blockIdx.x) / p.C;
  const int c0 = static_cast<int>(blockIdx.y) * TN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bs = p.bs;
  const int m = p.m;
  const int a_base = rank * p.MB;
  const int mbv = max(0, min(p.MB, p.mv - a_base));  // this block's G rows
  const long long r0 = static_cast<long long>(grp) * p.nbr / p.n_groups;
  const long long r1 = static_cast<long long>(grp + 1) * p.nbr / p.n_groups;

  // kTiles Y tiles, [ys_rows][YP] each: block row r0 + i in tile
  // i % kTiles.
  constexpr int NT = M::kTiles;
  const int tile = p.ys_rows * p.YP;
  T* ys = reinterpret_cast<T*>(smem);
  // Rows past the row tiles are read by the gram's last stage, never
  // written: zeros.
  for (int e = p.RT * 16 * p.YP + threadIdx.x; e < tile; e += kRoleThreads)
#pragma unroll
    for (int k = 0; k < NT; ++k) ys[k * tile + e] = zero<T>();
  if constexpr (M::kQ) {
    Acc* csm = reinterpret_cast<Acc*>(smem + p.off_cs);
    for (int e = threadIdx.x; e < 5 * TN; e += kRoleThreads) csm[e] = Acc(0);
  }
  T* vs = reinterpret_cast<T*>(smem + p.off_v);  // [NS][VS][VP]
  unsigned char* as = smem + p.off_a;            // [NA][a_bytes]
  T* xs = reinterpret_cast<T*>(smem + p.off_x);  // [NA][KC][XP]
  // The mbarriers: V's ring (the gram role's copies and its producer's
  // expected bytes), the apply ring (the apply role's copies and its
  // producer's expected bytes), each tile's full (the apply role's
  // arrival and the other members' rows) and empty (an arrival from every
  // member's gram role). Other members' copies and arrivals land on them:
  // the init is made visible to the cluster before the barrier below.
  const uint32_t vbars = smem_u32(smem + p.off_bar);
  const uint32_t abars = vbars + 8 * NS;
  const uint32_t fbars = abars + 8 * p.NA;
  const uint32_t ebars = fbars + 8 * NT;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) bar_init(vbars + 8 * i, kGramThreads + 1);
    int arrivals = kApplyThreads + 1;
    if constexpr (M::kQ) {
      if (p.tma_a && p.tma_x && p.tma_s) arrivals = 1;
    }
    for (int i = 0; i < p.NA; ++i) bar_init(abars + 8 * i, arrivals);
    for (int i = 0; i < NT; ++i) {
      bar_init(fbars + 8 * i, 1);
      bar_init(ebars + 8 * i, p.C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();

  const int stages = (bs + VS - 1) / VS;
  const bool no_v = p.variant == kNoVT;

  if (warp < kApplyThreads / 32) {
    // The apply role needs few registers; the gram role's G holds most
    // (the int8 types' apply holds wider units' sums: more).
    if constexpr (M::kQ) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 152;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    }
    // -- the apply role: units of 16 rows by AU n8-tiles, NG a row tile,
    //    row tile major; pass q takes units UP q .. UP (q + 1) - 1 (warp w
    //    units w, w + 4, ...), and this block the passes rank, rank + C,
    //    ... < Q.
    //    The ring's chunks are numbered in the order they are issued
    //    (abase: the next pass's first); a pass's first NA - 1 are issued
    //    ahead of it, the next row's during this row's exchange.
    const int units = p.RT * L::NG;
    const int my_passes = rank < p.Q ? (p.Q - 1 - rank) / p.C + 1 : 0;
    const int cps = (bs + KC - 1) / KC;
    auto chunks = [&](long long rr, int ps, int base) {
      const int u0 = (rank + ps * p.C) * L::UP;
      const int klo = static_cast<int>(max(0LL, p.bw - rr));
      const int khi = static_cast<int>(min(static_cast<long long>(p.K),
                                           p.nbr + p.bw - rr));
      return Chunks<M, TN>{p, rr, u0 / L::NG * 16, c0, klo,
                           (khi - klo) * cps, base, as, xs, abars};
    };
    int abase = 0;
    if (my_passes > 0) chunks(r0, 0, abase).prime();
    for (long long rr = r0; rr < r1; ++rr) {
      const int i = static_cast<int>(rr - r0);
      const int use = i / NT;
      const int b = i - use * NT;
      T* yt = ys + b * tile;
      // Before this block writes the tile's next use: every member's gram
      // has read its last use (row rr - kTiles), and the copy engine has
      // read this block's rows of it.
      auto tile_free = [&]() {
        if (use > 0) bar_wait_cluster(ebars + 8 * b, (use - 1) & 1);
        if (threadIdx.x == 0) bulk_wait_read();
        role_sync(1, kApplyThreads);
      };
      for (int ps = 0; ps < my_passes; ++ps) {
        const int u0 = (rank + ps * p.C) * L::UP;
        const int rt0 = u0 / L::NG;
        const Chunks<M, TN> ch = chunks(rr, ps, abase);
        if (ps > 0) {
          fence_proxy();
          role_sync(1, kApplyThreads);  // the previous pass's stages are free
          ch.prime();
        }
        int uu[L::UW], lt[L::UW], nt0[L::UW], nu = 0;
#pragma unroll
        for (int h = 0; h < L::UW; ++h) {
          const int u = u0 + warp + 4 * h;
          if (u < units) {
            uu[nu] = u;
            lt[nu] = u / L::NG - rt0;
            nt0[nu] = (u % L::NG) * AU;
            ++nu;
          }
        }
        Acc acc[L::UW][AU][4];
        apply_pass<M, TN>(ch, lt, nt0, nu, acc);
        abase += ch.n_chunks;
        if (ps + 1 == my_passes && rr + 1 < r1) {
          fence_proxy();
          role_sync(1, kApplyThreads);  // this pass's stages are free
          chunks(rr + 1, 0, abase).prime();
        }
        if (ps == 0) tile_free();
        // The units to HBM and into this block's tile (rows past bs:
        // zeros).
#pragma unroll
        for (int h = 0; h < L::UW; ++h) {
          if (h >= nu) break;
          const int u = uu[h];
          float dg[2] = {};  // the int8 slab's diagonal at rows g, g + 8
          if constexpr (M::kQ) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = (u / L::NG) * 16 + g + 8 * hh;
              if (row < bs) dg[hh] = __ldg(p.diag + rr * bs + row);
            }
          }
#pragma unroll
          for (int a = 0; a < AU; ++a) {
            const int col = (u % L::NG) * AU * 8 + a * 8 + 2 * t;
            Acc cs0 = Acc(0), cs1 = Acc(0);  // kNoVT's column sums
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = (u / L::NG) * 16 + g + 8 * hh;
              const bool live = row < bs;
              Acc v0 = live ? acc[h][a][2 * hh] : Acc(0);
              Acc v1 = live ? acc[h][a][2 * hh + 1] : Acc(0);
              if constexpr (M::kQ) {
                if (live) q_finish(p, rr * bs + row, c0 + col, dg[hh], v0, v1);
                cs0 += v0;
                cs1 += v1;
              }
              if (p.y != nullptr && live) {
                const long long gr = rr * bs + row;
                if (c0 + col < m) p.y[gr * m + c0 + col] = v0;
                if (c0 + col + 1 < m) p.y[gr * m + c0 + col + 1] = v1;
              }
              if constexpr (L::kF64) {
                *reinterpret_cast<double2*>(yt + row * p.YP + col) =
                    make_double2(v0, v1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(yt + row * p.YP + col) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
            if constexpr (M::kQ) {
              if (no_v)
                q_colsum_add(
                    reinterpret_cast<Acc*>(smem + p.off_cs) + warp * TN, col,
                    cs0, cs1);
            }
          }
        }
      }
      if (my_passes == 0) tile_free();
      // This block's rows of the tile to every other member by the copy
      // engine; then this block's arrival on its own tile barrier, which
      // also expects the other members' rows.
      fence_proxy();  // the units' stores before the engine reads them
      role_sync(1, kApplyThreads);
      if (threadIdx.x == 0) {
        int mine = 0;
        for (int ps = 0; ps < my_passes; ++ps) {
          const int rt0 = (rank + ps * p.C) * L::UP / L::NG;
          const int rows = min(L::PR * 16, p.RT * 16 - rt0 * 16);
          mine += rows;
          for (int q = 0; q < p.C; ++q)
            if (q != rank)
              bulk_to_member(yt + rt0 * 16 * p.YP, fbars + 8 * b,
                             rows * p.YP * sizeof(T), q);
        }
        bulk_commit();
        bar_expect(fbars + 8 * b, (p.RT * 16 - mine) * p.YP * sizeof(T));
      }
    }
    if (threadIdx.x == 0) bulk_wait_read();
    if constexpr (M::kQ) {
      if (no_v) {
        // This block's column sums: its four warps' in order.
        Acc* csm = reinterpret_cast<Acc*>(smem + p.off_cs);
        role_sync(1, kApplyThreads);
        for (int c = threadIdx.x; c < TN; c += kApplyThreads)
          csm[4 * TN + c] =
              ((csm[c] + csm[TN + c]) + csm[2 * TN + c]) + csm[3 * TN + c];
      }
    }
  } else {
    if constexpr (M::kQ) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
    }
    // -- the gram role: G[a_base + i, c0 + c] += sum_k V[rr*bs + k,
    //    a_base + i] Y[k, c]; V item j is stage j % stages of block row
    //    r0 + j / stages, in ring stage j % NS.
    const int gw = warp - kApplyThreads / 32;
    const int gtid = threadIdx.x - kApplyThreads;
    const int wm = gw / L::WN;
    const int wn = gw % L::WN;
    const int n_items = no_v ? 0 : static_cast<int>(r1 - r0) * stages;
    const Walk vwalk(p.MB / (16 / static_cast<int>(sizeof(T))), gtid,
                     kGramThreads);
    auto issue_v = [&](int j) {
      if (j >= n_items) return;
      const int row = j / stages;
      const int s0 = (j - row * stages) * VS;
      T* vd = vs + (j % NS) * VS * p.VP;
      const uint32_t bar = vbars + 8 * (j % NS);
      // Columns past this block's G rows and rows past bs are read and
      // never used (the Y tile's rows past bs are zeros).
      if (gtid == 0) {
        bar_expect(bar, p.tma_v ? VS * p.VP * sizeof(T) : 0);
        if (p.tma_v)
          tma_box(vd, &p.map_v, a_base,
                  static_cast<int>((r0 + row) * bs + s0), bar);
      }
      if (!p.tma_v)
        stage<T>(vd, p.VP, p.v + ((r0 + row) * bs + s0) * p.ldv + a_base,
                 p.ldv, VS, vwalk, min(VS, bs - s0), mbv, p.vec_v != 0);
      bar_arrive_copies(bar);
    };
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) issue_v(j);

    Acc gacc[L::MT][L::NT][E];
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) gacc[i][j][e] = Acc(0);
    // This block's slice of the cluster's partial of G.
    Acc* out = p.partial + static_cast<long long>(grp) * p.mv * m;

    for (long long rr = r0; rr < r1; ++rr) {
      const int i = static_cast<int>(rr - r0);
      const int use = i / NT;
      const int b = i - use * NT;
      const T* yt = ys + b * tile;
      bar_wait(fbars + 8 * b, use & 1);  // the tile is whole
      for (int s = 0; s < stages; ++s) {
        const int j = i * stages + s;
        if (j < n_items) bar_wait(vbars + 8 * (j % NS), (j / NS) & 1);
        fence_proxy();                // reads of stage j - 1 are done
        role_sync(2, kGramThreads);   // stage j - 1's slot is free
        issue_v(j + NS - 1);
        if (mbv <= 0 || p.variant == kNoGramT || no_v) continue;
        gram_stage<M, TN>(vs + (j % NS) * VS * p.VP, yt + s * VS * p.YP,
                          p.VP, p.YP, wm, wn, mbv, gacc);
      }
      if constexpr (M::kQ) {
        // kTileT: the pass goes on into the next row's tile, and frees
        // both after it.
        if (p.variant == kTileT && (i & 1) == 0 && rr + 1 < r1) continue;
      }
      // This member reads the tile no more: every member may write it.
      fence_proxy();
      role_sync(2, kGramThreads);
      if (gtid == 0) {
        if constexpr (M::kQ) {
          if (p.variant == kTileT && (i & 1) == 1)
            arrive_members(ebars + 8 * ((i - 1) % NT), p.C);
        }
        arrive_members(ebars + 8 * b, p.C);
      }

      if constexpr (M::kFlush > 0) {
        // Every kFlush block rows (and at the end), the registers into the
        // partial: the tensor cores' f32 accumulation does not round to
        // nearest (fused_gram.cu).
        if ((rr - r0 + 1) % M::kFlush == 0 || rr + 1 == r1)
          flush<M, TN>(out, rr - r0 < M::kFlush, wm, wn, a_base, mbv, c0, m,
                       gacc);
      }
    }
    if constexpr (M::kFlush == 0) {
      flush<M, TN>(out, true, wm, wn, a_base, mbv, c0, m, gacc);
    }
  }
  // No member leaves while another may still copy into it or arrive on
  // its barriers.
  cluster.sync();
  if constexpr (M::kQ) {
    if (no_v) {
      // G's row 0: the members' column sums in rank order, over the zeros
      // that member 0's gram role wrote there; no member leaves before
      // they are read.
      const Acc* cb = reinterpret_cast<const Acc*>(smem + p.off_cs) + 4 * TN;
      const int c = static_cast<int>(threadIdx.x);
      if (rank == 0 && c < TN && c0 + c < m) {
        Acc sum = Acc(0);
        for (int q = 0; q < p.C; ++q) sum += cluster.map_shared_rank(cb, q)[c];
        p.partial[static_cast<long long>(grp) * p.mv * m + c0 + c] = sum;
      }
      cluster.sync();
    }
  }
}

// -- host side ---------------------------------------------------------------

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (PyTorch loads it), so the library links against nothing more (as
// ext_spmm.cu takes it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tma_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The copy engine's element type of T (int8 slabs as bytes).
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 8   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
         : sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// A (rows, cols) tensor of row stride ld elements as a 2-D map with
// (box_rows, box_cols) boxes, unswizzled; elements past its edges load as
// zeros. False where the map cannot take it.
template <typename T>
bool tma_map(CUtensorMap* map, const T* base, long long rows, long long cols,
             long long ld, int box_rows, int box_cols) {
  const EncodeTiled fn = tma_encoder();
  if (fn == nullptr || !fdt1::aligned16(base) || (ld * sizeof(T)) % 16 != 0 ||
      box_rows > 256 || box_cols > 256 || (box_cols * sizeof(T)) % 16 != 0)
    return false;
  const CUtensorMapDataType type = tma_type<T>();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<T*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class M>
struct TPlan {
  int TN, col_tiles, smem;
  TParams<M> p;
};

inline int rup(int a, int b) { return (a + b - 1) / b * b; }

// The slab ((rows, K * bs) row-major) as a 3-D map (rows, K slots, bs
// columns) with boxes of (box_rows, 1, box_cols): columns past bs, a
// chunk's depth past its slot, load as zeros.
template <typename T>
bool tma_slab_map(CUtensorMap* map, const T* base, long long rows, int K,
                  int bs, int box_rows, int box_cols) {
  const EncodeTiled fn = tma_encoder();
  if (fn == nullptr || !fdt1::aligned16(base) || (bs * sizeof(T)) % 16 != 0 ||
      box_rows > 256 || box_cols > 256 || (box_cols * sizeof(T)) % 16 != 0)
    return false;
  const CUtensorMapDataType type = tma_type<T>();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bs),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(bs) * sizeof(T),
      static_cast<cuuint64_t>(K) * bs * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<T*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxCluster = 8;

// The layout at column tile TN with the fewest blocks a cluster (C <= 8)
// whose G rows fit their registers, whose passes split evenly (where a
// cluster of at most 8 can split them evenly) and whose shared memory
// fits a block; false if none does.
template <class M, int TN>
bool plan_at(int bs, int mv, int optin, TPlan<M>* plan) {
  using T = typename M::T;
  using L = Lay<M, TN>;
  const int RT = (bs + 15) / 16;
  const int Q = (RT * L::NG + L::UP - 1) / L::UP;
  for (int C = max(1, (mv + L::cap - 1) / L::cap); C <= kMaxCluster; ++C) {
    if (Q > C && Q % C != 0 && Q <= kMaxCluster) continue;
    TParams<M>& p = plan->p;
    p.C = C;
    p.MB = rup((mv + C - 1) / C, M::MTR);
    p.RT = RT;
    p.Q = Q;
    p.YP = M::stride(TN);
    p.VP = M::stride(p.MB);
    p.XP = M::stride(L::XW);
    p.ys_rows = rup(RT * 16, M::VS);
    const long long sz = sizeof(T);
    // kTiles Y tiles.
    const long long ys_bytes = 1LL * M::kTiles * p.ys_rows * p.YP * sz;
    const long long v_bytes = static_cast<long long>(M::NS) * M::VS * p.VP * sz;
    // A slab stage (int8: its rows, then its KC scales; a stage of the
    // copy engine's starts on 128 bytes).
    const long long a_bytes =
        M::kQ ? (L::PR * 16 * M::SA + M::KC * 4 + 127) / 128 * 128
              : (L::PR * 16 * M::SA * sz + 15) / 16 * 16;
    // The int8 types' kNoVT column sums, after the barriers.
    const long long cs_bytes =
        M::kQ ? 5LL * TN * static_cast<long long>(sizeof(typename M::Acc)) : 0;
    // The deepest apply ring (M::NA down to 3 stages) that fits.
    long long x_bytes = 0, smem = 0;
    int na = M::NA;
    for (; na >= 3; --na) {
      x_bytes = static_cast<long long>(na) * M::KC * p.XP * sz;
      smem = (ys_bytes + 127) / 128 * 128 + v_bytes + na * a_bytes + x_bytes +
             8 * (M::NS + na + 2 * M::kTiles);
      if (cs_bytes > 0) smem = rup(static_cast<int>(smem), 16) + cs_bytes;
      if (smem <= optin) break;
    }
    if (na < 3) continue;
    p.NA = na;
    p.a_bytes = static_cast<int>(a_bytes);
    p.off_v = static_cast<int>((ys_bytes + 127) / 128 * 128);
    p.off_a = p.off_v + static_cast<int>(v_bytes);
    p.off_x = p.off_a + na * p.a_bytes;
    p.off_bar = p.off_x + static_cast<int>(x_bytes);
    if constexpr (M::kQ)
      p.off_cs = static_cast<int>(smem - cs_bytes);
    plan->TN = TN;
    plan->smem = static_cast<int>(smem);
    return true;
  }
  return false;
}

// The launch configuration of a plan (the kernel's attributes set).
template <class M, int TN>
cudaError_t configure(const TPlan<M>& plan, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, cudaStream_t stream) {
  auto kernel = typed_gram_kernel<M, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->blockDim = dim3(kRoleThreads, 1, 1);
  cfg->dynamicSmemBytes = plan.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The clusters of a plan the card holds at once (0: none fits).
template <class M, int TN>
cudaError_t resident(const TPlan<M>& plan, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<M, TN>(plan, &cfg, attr, nullptr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(plan.p.C, 1, 1);
  *clusters = 0;
  return cudaOccupancyMaxActiveClusters(clusters, typed_gram_kernel<M, TN>,
                                        &cfg);
}

// The layout at TN if one fits and the card holds one of its clusters.
template <class M, int TN>
bool fits(int bs, int mv, int optin, TPlan<M>* plan,
          int* clusters) {
  if (!plan_at<M, TN>(bs, mv, optin, plan)) return false;
  return resident<M, TN>(*plan, clusters) == cudaSuccess && *clusters >= 1;
}

// The widest column tile TN (m rounded up to 8, at most 128) that has a
// layout, narrower ones after it (the int8 types also 24); the grid then
// has ceil(m / TN) column tiles.
template <class M>
cudaError_t make_plan(int bs, int m, int mv, TPlan<M>* plan,
                      int* clusters) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int want = rup(min(m, 128), 8);
  bool ok = false;
  // (float64 has no TN = 128: a pass would cover half the tile's width.)
  if constexpr (Lay<M, 128>::XW == 128)
    if (!ok && want > 64) ok = fits<M, 128>(bs, mv, optin, plan, clusters);
  if (!ok && want > 32) ok = fits<M, 64>(bs, mv, optin, plan, clusters);
  if constexpr (M::kQ) {
    // An int8 type's unit spans its tile, so a tile of 24 pads no column
    // at the lowest-20 solve's m = 20.
    if (!ok && want > 16 && want <= 24)
      ok = fits<M, 24>(bs, mv, optin, plan, clusters);
  }
  if (!ok && want > 16) ok = fits<M, 32>(bs, mv, optin, plan, clusters);
  if (!ok && want > 8) ok = fits<M, 16>(bs, mv, optin, plan, clusters);
  if (!ok) ok = fits<M, 8>(bs, mv, optin, plan, clusters);
  cudaGetLastError();  // a refused configuration above is not this call's error
  if (!ok) return cudaErrorInvalidValue;
  plan->col_tiles = (m + plan->TN - 1) / plan->TN;
  return cudaSuccess;
}

// Launch: clusters of C blocks, n_groups of them over the block rows times
// col_tiles, then the fixed-order sum of the partials.
template <class M, int TN>
cudaError_t run(const TPlan<M>& plan, float* g, cudaStream_t stream) {
  using T = typename M::T;
  TParams<M> p = plan.p;
  // The copy engine for x and V where the maps take them and their stages
  // start on 128-byte boundaries; the threads' cp.async otherwise.
  constexpr int XP = M::stride(Lay<M, TN>::XW);
  const long long n = static_cast<long long>(p.nbr) * p.bs;
  p.tma_x = p.off_x % 128 == 0 && (M::KC * XP * sizeof(T)) % 128 == 0 &&
            tma_map(&p.map_x, p.x, n, p.m, p.m, M::KC, XP);
  p.tma_v = p.off_v % 128 == 0 && (M::VS * p.VP * sizeof(T)) % 128 == 0 &&
            tma_map(&p.map_v, p.v, n, p.mv, p.ldv, M::VS, p.VP);
  p.tma_a = p.off_a % 128 == 0 && p.a_bytes % 128 == 0 &&
            tma_slab_map(&p.map_a, p.blocks, n, p.K, p.bs,
                         Lay<M, TN>::PR * 16, M::SA);
  if constexpr (M::kQ) {
    const long long lanes = static_cast<long long>(p.K) * p.bs;
    p.tma_s = p.off_a % 128 == 0 && p.a_bytes % 128 == 0 &&
              tma_map(&p.map_s, p.scale, p.nbr, lanes, lanes, 1, M::KC);
  }
  if (p.n_groups < 1 || p.n_groups > p.nbr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<M, TN>(plan, &cfg, attr, stream);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(p.n_groups * p.C, plan.col_tiles, 1);
  err = cudaLaunchKernelEx(&cfg, typed_gram_kernel<M, TN>, p);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long count = static_cast<long long>(p.mv) * p.m;
  const long long blocks = (count + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  reduce_partials<typename M::Acc><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      p.partial, g, p.n_groups, count);
  return cudaGetLastError();
}

// One call of an entry. With out (the plan entries), report the layout
// into out[6] (row groups: the clusters the card holds at once over the
// column tiles; TN, C, MB, dynamic shared memory a block, clusters
// resident) and launch nothing; else launch with n_groups row groups. v
// null: G = X^T A X (mv == m).
template <class M>
int typed_gram(const typename M::S* blocks, const typename M::T* x,
               const typename M::T* v, long long ldv, typename M::Acc* y,
               typename M::Acc* partial, float* g, int nbr, int bs, int K,
               int bw, int m, int mv, int n_groups, int variant,
               int* out, void* stream, const float* scale = nullptr,
               const float* diag = nullptr) {
  using T = typename M::T;
  if (nbr <= 0 || bs <= 0 || K <= 0 || m <= 0 || mv <= 0) return 0;
  if (variant < kFullT || variant > (M::kQ ? kTileT : kNoVT))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out == nullptr && v == nullptr) {
    if (mv != m) return static_cast<int>(cudaErrorInvalidValue);
    v = x;
    ldv = m;
  }
  TPlan<M> plan;
  int clusters = 0;
  cudaError_t err = make_plan<M>(bs, m, mv, &plan, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (out != nullptr) {
    out[0] = max(1, min(nbr, clusters / plan.col_tiles));
    out[1] = plan.TN;
    out[2] = plan.p.C;
    out[3] = plan.p.MB;
    out[4] = plan.smem;
    out[5] = clusters;
    return 0;
  }
  constexpr int V = 16 / sizeof(T);
  TParams<M>& p = plan.p;
  p.blocks = blocks;
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
  p.variant = variant;
  if constexpr (M::kQ) {
    p.scale = scale;
    p.diag = diag;
  }
  p.vec_a = fdt1::aligned16(blocks) &&
            bs % (16 / static_cast<int>(sizeof(typename M::S))) == 0;
  p.vec_x = fdt1::aligned16(x) && m % V == 0;
  p.vec_v = fdt1::aligned16(v) && ldv % V == 0;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan.TN) {
    case 8: err = run<M, 8>(plan, g, s); break;
    case 16: err = run<M, 16>(plan, g, s); break;
    case 24:
      if constexpr (M::kQ)
        err = run<M, 24>(plan, g, s);
      else
        err = cudaErrorInvalidValue;
      break;
    case 32: err = run<M, 32>(plan, g, s); break;
    case 64: err = run<M, 64>(plan, g, s); break;
    default:
      if constexpr (Lay<M, 128>::XW == 128)
        err = run<M, 128>(plan, g, s);
      else
        err = cudaErrorInvalidValue;
      break;
  }
  return static_cast<int>(err);
}

}  // namespace
