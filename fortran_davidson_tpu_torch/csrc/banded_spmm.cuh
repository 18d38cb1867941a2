// Kernel 1, the DIA-banded SpMM, as one template for Hopper (sm_90a): the
// kernel of banded_spmm.cu, its measurement variants
// (banded_spmm_var_{f64,f32,bf16}.cu), kernel 8 (remote_halo.cu), the
// same product over a shard's rows and its two received halos, kernel 6's
// cp.async route (ext_spmm.cu), over a halo-extended input, and kernel 2
// (bsr_spmm.cu), the block-ELL product over a column table, and kernels 4
// and 7 with float64 x (q_spmm_f64.cu, q_ext_spmm_f64.cu), over int8 slabs
// (QInt8, below).
// The design and what bounds it are written at the top of banded_spmm.cu.
// The tiling and shared memory a launch takes are decided here alone;
// plan_entry() reports them (kernels.banded_spmm_plan).
//
// Storage: (nbr, bs, K*bs) row-major block slabs, K = 2*bw + 1, slot k of
// block row r holding block column r - bw + k; x is (nbr*bs, m) row-major.
//
// A thread block (CTA) owns RPC consecutive block rows r0 .. r0+RPC-1, a
// row tile [i0, i0 + TM) of their bs rows and a column tile [c0, c0 + TN)
// of m. It walks the Kw = RPC + 2*bw window block columns j (global block
// column r0 - bw + j) in KC-deep chunks; one chunk is one ring stage:
//   - the (KC, TN) x chunk, staged once (x-stationary: at RPC > 1 each
//     window chunk is applied to every block row of the CTA that has it in
//     its band);
//   - the (TM, KC) slab chunk of each of those block rows (slot j - i).
// Stages are filled by cp.async (16-byte copies where every row start is
// 16-byte aligned, else element copies; bf16 elements synchronously), the
// next stages - 1 in flight while one is multiplied. Rows of x outside
// [0, n), block rows past nbr, rows past bs and columns past m or past the
// block's bs are zero-filled without being read: 0 * Inf never enters a
// sum, and no out-of-bounds address is formed.
//
// A warp owns 16 rows of the tile and all TN columns: per block row and
// n8 tile it holds acc[4] = (row g: cols 2t, 2t+1; row g + 8: the same),
// g = lane / 4, t = lane % 4, the accumulator layout of mma m16n8. Math:
//   - f64: mma.sync m8n8k4 (DMMA), two m8 tiles a warp;
//   - bf16: mma.sync m16n8k16 with f32 sums, B fragments by ldmatrix.trans;
//   - f32: FFMA on the CUDA cores in the same layout;
//   - QInt8 (int8 slab, f64 x): each entry times its lane's f32 scale in
//     f32, widened to f64, on DMMA as f64.
// Each output element is summed by one thread in a fixed order: the same
// inputs give the same bits.
//
// Where a window chunk's x rows come from is the kernel's source (Src,
// below): kernel 1's zero-fills rows outside [0, n); kernel 8's read a
// shard's rows unmasked (Inside) or split them between the shard's rows
// and its halos (Split); kernel 2's walks its row's K table entries
// instead of the band (Table, at RPC = 1: window j is slot j, in block
// column cols[r, j]). A source also maps the grid's rows to block rows.
// The int8 entries wrap kernel 1's or kernel 8's source in Quant, which
// also carries the slab's scales and the exact diagonal. Kernel 8's
// one-launch form (Push, remote_push.cuh) also takes a step before and
// after a CTA's walk (before_walk, after_walk): the ring neighbours' halo
// push and the wait for its own halos, then the signal that they are read.
//
// Variants (template parameters, measurement only):
//   kVar    kFull | kNoY (products, no Y: one column-sum row a CTA into
//           colsum) | kCopy (kernel 9: the same reads, adds only) |
//           kWriteOnly (Y[i, c] = i written, nothing read);
//   kStore  kDirect (from registers) | kTma (Y tile staged in shared
//           memory, written by cp.async.bulk per row);
//   kEvict  L2::evict_first hint on the slab stream.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace fdt1 {

enum Var { kFull = 0, kNoY = 1, kCopy = 2, kWriteOnly = 3 };
enum Store { kDirect = 0, kTma = 1 };

using Bf16 = __nv_bfloat16;

// The int8 slab of kernels 4 and 7 with float64 x, as a tag: a QInt8 ring
// is a ring of bytes (sizeof 1). Its entries are int8, each times its
// lane's f32 scale; x, the sums and Y are f64.
struct QInt8 {};

// The slab's and x's element types: T itself, but for QInt8.
template <typename T> struct Elems {
  using Slab = T;
  using X = T;
};
template <> struct Elems<QInt8> {
  using Slab = int8_t;
  using X = double;
};

template <typename T> struct Math;
template <> struct Math<double> {
  using Acc = double;
  static constexpr int KC = 16;
};
template <> struct Math<float> {
  using Acc = float;
  static constexpr int KC = 16;
};
template <> struct Math<Bf16> {
  using Acc = float;
  static constexpr int KC = 32;
};
template <> struct Math<QInt8> {
  using Acc = double;
  static constexpr int KC = 16;
};

// Shared-memory row strides (elements): slab chunk, x chunk. A QInt8 slab
// row is one unpadded 16-byte chunk: the eight rows that a warp's lanes
// read at once lie in one 128-byte line.
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return sizeof(T) == 1 ? Math<T>::KC
                        : Math<T>::KC + (sizeof(T) == 2 ? 8 : 4);
}
template <typename T>
__host__ __device__ constexpr int x_stride(int tn) {
  return sizeof(T) == 8 ? (tn % 16 == 0 ? tn + 8 : tn) : tn + 8;
}
// One ring stage in T: the slab chunks, then the x chunk; for QInt8 (in
// bytes) the slab chunk, the f64 x chunk, then the chunk's KC f32 scales.
template <typename T>
__host__ __device__ constexpr int stage_elems(int tm, int tn, int rpc) {
  return std::is_same<T, QInt8>::value
             ? rpc * tm * a_stride<T>() +
                   Math<T>::KC * (x_stride<double>(tn) * 8 + 4)
             : rpc * tm * a_stride<T>() + Math<T>::KC * x_stride<T>(tn);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}
__device__ __forceinline__ void cp_async16_hint(void* dst, const void* src,
                                                bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(valid ? 16 : 0), "l"(policy));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most n groups are pending (n is the ring's depth - 2).
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

// Stage a (rows, cols) tile: element (i, c) is src[i * ld + c] for i in
// [lo, hi) and c < vcols, else zero (not read; the zero-filling copy is
// given the valid address `safe`). vec: every row start is 16-byte aligned
// and vcols a multiple of the vector. Elements of fewer than 4 bytes
// (bf16, int8) are copied synchronously where vec does not hold.
template <typename T, bool kHint>
__device__ __forceinline__ void stage_tile(T* dst, int dst_ld, const T* src,
                                           const T* safe,
                                           long long ld, int rows, int cols,
                                           int lo, int hi, int vcols,
                                           bool vec, uint64_t policy) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cv = cols / V;
    for (int e = tid; e < rows * cv; e += nt) {
      const int i = e / cv;
      const int c = (e % cv) * V;
      const bool ok = i >= lo && i < hi && c < vcols;
      const T* s = ok ? src + i * ld + c : safe;
      if constexpr (kHint) {
        cp_async16_hint(dst + i * dst_ld + c, s, ok, policy);
      } else {
        cp_async<16>(dst + i * dst_ld + c, s, ok);
      }
    }
    return;
  }
  for (int e = tid; e < rows * cols; e += nt) {
    const int i = e / cols;
    const int c = e % cols;
    const bool ok = i >= lo && i < hi && c < vcols;
    if constexpr (sizeof(T) <= 2) {
      dst[i * dst_ld + c] = ok ? src[i * ld + c] : T(0.0f);
    } else {
      cp_async<sizeof(T)>(dst + i * dst_ld + c, ok ? src + i * ld + c : safe,
                          ok);
    }
  }
}

// The launch's block rows: grid row j is block row a0 + j for j < na, else
// b0 + (j - na) (kernel 8's two edges in one grid).
struct RowRange {
  long long a0, na, b0;
  __device__ __forceinline__ long long operator()(long long j) const {
    return j < na ? a0 + j : b0 + (j - na);
  }
};

// The x rows of a window chunk: rows xr0 .. xr0 + KC of the block column
// that the chunk lies in (its first vk rows valid, the rest zero-filled),
// columns c0 .. c0 + TN, staged into dst (row stride sx).
//
// Masked (kernel 1): x itself, rows outside [0, n) zero-filled and never
// read; grid row g is block row g.
template <typename T>
struct Masked {
  __device__ __forceinline__ long long block_row(long long g) const {
    return g;
  }
  template <int KC, int TN>
  __device__ __forceinline__ void stage_x(T* dst, int sx, const T* x,
                                          long long xr0, int vk, long long n,
                                          int m, int c0, int vcols,
                                          bool vec) const {
    const long long lo = xr0 < 0 ? -xr0 : 0;
    const long long hi = min(static_cast<long long>(vk), n - xr0);
    stage_tile<T, false>(dst, sx, x + (lo < hi ? xr0 * m + c0 : 0), x, m, KC,
                         TN, static_cast<int>(lo),
                         static_cast<int>(max(lo, hi)), vcols, vec, 0);
  }
  bool aligned() const { return true; }
};

// Inside (kernel 8's interior launch, kernel 6's cp.async route): x
// itself, unmasked; every window of the range's block rows lies in x's
// rows.
template <typename T>
struct Inside {
  RowRange rows;
  __device__ __forceinline__ long long block_row(long long g) const {
    return rows(g);
  }
  template <int KC, int TN>
  __device__ __forceinline__ void stage_x(T* dst, int sx, const T* x,
                                          long long xr0, int vk, long long,
                                          int m, int c0, int vcols,
                                          bool vec) const {
    stage_tile<T, false>(dst, sx, x + xr0 * m + c0, x, m, KC, TN, 0, vk,
                         vcols, vec, 0);
  }
  bool aligned() const { return true; }
};

// Split (kernel 8's edge launch): the shard's n rows x and its halos, no
// halo-extended copy: rows below 0 from top (halo rows, at row + halo),
// rows at n or above from bot (at row - n), the rest from x, unmasked. A
// chunk lies in one block column, so in one of the three.
template <typename T>
struct Split {
  RowRange rows;
  const T* top;
  const T* bot;
  long long halo;
  __device__ __forceinline__ long long block_row(long long g) const {
    return rows(g);
  }
  template <int KC, int TN>
  __device__ __forceinline__ void stage_x(T* dst, int sx, const T* x,
                                          long long xr0, int vk, long long n,
                                          int m, int c0, int vcols,
                                          bool vec) const {
    const T* p = xr0 < 0 ? top : xr0 >= n ? bot : x;
    const long long row = xr0 < 0 ? xr0 + halo : xr0 >= n ? xr0 - n : xr0;
    stage_tile<T, false>(dst, sx, p + row * m + c0, p, m, KC, TN, 0, vk,
                         vcols, vec, 0);
  }
  bool aligned() const {
    return ((reinterpret_cast<uintptr_t>(top) | reinterpret_cast<uintptr_t>(bot))
            & 15) == 0;
  }
};

// Table (kernel 2, bsr_spmm.cu): block-ELL, slot j of block row r holding
// block column cols[r * K + j], launched at RPC = 1 with bw = 0. x has
// x_rows rows (a multiple of bs), so a chunk's rows lie all inside or all
// outside them: a block column outside [0, x_rows / bs) zero-fills the
// chunk, unread (Masked's rule over x_rows).
template <typename T>
struct Table {
  const int* cols;
  int K;
  long long x_rows;
  __device__ __forceinline__ long long block_row(long long g) const {
    return g;
  }
  template <int KC, int TN>
  __device__ __forceinline__ void stage_x(T* dst, int sx, const T* x,
                                          long long xr0, int vk, long long,
                                          int m, int c0, int vcols,
                                          bool vec) const {
    Masked<T>{}.template stage_x<KC, TN>(dst, sx, x, xr0, vk, x_rows, m, c0,
                                         vcols, vec);
  }
  bool aligned() const { return true; }
};

// Quant (kernels 4 and 7 with float64 x, QInt8 slabs): a source of x rows,
// Masked for kernel 4 and Inside for kernel 7, that also carries the slab's
// scales, scale[r, l] the f32 scale of block row r's slot over lane l (its
// (nbr, K*bs) scale_rows), and the exact diagonal diag[r, i] ((nbr, bs)).
// vec_scale: scale is 16-byte aligned.
template <class Base>
struct Quant : Base {
  const float* scale;
  const float* diag;
  bool vec_scale;
};

// The KC scales of a slab chunk, staged after its x chunk: lanes
// [off, off + KC) of the scale rows, the first vk valid. Only Quant sources
// have scales; for the others the call is empty.
template <int KC, class Src>
__device__ __forceinline__ void stage_scales(const Src&, float*, long long,
                                             int, bool) {}
template <int KC, class Base>
__device__ __forceinline__ void stage_scales(const Quant<Base>& src,
                                             float* dst, long long off,
                                             int vk, bool vec) {
  stage_tile<float, false>(dst, KC, src.scale + off, src.scale, 0, 1, KC, 0,
                           1, vk, vec && src.vec_scale, 0);
}

// The last step of output elements (row, c) and (row, c + 1) of a block
// row, before Y is written. Only Quant sources take one: the band's f64 sum
// rounded to f32, plus d * x_centre in f32, widened (the plain version's
// arithmetic, ops/kernels.py banded_q_bsr_spmm_plain); x's row `row` is the
// centre row.
template <class Src, typename X, typename Acc>
__device__ __forceinline__ void finish(const Src&, const X*, long long, int,
                                       int, Acc&, Acc&) {}
template <class Base>
__device__ __forceinline__ void finish(const Quant<Base>& src,
                                       const double* x, long long row, int m,
                                       int c, double& v0, double& v1) {
  const float d = __ldg(src.diag + row);
  const double* xr = x + row * m + c;
  if (c < m)
    v0 = static_cast<double>(__fadd_rn(
        static_cast<float>(v0), __fmul_rn(d, static_cast<float>(__ldg(xr)))));
  if (c + 1 < m)
    v1 = static_cast<double>(
        __fadd_rn(static_cast<float>(v1),
                  __fmul_rn(d, static_cast<float>(__ldg(xr + 1)))));
}

// A CTA's step before its walk (the CTA owns block row r0, row tile i0 of
// rows_a rows, column tile c0 of vcols columns, of a grid of row_tiles x
// col_tiles tiles a block row), and its step after the walk, once its last
// chunk is in shared memory. Only Push sources (remote_push.cuh) take
// them; for the others both calls are empty.
template <class Src, typename X>
__device__ __forceinline__ void before_walk(const Src&, const X*, long long,
                                            int, int, int, int, int, int, int,
                                            int, int) {}
template <class Src>
__device__ __forceinline__ void after_walk(const Src&, long long, int, int,
                                           int) {}

// The window a CTA walks: Kw block columns, and the first x row of chunk
// kc0 of window column j. The banded sources read RPC + 2*bw contiguous
// block columns from r0 - bw; the table reads its row's K entries.
template <class Src>
__device__ __forceinline__ int window(const Src&, int rpc, int, int bw) {
  return rpc + 2 * bw;
}
template <class Src>
__device__ __forceinline__ long long x_row(const Src&, long long r0, int j,
                                           int bw, int bs, int kc0) {
  return (r0 - bw + j) * bs + kc0;
}
template <typename T>
__device__ __forceinline__ int window(const Table<T>& src, int, int, int) {
  return src.K;
}
template <typename T>
__device__ __forceinline__ long long x_row(const Table<T>& src, long long r0,
                                           int j, int, int bs, int kc0) {
  return static_cast<long long>(__ldg(src.cols + r0 * src.K + j)) * bs + kc0;
}

__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void bmma(float (&c)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (k 0-15, n 0-7) of mma m16n8k16 from a row-major bf16
// [k][n] tile in shared memory, by ldmatrix.trans: lane l (< 16) points at
// row l of the tile, column n 0 (rows 16-byte aligned).
__device__ __forceinline__ void b_frag(const Bf16* row, uint32_t& b0,
                                       uint32_t& b1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(row)));
}

// acc += As[wr:wr+16, :KC] @ Xs[:KC, :TN] (one block row, one stage).
template <int NT>
__device__ __forceinline__ void stage_product(const double* As,
                                              const double* Xs, int sx,
                                              int wr, double (&acc)[NT][4]) {
  constexpr int sa = a_stride<double>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < Math<double>::KC / 4; ++ks) {
    double b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = Xs[(ks * 4 + t) * sx + nt * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const double a = As[(wr + mt * 8 + g) * sa + ks * 4 + t];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        dmma(acc[nt][2 * mt], acc[nt][2 * mt + 1], a, b[nt]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void stage_product(const float* As, const float* Xs,
                                              int sx, int wr,
                                              float (&acc)[NT][4]) {
  constexpr int sa = a_stride<float>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < Math<float>::KC; ++k) {
    const float a0 = As[(wr + g) * sa + k];
    const float a1 = As[(wr + g + 8) * sa + k];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b =
          *reinterpret_cast<const float2*>(Xs + k * sx + nt * 8 + 2 * t);
      acc[nt][0] = fmaf(a0, b.x, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b.y, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b.x, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b.y, acc[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void stage_product(const Bf16* As, const Bf16* Xs,
                                              int sx, int wr,
                                              float (&acc)[NT][4]) {
  constexpr int sa = a_stride<Bf16>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < Math<Bf16>::KC / 16; ++ks) {
    const Bf16* a_lo = As + (wr + g) * sa + ks * 16 + 2 * t;
    const Bf16* a_hi = a_lo + 8 * sa;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a_lo),
                           *reinterpret_cast<const uint32_t*>(a_hi),
                           *reinterpret_cast<const uint32_t*>(a_lo + 8),
                           *reinterpret_cast<const uint32_t*>(a_hi + 8)};
    const Bf16* xrow = Xs + (ks * 16 + (lane & 15)) * sx;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      b_frag(xrow + nt * 8, b0, b1);
      bmma(acc[nt], a, b0, b1);
    }
  }
}

// Byte t of w, a signed int8 stored with 128 added (w ^ 0x80808080), as a
// float: the bits 0x4B0000bb are 2^23 + bb exactly, less 2^23 + 128. Integer
// and f32 adds, where the conversion instruction issues at a quarter of
// their rate. sel = 0x7440 | t.
__device__ __forceinline__ float biased_s8(uint32_t w, uint32_t sel) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.0f;
}

// acc += (Q o s)[wr:wr+16, :KC] @ Xs[:KC, :TN] for an int8 slab chunk: each
// entry times its lane's scale in f32 (the plain version's products, bit
// for bit), widened to f64, on DMMA with kernel 1's f64 fragments and
// order. A lane reads its row of the chunk as one 16-byte load and builds
// its 8 A values of the chunk once; the KC scales follow the x chunk.
template <int NT>
__device__ __forceinline__ void stage_product(const QInt8* As,
                                              const double* Xs, int sx,
                                              int wr, double (&acc)[NT][4]) {
  constexpr int KC = Math<QInt8>::KC;
  constexpr int sa = a_stride<QInt8>();
  static_assert(KC == 16 && sa == 16, "one 16-byte slab row a chunk");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* Ss = reinterpret_cast<const float*>(Xs + KC * sx);
  const uint32_t sel = 0x7440u | static_cast<uint32_t>(t);
  double a[2][KC / 4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const unsigned char*>(As) + (wr + mt * 8 + g) * sa);
    const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                               w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
    for (int ks = 0; ks < KC / 4; ++ks)
      a[mt][ks] = static_cast<double>(
          __fmul_rn(biased_s8(words[ks], sel), Ss[ks * 4 + t]));
  }
#pragma unroll
  for (int ks = 0; ks < KC / 4; ++ks) {
    double b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = Xs[(ks * 4 + t) * sx + nt * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        dmma(acc[nt][2 * mt], acc[nt][2 * mt + 1], a[mt][ks], b[nt]);
    }
  }
}

// Two neighbouring elements p[0], p[1] in the sum type, in one load.
__device__ __forceinline__ double2 pair(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const Bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// kCopy: acc(row, c) += sum of the slab chunk's row + x chunk row (row's
// offset in the block - kc0) where that lies in the chunk: over the walk,
// Y[i, c] = sum_k xwin[k*bs + i, c] + sum_l blocks[r, i, l]. The four
// lanes that share a row each sum a quarter of it and exchange partials,
// and every load takes two elements, so that the adds stay below the
// stream.
template <typename T, int NT>
__device__ __forceinline__ void stage_copy(
    const T* As, const T* Xs, int sx, int wr, int i0, int kc0,
    typename Math<T>::Acc (&acc)[NT][4]) {
  using Acc = typename Math<T>::Acc;
  constexpr int sa = a_stride<T>();
  constexpr int KC = Math<T>::KC;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr + g + 8 * h;
    Acc rs = Acc(0);
#pragma unroll
    for (int k = 0; k < KC / 4; k += 2) {
      const auto v = pair(As + row * sa + t * (KC / 4) + k);
      rs += v.x + v.y;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const int xr = i0 + row - kc0;
    const bool in = xr >= 0 && xr < KC;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      Acc v0 = rs, v1 = rs;
      if (in) {
        const auto v = pair(Xs + xr * sx + nt * 8 + 2 * t);
        v0 += v.x;
        v1 += v.y;
      }
      acc[nt][2 * h] += v0;
      acc[nt][2 * h + 1] += v1;
    }
  }
}

template <typename T, int TM, int TN, int RPC, int kVar, int kStore,
          bool kEvict, class Src>
__global__ void __launch_bounds__(TM * 2)
banded_spmm_kernel(const typename Elems<T>::Slab* __restrict__ blocks,
                   const typename Elems<T>::X* __restrict__ x, Src src,
                   typename Math<T>::Acc* __restrict__ y,
                   typename Math<T>::Acc* __restrict__ colsum, int nbr,
                   int bs, int K, int bw, int m, int col_tiles, int row_tiles,
                   int stages, int vec_a, int vec_x) {
  using Acc = typename Math<T>::Acc;
  using S = typename Elems<T>::Slab;
  using X = typename Elems<T>::X;
  constexpr int KC = Math<T>::KC;
  constexpr int NT = TN / 8;
  constexpr int SA = a_stride<T>();
  constexpr int SX = x_stride<X>(TN);
  constexpr int STAGE = stage_elems<T>(TM, TN, RPC);
  // A stage holds one block row's scales (the int8 slab).
  static_assert(!std::is_same<T, QInt8>::value ||
                    (RPC == 1 && kVar == kFull && kStore == kDirect),
                "int8 slabs: the full kernel at one block row a CTA");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const long long bid = blockIdx.x;
  const int ct = static_cast<int>(bid % col_tiles);
  const long long rest = bid / col_tiles;
  const int rt = static_cast<int>(rest % row_tiles);
  const long long r0 = src.block_row((rest / row_tiles) * RPC);
  const int i0 = rt * TM;
  const int c0 = ct * TN;
  const int warp = threadIdx.x >> 5;
  const int wr = warp * 16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long n = static_cast<long long>(nbr) * bs;
  const long long L = static_cast<long long>(K) * bs;

  if constexpr (kVar == kFull)
    before_walk(src, x, r0, i0, min(TM, bs - i0), c0, min(TN, m - c0), nbr,
                bs, bw, m, row_tiles * col_tiles);

  Acc acc[RPC][NT][4];
#pragma unroll
  for (int i = 0; i < RPC; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = Acc(0);

  if constexpr (kVar == kWriteOnly) {
#pragma unroll
    for (int i = 0; i < RPC; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][nt][e] = static_cast<Acc>(
              (r0 + i) * bs + i0 + wr + g + 8 * (e >> 1));
  } else {
    uint64_t policy = 0;
    if constexpr (kEvict)
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                   : "=l"(policy));
    const int chunks = (bs + KC - 1) / KC;
    const int Kw = window(src, RPC, K, bw);
    const int iters = Kw * chunks;
    const int rows_a = min(TM, bs - i0);
    const int vcols_x = min(TN, m - c0);

    auto load = [&](int it) {
      T* st = ring + static_cast<long long>(it % stages) * STAGE;
      X* xs = reinterpret_cast<X*>(st + RPC * TM * SA);
      const int j = it / chunks;
      const int kc0 = (it % chunks) * KC;
      const int vk = min(KC, bs - kc0);
      // x rows x_row(...) + [0, KC), from the source.
      src.template stage_x<KC, TN>(xs, SX, x,
                                   x_row(src, r0, j, bw, bs, kc0), vk, n, m,
                                   c0, vcols_x, vec_x != 0);
#pragma unroll
      for (int i = 0; i < RPC; ++i) {
        const int k = j - i;
        if (k < 0 || k >= K || r0 + i >= nbr) continue;
        const S* a_src = blocks + ((r0 + i) * bs + i0) * L + k * bs + kc0;
        stage_tile<S, kEvict>(reinterpret_cast<S*>(st + i * TM * SA), SA,
                              a_src, a_src, L, TM, KC, 0, rows_a,
                              vk, vec_a != 0, policy);
        stage_scales<KC>(src, reinterpret_cast<float*>(xs + KC * SX),
                         (r0 + i) * L + k * bs + kc0, vk, vec_a != 0);
      }
    };

    for (int s = 0; s < stages - 1; ++s) {
      if (s < iters) load(s);
      cp_commit();
    }
    for (int it = 0; it < iters; ++it) {
      cp_wait(stages - 2);
      __syncthreads();
      if (it + stages - 1 < iters) load(it + stages - 1);
      cp_commit();
      const T* st = ring + static_cast<long long>(it % stages) * STAGE;
      const X* Xs = reinterpret_cast<const X*>(st + RPC * TM * SA);
      const int j = it / chunks;
      const int kc0 = (it % chunks) * KC;
#pragma unroll
      for (int i = 0; i < RPC; ++i) {
        const int k = j - i;
        if (k < 0 || k >= K || r0 + i >= nbr) continue;
        if constexpr (kVar == kCopy) {
          stage_copy<T, NT>(st + i * TM * SA, Xs, SX, wr, i0, kc0, acc[i]);
        } else {
          stage_product<NT>(st + i * TM * SA, Xs, SX, wr, acc[i]);
        }
      }
    }
    cp_wait(0);
    __syncthreads();
    if constexpr (kVar == kFull)
      after_walk(src, r0, nbr, bw, row_tiles * col_tiles);
  }

  if constexpr (kVar == kNoY) {
    // Column sums of the tile: the two rows a thread holds, then the 8
    // row groups of the warp, then the warps in order.
    Acc* red = reinterpret_cast<Acc*>(smem_raw);  // (TM / 16, TN)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        Acc v = acc[0][nt][e] + acc[0][nt][2 + e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[warp * TN + nt * 8 + 2 * t + e] = v;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < TN; c += blockDim.x) {
      Acc s = Acc(0);
      for (int w = 0; w < TM / 16; ++w) s += red[w * TN + c];
      if (c0 + c < m) colsum[(r0 * row_tiles + rt) * m + c0 + c] = s;
    }
    return;
  }

  if constexpr (kStore == kTma) {
    // Y tile of each block row staged in shared memory (the ring is
    // drained), then one bulk copy a row.
    Acc* ys = reinterpret_cast<Acc*>(smem_raw);
#pragma unroll
    for (int i = 0; i < RPC; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ys[(i * TM + wr + g + 8 * (e >> 1)) * TN + nt * 8 + 2 * t + (e & 1)] =
              acc[i][nt][e];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int rows = min(TM, bs - i0);
    const int bytes = min(TN, m - c0) * static_cast<int>(sizeof(Acc));
    for (int e = threadIdx.x; e < RPC * TM; e += blockDim.x) {
      const int i = e / TM;
      const int row = e % TM;
      if (row >= rows || r0 + i >= nbr) continue;
      Acc* dst = y + ((r0 + i) * bs + i0 + row) * static_cast<long long>(m) + c0;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
              dst),
          "r"(smem_u32(ys + e * TN)), "r"(bytes)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    return;
  }

  const bool pair = (m & 1) == 0;
#pragma unroll
  for (int i = 0; i < RPC; ++i) {
    if (r0 + i >= nbr) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + wr + g + 8 * h;
      if (row >= bs) continue;
      Acc* out = y + ((r0 + i) * bs + row) * static_cast<long long>(m);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + nt * 8 + 2 * t;
        finish(src, x, (r0 + i) * bs + row, m, c, acc[i][nt][2 * h],
               acc[i][nt][2 * h + 1]);
        if (pair && c + 1 < m) {
          if constexpr (sizeof(Acc) == 8) {
            *reinterpret_cast<double2*>(out + c) =
                make_double2(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
          } else {
            *reinterpret_cast<float2*>(out + c) =
                make_float2(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
          }
        } else {
          if (c < m) out[c] = acc[i][nt][2 * h];
          if (c + 1 < m) out[c + 1] = acc[i][nt][2 * h + 1];
        }
      }
    }
  }
}

// Shared memory of one launch: the ring, and for kNoY / kTma the tile that
// reuses it after the walk.
template <typename T>
constexpr int smem_bytes(int tm, int tn, int rpc, int var, int store,
                         int stages) {
  using Acc = typename Math<T>::Acc;
  const int ring = var == kWriteOnly ? 0
                                     : stages * stage_elems<T>(tm, tn, rpc) *
                                           static_cast<int>(sizeof(T));
  int tile = 0;
  if (var == kNoY) tile = (tm / 16) * tn * static_cast<int>(sizeof(Acc));
  if (store == kTma) tile = rpc * tm * tn * static_cast<int>(sizeof(Acc));
  return ring > tile ? ring : tile;
}

// Ring depths: the most a caller may ask for, and the default.
constexpr int kMaxStages = 8;
constexpr int kDefaultStages = 4;

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The ring's depth and the dynamic shared memory of a launch on the current
// device. stages <= 0 takes the default: kDefaultStages, fewer where two
// blocks an SM would not fit (at 1 block an SM the stream ran at 0.6x the
// rate of two on an H100: the stages=6 split of chip_smoke.py).
template <typename T>
cudaError_t plan_ring(int tm, int tn, int rpc, int var, int store,
                      int& stages, int& smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  if (stages <= 0) {
    // The deepest ring up to kDefaultStages that leaves room for two
    // blocks an SM (one where even two stages do not).
    int per_sm = 0;
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    const int two = per_sm / 2 - 1024;  // 1 KB a block the runtime keeps
    const int cap =
        smem_bytes<T>(tm, tn, rpc, var, store, 2) <= two ? two : optin;
    stages = kDefaultStages;
    while (stages > 2 && smem_bytes<T>(tm, tn, rpc, var, store, stages) > cap)
      --stages;
  }
  if (stages < 2 || stages > kMaxStages) return cudaErrorInvalidValue;
  smem = smem_bytes<T>(tm, tn, rpc, var, store, stages);
  return smem > optin ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// One launch over `groups` grid rows of RPC block rows each (the source
// maps them to block rows), with the ring of plan_ring().
template <typename T, int TM, int TN, int RPC, int kVar, int kStore,
          bool kEvict, class Src>
cudaError_t launch_src(const typename Elems<T>::Slab* blocks,
                       const typename Elems<T>::X* x, Src src,
                       typename Math<T>::Acc* y, typename Math<T>::Acc* colsum,
                       int nbr, long long groups, int bs, int K, int bw, int m,
                       int stages, cudaStream_t stream) {
  using Acc = typename Math<T>::Acc;
  auto kernel = banded_spmm_kernel<T, TM, TN, RPC, kVar, kStore, kEvict, Src>;
  int smem = 0;
  cudaError_t err = plan_ring<T>(TM, TN, RPC, kVar, kStore, stages, smem);
  if (err != cudaSuccess) return err;
  if (kStore == kTma &&
      ((static_cast<long long>(m) * sizeof(Acc)) % 16 != 0 || !aligned16(y)))
    return cudaErrorInvalidValue;
  constexpr int VA = 16 / sizeof(typename Elems<T>::Slab);
  constexpr int VX = 16 / sizeof(typename Elems<T>::X);
  const int vec_a = aligned16(blocks) && bs % VA == 0;
  const int vec_x = aligned16(x) && src.aligned() && m % VX == 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (m + TN - 1) / TN;
  const int row_tiles = (bs + TM - 1) / TM;
  const long long grid = groups * row_tiles * col_tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), TM * 2, smem, stream>>>(
      blocks, x, src, y, colsum, nbr, bs, K, bw, m, col_tiles, row_tiles,
      stages, vec_a, vec_x);
  return cudaGetLastError();
}

// One launch over all nbr block rows with kernel 1's masked source.
template <typename T, int TM, int TN, int RPC, int kVar, int kStore,
          bool kEvict>
cudaError_t launch(const T* blocks, const T* x, typename Math<T>::Acc* y,
                   typename Math<T>::Acc* colsum, int nbr, int bs, int K,
                   int bw, int m, int stages, cudaStream_t stream) {
  return launch_src<T, TM, TN, RPC, kVar, kStore, kEvict>(
      blocks, x, Masked<T>{}, y, colsum, nbr, (nbr + RPC - 1) / RPC, bs, K, bw,
      m, stages, stream);
}

// The column tile of the full kernel at width m: the narrowest of 8, 16,
// 32, 48, 64 that covers m; above 64, 48 or 64, whichever pads m less.
inline int column_tile(int m) {
  if (m <= 8) return 8;
  if (m <= 16) return 16;
  if (m <= 32) return 32;
  if (m <= 48) return 48;
  if (m <= 64) return 64;
  const int p48 = (m + 47) / 48 * 48;
  const int p64 = (m + 63) / 64 * 64;
  return p48 < p64 ? 48 : 64;
}

// Row tile: 16 rows (one warp) for bs <= 16, else 128 (eight warps).
inline bool small_rows(int bs) { return bs <= 16; }

// The full kernel over `groups` block rows from the source (kernels 1, 2,
// 8 and kernel 6's cp.async route), at the row tile and column tile above.
template <typename T, int TM, class Src>
cudaError_t launch_full_tm(const T* blocks, const T* x, Src src,
                           typename Math<T>::Acc* y, int nbr, long long groups,
                           int bs, int K, int bw, int m, cudaStream_t s) {
  switch (column_tile(m)) {
    case 8:
      return launch_src<T, TM, 8, 1, kFull, kDirect, false>(blocks, x, src, y, nullptr, nbr, groups, bs, K, bw, m, 0, s);
    case 16:
      return launch_src<T, TM, 16, 1, kFull, kDirect, false>(blocks, x, src, y, nullptr, nbr, groups, bs, K, bw, m, 0, s);
    case 32:
      return launch_src<T, TM, 32, 1, kFull, kDirect, false>(blocks, x, src, y, nullptr, nbr, groups, bs, K, bw, m, 0, s);
    case 48:
      return launch_src<T, TM, 48, 1, kFull, kDirect, false>(blocks, x, src, y, nullptr, nbr, groups, bs, K, bw, m, 0, s);
    default:
      return launch_src<T, TM, 64, 1, kFull, kDirect, false>(blocks, x, src, y, nullptr, nbr, groups, bs, K, bw, m, 0, s);
  }
}

template <typename T, class Src>
cudaError_t launch_full(const T* blocks, const T* x, Src src,
                        typename Math<T>::Acc* y, int nbr, long long groups,
                        int bs, int K, int bw, int m, cudaStream_t s) {
  return small_rows(bs)
             ? launch_full_tm<T, 16>(blocks, x, src, y, nbr, groups, bs, K, bw, m, s)
             : launch_full_tm<T, 128>(blocks, x, src, y, nbr, groups, bs, K, bw, m, s);
}

// -- the int8 entries (q_spmm_f64.cu, q_ext_spmm_f64.cu) -------------------

// The column tile of the int8 entries at width m: 8, 16, 24 or 40, the
// narrowest that covers m (the lowest-20 solve's m = 20 and 40 in 3 and 5
// n8 tiles, none padded); above 40, 40 or 64, whichever pads m less.
inline int q8_column_tile(int m) {
  if (m <= 8) return 8;
  if (m <= 16) return 16;
  if (m <= 24) return 24;
  if (m <= 40) return 40;
  const int p40 = (m + 39) / 40 * 40;
  const int p64 = (m + 63) / 64 * 64;
  return p40 < p64 ? 40 : 64;
}

template <int TM, class Src>
cudaError_t launch_q8_tm(const int8_t* q, const double* x, Src src,
                         double* y, int nbr, int bs, int K, int bw, int m,
                         cudaStream_t s) {
  switch (q8_column_tile(m)) {
    case 8:
      return launch_src<QInt8, TM, 8, 1, kFull, kDirect, false>(q, x, src, y, nullptr, nbr, nbr, bs, K, bw, m, 0, s);
    case 16:
      return launch_src<QInt8, TM, 16, 1, kFull, kDirect, false>(q, x, src, y, nullptr, nbr, nbr, bs, K, bw, m, 0, s);
    case 24:
      return launch_src<QInt8, TM, 24, 1, kFull, kDirect, false>(q, x, src, y, nullptr, nbr, nbr, bs, K, bw, m, 0, s);
    case 40:
      return launch_src<QInt8, TM, 40, 1, kFull, kDirect, false>(q, x, src, y, nullptr, nbr, nbr, bs, K, bw, m, 0, s);
    default:
      return launch_src<QInt8, TM, 64, 1, kFull, kDirect, false>(q, x, src, y, nullptr, nbr, nbr, bs, K, bw, m, 0, s);
  }
}

// One launch of an int8 entry over all nbr block rows (grid row g is block
// row g of the source), at kernel 1's row tile; returns a cudaError_t as
// int.
template <class Src>
int launch_q8(const int8_t* q, const double* x, Src src, double* y, int nbr,
              int bs, int K, int bw, int m, void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      small_rows(bs) ? launch_q8_tm<16>(q, x, src, y, nbr, bs, K, bw, m, s)
                     : launch_q8_tm<128>(q, x, src, y, nbr, bs, K, bw, m, s));
}

// -- measurement variants (banded_spmm_var_*.cu) ---------------------------

// The column tile of a variant: 16 up to m = 16, then 48 up to 48, else
// 64 (the full kernel's at the main case and the probe shape); 32 at most
// at RPC = 2 and 16 at RPC = 4, so that RPC accumulator sets fit the
// registers.
inline int variant_tile(int m, int rpc) {
  if (rpc == 4 || m <= 16) return 16;
  if (rpc == 2) return 32;
  return m <= 48 ? 48 : 64;
}

template <typename T, int TM, int RPC, int kVar, int kStore, bool kEvict>
cudaError_t variant_width(const T* blocks, const T* x,
                          typename Math<T>::Acc* y,
                          typename Math<T>::Acc* colsum, int nbr, int bs,
                          int K, int bw, int m, int stages, cudaStream_t s) {
  const int tn = variant_tile(m, RPC);
  if (tn == 16)
    return launch<T, TM, 16, RPC, kVar, kStore, kEvict>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
  if constexpr (RPC == 2)
    return launch<T, TM, 32, RPC, kVar, kStore, kEvict>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
  if constexpr (RPC == 1) {
    if (tn == 48)
      return launch<T, TM, 48, RPC, kVar, kStore, kEvict>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    return launch<T, TM, 64, RPC, kVar, kStore, kEvict>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
  }
  return cudaErrorInvalidValue;
}

// One variant launch; combinations that are not instantiated return
// cudaErrorInvalidValue (kernels.banded_spmm_variant refuses them first).
// kCopy: every type, any bs, the full kernel's other parameters; the rest
// (f64 and bf16, bs > 16): kNoY and kWriteOnly alone, and kFull with at
// most one of rpc in {2, 4}, store = kTma, evict = 1.
template <typename T>
int variant(const T* blocks, const T* x, typename Math<T>::Acc* y,
            typename Math<T>::Acc* colsum, int nbr, int bs, int K, int bw,
            int m, int var, int rpc, int stages, int store, int evict,
            void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool plain = rpc == 1 && store == kDirect && evict == 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (var == kCopy && plain) {
    err = small_rows(bs)
              ? variant_width<T, 16, 1, kCopy, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s)
              : variant_width<T, 128, 1, kCopy, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
  } else if constexpr (!std::is_same<T, float>::value) {
    if (small_rows(bs)) return static_cast<int>(cudaErrorInvalidValue);
    if (var == kNoY && plain) {
      err = variant_width<T, 128, 1, kNoY, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kWriteOnly && plain) {
      err = variant_width<T, 128, 1, kWriteOnly, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kFull && plain) {
      err = variant_width<T, 128, 1, kFull, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kFull && rpc == 2 && store == kDirect && evict == 0) {
      err = variant_width<T, 128, 2, kFull, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kFull && rpc == 4 && store == kDirect && evict == 0) {
      err = variant_width<T, 128, 4, kFull, kDirect, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kFull && rpc == 1 && store == kTma && evict == 0) {
      err = variant_width<T, 128, 1, kFull, kTma, false>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    } else if (var == kFull && rpc == 1 && store == kDirect && evict == 1) {
      err = variant_width<T, 128, 1, kFull, kDirect, true>(blocks, x, y, colsum, nbr, bs, K, bw, m, stages, s);
    }
  }
  return static_cast<int>(err);
}

// The layout of a launch at (bs, m) on the current device, as launch()
// takes it (kernels.banded_spmm_plan): out = {row tile, column tile, ring
// depth, dynamic shared memory bytes}. kernel1 != 0: kernel 1 itself
// (column_tile); else the variant var with rpc and store (variant_tile).
template <typename T>
int plan_entry(int kernel1, int bs, int m, int var, int rpc, int store,
               int stages, int* out) {
  const int tm = small_rows(bs) ? 16 : 128;
  const int tn = kernel1 ? column_tile(m) : variant_tile(m, rpc);
  if (kernel1) {
    var = kFull;
    rpc = 1;
    store = kDirect;
  }
  int smem = 0;
  const cudaError_t err = plan_ring<T>(tm, tn, rpc, var, store, stages, smem);
  out[0] = tm;
  out[1] = tn;
  out[2] = stages;
  out[3] = smem;
  return static_cast<int>(err);
}

}  // namespace fdt1
