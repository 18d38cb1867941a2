// The tensor-core banded apply for Hopper (sm_90a), shared by the float32
// fused SpMM + Gram kernels (fused_gram.cu: kernel 3's float32 entry and
// kernel 5) and the float32 entries of kernels 4 and 7 (q_spmm.cu): the
// layouts, the cp.async staging of slab and x chunks, the slab loaders
// (DenseF32, Int8) and one pass of the apply. Storage: (nbr, bs, K*bs)
// row-major block slabs, slot k of block row r holding block column
// r - bw + k. What bounds each kernel and what its design does about it are
// written at the top of its translation unit.
//
// The apply (apply_pass): one 256-thread block computes ntile 16-row tiles
// of one block row's Y at a column tile of TN; warp w takes AU (16 x 8)
// units of one row tile. The slab chunks (KC deep) and the x chunks of the
// block row's in-range slots stream through a ring of kNA shared-memory
// stages (cp.async, 16-byte copies where the source allows), the next
// kNA - 1 in flight while one is multiplied on mma.sync m16n8k8 TF32 with
// f32 sums:
// - float32 blocks (3xTF32): each operand splits into hi = tf32(a) and
//   lo = tf32(a - hi), rounded as cvt.rna does, and a*b is lo*hi + hi*lo +
//   hi*hi;
// - int8 blocks slot by slot: |q| <= 127 is exact in TF32, so Q_k @ x_k is
//   two TF32 products (x hi and lo) into the slot's f32 partial, which the
//   slot's f32 scale multiplies into the sum.
// The slots a pass applies are the caller's (klo and n_chunks): kernel 4
// skips those whose block column lies outside [0, nbr) (their blocks are
// zero), so it reads no x row outside [0, n) and 0 * Inf never enters the
// sum; kernel 7 applies all K over its halo-extended x, whose every window
// is valid. Columns past m and rows past bs are staged as zeros and never
// loaded. Each output element is summed in a fixed order, whatever the
// column tile or the depth of a chunk: the same inputs give the same bits,
// and kernels 4 and 5 give the same Y.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "reduce_partials.cuh"

namespace {
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = 8;
constexpr int kNA = 4;         // apply: ring stages (slab and x chunks)

// Layout by column tile width. Gram: WN warps along N with NT n-tiles
// each, WM = 8 / WN warps along M with MT m-tiles each, interleaved (warp
// wm takes m-tiles wm, wm + WM, ...; MT * NT * 4 f32 accumulators a
// thread). Apply: AU (16 x 8) output tiles of one row tile a warp per
// pass, KC rows of depth a chunk (deeper where the x chunk is narrow).
template <int TN> struct Warps;
template <> struct Warps<8> {
  static constexpr int WN = 1, NT = 1, MT = 12, AU = 1, KC = 64;
};
template <> struct Warps<16> {
  static constexpr int WN = 1, NT = 2, MT = 8, AU = 2, KC = 64;
};
template <> struct Warps<24> {
  static constexpr int WN = 1, NT = 3, MT = 6, AU = 3, KC = 64;
};
template <> struct Warps<32> {
  static constexpr int WN = 1, NT = 4, MT = 5, AU = 4, KC = 64;
};
template <> struct Warps<64> {
  static constexpr int WN = 2, NT = 4, MT = 5, AU = 2, KC = 32;
};
template <> struct Warps<128> {
  static constexpr int WN = 4, NT = 4, MT = 6, AU = 2, KC = 32;
};

// Row strides of a staged slab chunk KC deep, conflict-free for the A
// fragments (row = g, column = t): f32 floats, and int8 bytes.
__host__ __device__ constexpr int a_stride_f32(int kc) { return kc + 4; }
__host__ __device__ constexpr int a_stride_i8(int kc) { return kc == 64 ? 80 : 48; }

// Rows of G one block holds in registers at column tile width TN.
template <int TN>
constexpr int cap_rows() {
  return (kWarps / Warps<TN>::WN) * Warps<TN>::MT * 16;
}

// Row stride (floats) of a [k][col] tile read as mma fragments at (k = t,
// col = g): stride = 8 (mod 32) puts the 32 lanes on 32 banks.
__host__ __device__ constexpr int frag_stride(int cols) {
  return cols + ((8 - cols % 32) + 32) % 32;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// f rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// the rounding of cvt.rna.tf32.f32, bit for bit on finite values, as two
// integer operations (the conversion unit's rate would bound the gram).
__device__ __forceinline__ uint32_t tf32(float f) {
  return (__float_as_uint(f) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float f, uint32_t& hi, uint32_t& lo) {
  hi = tf32(f);
  lo = tf32(f - __uint_as_float(hi));
}
// d += a @ b, one m16n8k8 TF32 product with f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// Copy the 16 bytes at s to d (16-byte aligned), `valid` floats of them
// readable, the rest zeros: one 16-byte copy where the source allows,
// 4-byte copies otherwise.
__device__ __forceinline__ void quad_f32(float* d, const float* s, int valid) {
  if (valid <= 0) {
    *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (valid >= 4 && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    cp16(d, s);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < valid)
        cp4(d + j, s + j);
      else
        d[j] = 0.f;
    }
  }
}

// Source row of staged row i: 16-row tiles `tstride` rows apart (tstride
// = 16: contiguous).
__device__ __forceinline__ int tile_row(int i, int tstride) {
  return (i >> 4) * tstride + (i & 15);
}

// Stage rows x COLS floats (COLS a multiple of 4) from src (row stride ld
// floats, `valid_cols` of them readable; staged row i is source row
// tile_row(i, tstride)) into dst (row stride dp floats, 16-byte aligned
// rows); source rows >= valid_rows and columns >= valid_cols are zeros.
template <int COLS>
__device__ __forceinline__ void stage_f32(float* dst, int dp, const float* src,
                                          long long ld, int rows, int tstride,
                                          int valid_rows, int valid_cols) {
  constexpr int quads = COLS / 4;
  for (int e = threadIdx.x; e < rows * quads; e += kThreads) {
    const int i = e / quads;
    const int c = (e % quads) * 4;
    const int sr = tile_row(i, tstride);
    quad_f32(dst + i * dp + c, src + sr * ld + c,
             sr < valid_rows ? valid_cols - c : 0);
  }
}

// The same for int8 (COLS a multiple of 16 bytes): 16-, 4- or 1-byte copies.
template <int COLS>
__device__ __forceinline__ void stage_i8(int8_t* dst, int dp, const int8_t* src,
                                         long long ld, int rows, int tstride,
                                         int valid_rows, int valid_cols) {
  constexpr int chunks = COLS / 16;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int i = e / chunks;
    const int c = (e % chunks) * 16;
    const int sr = tile_row(i, tstride);
    int8_t* d = dst + i * dp + c;
    if (sr >= valid_rows || c >= valid_cols) {
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      continue;
    }
    const int8_t* s = src + sr * ld + c;
    const uintptr_t a = reinterpret_cast<uintptr_t>(s);
    if (c + 16 <= valid_cols && (a & 15) == 0) {
      cp16(d, s);
    } else if ((a & 3) == 0) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        if (c + j + 4 <= valid_cols) {
          cp4(d + j, s + j);
        } else {
          for (int b = j; b < j + 4; ++b) d[b] = c + b < valid_cols ? s[b] : 0;
        }
      }
    } else {
      for (int b = 0; b < 16; ++b) d[b] = c + b < valid_cols ? s[b] : 0;
    }
  }
}

// Dense float32 blocks: the slab chunk staged as f32, fragments split.
struct DenseF32 {
  static constexpr bool kQuant = false;
  // Depth a chunk: f32 chunks are 4 bytes an element, so shallower.
  template <int TN>
  __host__ __device__ static constexpr int kc() {
    return Warps<TN>::KC < 32 ? Warps<TN>::KC : 32;
  }
  template <int KC>
  __host__ __device__ static constexpr int row_bytes() { return a_stride_f32(KC) * 4; }
  const float* blocks;
  // `rows` rows of block row r's slab, 16-row tiles from row i0 on,
  // tstride rows apart; columns col .. col + kc (KC staged, the rest
  // zeros, as are rows past bs).
  template <int KC>
  __device__ __forceinline__ void stage(unsigned char* as, long long r, int i0,
                                        int rows, int tstride, int bs, int L,
                                        int col, int kc) const {
    stage_f32<KC>(reinterpret_cast<float*>(as), a_stride_f32(KC),
                  blocks + (r * bs + i0) * static_cast<long long>(L) + col, L,
                  rows, tstride, bs - i0, kc);
  }
  // A fragment (rows ra, ra + 8; columns ka, ka + 4) of the staged chunk.
  template <int KC>
  __device__ __forceinline__ void frag(const unsigned char* as, int ra, int ka,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    constexpr int P = a_stride_f32(KC);
    const float* a = reinterpret_cast<const float*>(as);
    split(a[ra * P + ka], hi[0], lo[0]);
    split(a[(ra + 8) * P + ka], hi[1], lo[1]);
    split(a[ra * P + ka + 4], hi[2], lo[2]);
    split(a[(ra + 8) * P + ka + 4], hi[3], lo[3]);
  }
};

// The bits of float(q), exactly, in two full-rate operations (1.5 * 2^23
// + q, less 1.5 * 2^23) in place of the conversion unit's I2F.
__device__ __forceinline__ uint32_t i8_to_f32(int8_t q) {
  return __float_as_uint(__int_as_float(0x4B400000 + q) - 12582912.f);
}

// int8 blocks with one f32 scale per (block row, slot), stored broadcast as
// scale[r, l], and the exact f32 diagonal: the slab chunk staged as bytes;
// q is exact in TF32 (lo is zero).
struct Int8 {
  static constexpr bool kQuant = true;
  template <int TN>
  __host__ __device__ static constexpr int kc() { return Warps<TN>::KC; }
  template <int KC>
  __host__ __device__ static constexpr int row_bytes() { return a_stride_i8(KC); }
  const int8_t* q;
  const float* scale;
  const float* diag;
  template <int KC>
  __device__ __forceinline__ void stage(unsigned char* as, long long r, int i0,
                                        int rows, int tstride, int bs, int L,
                                        int col, int kc) const {
    stage_i8<KC>(reinterpret_cast<int8_t*>(as), a_stride_i8(KC),
                 q + (r * bs + i0) * static_cast<long long>(L) + col, L, rows,
                 tstride, bs - i0, kc);
  }
  template <int KC>
  __device__ __forceinline__ void frag(const unsigned char* as, int ra, int ka,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    constexpr int P = a_stride_i8(KC);
    const int8_t* a = reinterpret_cast<const int8_t*>(as);
    hi[0] = i8_to_f32(a[ra * P + ka]);
    hi[1] = i8_to_f32(a[(ra + 8) * P + ka]);
    hi[2] = i8_to_f32(a[ra * P + ka + 4]);
    hi[3] = i8_to_f32(a[(ra + 8) * P + ka + 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j) lo[j] = 0u;
  }
};

// One pass of the apply: acc = the units of this warp (row tile lt_w of the
// pass, n-tiles nt_w .. nt_w + AU - 1) at block row rr and column tile c0.
// The pass's ntile row tiles are staged from slab row i0 on, 16-row tiles
// tstride rows apart; the chunks are those of the slots klo, klo + 1, ...
// that the caller applies (n_chunks of them, cps = ceil(bs / KC) a slot)
// through the ring (as: kNA stages of a_bytes; xs: kNA stages of KC rows
// of YP floats). Returns with every copy landed; d o x is the caller's.
template <class Ld, int TN>
__device__ __forceinline__ void apply_pass(
    const Ld& ld, const float* x, long long rr, int i0, int tstride,
    int ntile, int bs, int L, int m, int c0, int bw, int klo, int n_chunks,
    unsigned char* as, float* xs, int a_bytes, int YP, int lt_w, int nt_w,
    float (&acc)[Warps<TN>::AU][4]) {
  constexpr int KC = Ld::template kc<TN>();
  constexpr int AU = Warps<TN>::AU;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cps = (bs + KC - 1) / KC;  // depth chunks per slot
  // Chunk it (slot klo + it / cps, depth d0) into ring stage it % kNA.
  auto issue_chunk = [&](int it) {
    if (it < n_chunks) {
      const int k = klo + it / cps;
      const int d0 = (it % cps) * KC;
      const int kc = min(KC, bs - d0);
      const int b = it % kNA;
      unsigned char* ab = as + b * a_bytes;
      ld.template stage<KC>(ab, rr, i0, ntile * 16, tstride, bs, L,
                            k * bs + d0, kc);
      const long long xr = (rr - bw + k) * bs + d0;
      stage_f32<TN>(xs + b * KC * YP, YP, x + xr * m + c0, m, KC, 16, kc,
                    m - c0);
    }
    commit();
  };
  // Independent accumulators, so that the units' and the products'
  // mma chains interleave: dense, acc += hi*hi and cor += the two
  // correction products; int8, part += Q x_hi and cor += Q x_lo, added
  // into acc with the slot's scale.
  float part[AU][4];
  float cor[AU][4];
#pragma unroll
  for (int a = 0; a < AU; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = part[a][e] = cor[a][e] = 0.f;

  __syncthreads();  // the ring's stages are free (previous pass, row)
#pragma unroll
  for (int it = 0; it < kNA - 1; ++it) issue_chunk(it);
  for (int it = 0; it < n_chunks; ++it) {
    wait_group<kNA - 2>();
    __syncthreads();  // chunk it landed; chunk it - 1's stage is free
    issue_chunk(it + kNA - 1);
    const unsigned char* ab = as + (it % kNA) * a_bytes;
    const float* xb = xs + (it % kNA) * KC * YP;
    const int d0 = (it % cps) * KC;
    // Branch-free, so that loads and products interleave: every k-step
    // of the chunk (past kc the staged rows are zeros), one A fragment
    // for the warp's AU units (one row tile; a warp past the pass's
    // last unit repeats the last tile, and the epilogue drops it).
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      uint32_t ah[4], al[4], bh[AU][2], bl[AU][2];
      ld.template frag<KC>(ab, lt_w * 16 + g, ks * 8 + t, ah, al);
#pragma unroll
      for (int a = 0; a < AU; ++a) {
        const int n = (nt_w + a) * 8 + g;
        split(xb[(ks * 8 + t) * YP + n], bh[a][0], bl[a][0]);
        split(xb[(ks * 8 + t + 4) * YP + n], bh[a][1], bl[a][1]);
      }
#pragma unroll
      for (int a = 0; a < AU; ++a) {
        if constexpr (Ld::kQuant) {
          mma(part[a], ah, bh[a]);
          mma(cor[a], ah, bl[a]);
        } else {
          mma(cor[a], al, bh[a]);
          mma(cor[a], ah, bl[a]);
          mma(acc[a], ah, bh[a]);
        }
      }
    }
    if constexpr (Ld::kQuant) {
      if (d0 + KC >= bs) {  // the slot's last chunk: apply its scale
        const int k = klo + it / cps;
        const float s = ld.scale[rr * L + k * bs];
#pragma unroll
        for (int a = 0; a < AU; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[a][e] += s * (part[a][e] + cor[a][e]);
            part[a][e] = cor[a][e] = 0.f;
          }
      }
    }
  }
  if constexpr (!Ld::kQuant) {
#pragma unroll
    for (int a = 0; a < AU; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] += cor[a][e];
  }
  wait_group<0>();
}

}  // namespace
