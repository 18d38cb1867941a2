// Kernel 6, the DIA-banded SpMM over a shard's halo-extended input, for
// Hopper (sm_90a), in plain CUDA C++ with a C interface (loaded with ctypes
// by fortran_davidson_tpu_torch/ops/kernels.py), on kernel 1's design
// (banded_spmm.cuh).
//
//   fdt_banded_ext_bsr_spmm_*   replaces banded_ext_bsr_spmm
//       (fortran_davidson_tpu/ops/pallas_kernels.py:1190, body :1130):
//       Y = A_local X for a shard's nbr DIA-banded block rows over x_ext,
//       ((nbr + 2bw) bs, m): the shard's rows framed by bw*bs rows of each
//       ring neighbour (parallel/halo.py), so every window
//       x_ext[r bs, (r + K) bs) of block row r is valid.
//   fdt_ext_spmm_plan           the layout of a launch (kernels.ext_spmm_plan).
//
// Types as kernel 1: f64 on DMMA, f32 on FFMA, bf16 storage on mma.sync
// summed in f32 (Y written in the accumulation type). At the ring's two
// ends the wrapped halo rows meet the zero blocks of out-of-range slots,
// as in the TPU kernel.
//
// What bounds it on the H100: kernel 1's bytes plus the 2*bw*bs*m halo
// rows (the slab once, x_ext once, Y once): 1.162 ms at f64 m=40 on the
// 1M-row matrix at 3.35 TB/s, HBM at the solver's widths (chip_smoke.py
// _bound). Kernel 1's copy variant, which reads kernel 1's bytes and only
// adds, reaches 66-75% of that rate on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): kernel 1's per-thread cp.async stream, not its products,
// sets its pace.
//
// Two routes, one per launch, chosen by the caller from the shape and the
// alignment before the launch (kernels.ext_spmm_route; this file refuses
// a "tma" launch whose operands break the rule, it never falls back):
// - kTma (bs a multiple of the row tile and of the chunk depth KC, m times
//   the element size a multiple of 16 bytes, both bases 16-byte aligned):
//   the stream by the Tensor Memory Accelerator. A block row's slab is one
//   contiguous (bs, K*bs) region and its window a contiguous row range of
//   x_ext, read unmasked, so each chunk is two tensor-map boxes: the
//   (TM, KC) slab chunk, 128-byte rows swizzled (SWIZZLE_128B for f64,
//   64B for f32 and bf16: the A fragments read conflict-free), and the
//   (KC, TN) x chunk as TN/8 boxes of 8 columns, each (KC, 8) box
//   contiguous, so the B fragments read conflict-free unswizzled. One
//   producer warp issues the boxes of every chunk into a ring of stages
//   (mbarrier expect-tx / complete-tx); TM/16 consumer warps run kernel
//   1's fragment loop on them and free each stage with one arrive a warp,
//   after a proxy fence in every lane (the next TMA write to the stage
//   must not land under a load still in flight).
//   Blocks are persistent (as many as the card holds) and walk the tiles
//   (block row, row tile, column tile) in kernel 1's order, the producer
//   running ahead across tiles, so one tile's epilogue overlaps the next
//   tile's loads. The tensor maps are encoded on the host for every call
//   (x_ext is a new tensor each apply), by cuTensorMapEncodeTiled, taken
//   from libcuda.so.1, which the process has loaded.
// - kCpAsync (every other shape): kernel 1's template with the Inside
//   source, x at the centre of x_ext, read unmasked: the halo rows are
//   where kernel 1's masked source would zero them.
// Both compute kernel 1's products in kernel 1's order of sums (the
// fragment loop is stage_product's, only the shared-memory addresses
// differ), so a shard's rows put together give kernel 1's bits on the
// whole matrix in every type.

#include <cuda.h>
#include <dlfcn.h>

#include "banded_spmm.cuh"

namespace {

using fdt1::Bf16;
using fdt1::Math;
using fdt1::smem_u32;

enum Route { kCpAsync = 0, kTma = 1 };

// -- the TMA route -----------------------------------------------------

constexpr int kTmaMaxStages = 8;
constexpr int kTmaStages = 4;  // the default ring depth, as kernel 1's

// Bytes of one slab-chunk row (KC elements): 128 (f64) or 64 (f32, bf16),
// the swizzle span of the slab's tensor map.
template <typename T>
__host__ __device__ constexpr int row_bytes() {
  return Math<T>::KC * static_cast<int>(sizeof(T));
}

// Byte offset of element (r, c) in a slab chunk staged with the swizzle
// of its row width: 16-byte unit bits [4, 7) xor address bits [7, 10)
// (SWIZZLE_128B), or bits [4, 6) xor [7, 9) (SWIZZLE_64B), of a stage
// aligned to 1024 bytes.
template <typename T>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int RB = row_bytes<T>();
  const int off = r * RB + c * static_cast<int>(sizeof(T));
  return off ^ (((off >> 7) & (RB == 128 ? 7 : 3)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that has not ended after 2^35 clocks (over 15 s) traps, so that a
// fault shows as a launch error, not a card that hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}
// One 2-D box of `map` at (column c0, row c1) into shared memory at dst;
// its bytes complete a transaction of the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// acc += A[wr:wr+16, :KC] @ X[:KC, :TN] on one stage: kernel 1's
// stage_product, with A read through the swizzle and X as TN/8 (KC, 8)
// boxes.
template <int NT>
__device__ __forceinline__ void tma_product(const unsigned char* As,
                                            const double* Xs, int wr,
                                            double (&acc)[NT][4]) {
  constexpr int KC = Math<double>::KC;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KC / 4; ++ks) {
    double b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = Xs[(nt * KC + ks * 4 + t) * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const double a = *reinterpret_cast<const double*>(
          As + swz<double>(wr + mt * 8 + g, ks * 4 + t));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        fdt1::dmma(acc[nt][2 * mt], acc[nt][2 * mt + 1], a, b[nt]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void tma_product(const unsigned char* As,
                                            const float* Xs, int wr,
                                            float (&acc)[NT][4]) {
  constexpr int KC = Math<float>::KC;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < KC; ++k) {
    const float a0 = *reinterpret_cast<const float*>(As + swz<float>(wr + g, k));
    const float a1 =
        *reinterpret_cast<const float*>(As + swz<float>(wr + g + 8, k));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 b =
          *reinterpret_cast<const float2*>(Xs + (nt * KC + k) * 8 + 2 * t);
      acc[nt][0] = fmaf(a0, b.x, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b.y, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b.x, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b.y, acc[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void tma_product(const unsigned char* As,
                                            const Bf16* Xs, int wr,
                                            float (&acc)[NT][4]) {
  constexpr int KC = Math<Bf16>::KC;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  auto word = [&](int r, int c) {
    return *reinterpret_cast<const uint32_t*>(As + swz<Bf16>(r, c));
  };
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    const uint32_t a[4] = {word(wr + g, c), word(wr + g + 8, c),
                           word(wr + g, c + 8), word(wr + g + 8, c + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      fdt1::b_frag(Xs + (nt * KC + ks * 16 + (lane & 15)) * 8, b0, b1);
      fdt1::bmma(acc[nt], a, b0, b1);
    }
  }
}

// Bytes of one stage: the (TM, KC) slab chunk and TN/8 (KC, 8) x boxes,
// rounded up to the 1024-byte alignment of the slab's swizzle.
template <typename T>
__host__ __device__ constexpr int tma_stage_bytes(int tm, int tn) {
  const int bytes = tm * row_bytes<T>() +
                    (tn / 8) * Math<T>::KC * 8 * static_cast<int>(sizeof(T));
  return (bytes + 1023) / 1024 * 1024;
}
// Dynamic shared memory of a launch: the ring, and 1024 bytes to align it.
template <typename T>
constexpr int tma_smem_bytes(int tm, int tn, int stages) {
  return stages * tma_stage_bytes<T>(tm, tn) + 1024;
}

// Persistent blocks over the tiles (block row r, row tile, column tile),
// tile = r * row_tiles * col_tiles + rt * col_tiles + ct as kernel 1's
// grid orders them. Warps 0 .. TM/16 - 1 consume, warp TM/16 produces.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(TM * 2 + 32)
ext_tma_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_x,
               typename Math<T>::Acc* __restrict__ y, int nbr, int bs, int K,
               int m, int col_tiles, int row_tiles, int stages) {
  using Acc = typename Math<T>::Acc;
  constexpr int KC = Math<T>::KC;
  constexpr int NT = TN / 8;
  constexpr int kConsumers = TM / 16;
  constexpr int A_BYTES = TM * row_bytes<T>();
  constexpr int XB_BYTES = KC * 8 * static_cast<int>(sizeof(T));
  constexpr int STAGE = tma_stage_bytes<T>(TM, TN);
  __shared__ __align__(8) uint64_t bars[2 * kTmaMaxStages];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* ring = smem_raw + (base - raw);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8u * kTmaMaxStages;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8u * s, 1);
      mbar_init(empty0 + 8u * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int chunks = bs / KC;
  const int iters = K * chunks;
  const long long tiles =
      static_cast<long long>(nbr) * row_tiles * col_tiles;

  if (warp == kConsumers) {
    // The producer: one thread issues every chunk's boxes, a stage ahead
    // of the consumers as far as the ring allows, across tiles.
    if (lane != 0) return;
    int s = 0;
    uint32_t phase = 0;
    bool wrapped = false;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int ct = static_cast<int>(tile % col_tiles);
      const long long rest = tile / col_tiles;
      const int i0 = static_cast<int>(rest % row_tiles) * TM;
      const int r = static_cast<int>(rest / row_tiles);
      const int c0 = ct * TN;
      const int nx = min(NT, (m - c0 + 7) / 8);  // boxes with a column < m
      const uint32_t bytes = A_BYTES + nx * XB_BYTES;
      for (int it = 0; it < iters; ++it) {
        if (wrapped) mbar_wait(empty0 + 8u * s, phase ^ 1u);
        const uint32_t full = full0 + 8u * s;
        const uint32_t st = base + static_cast<uint32_t>(s) * STAGE;
        const int k = it / chunks;
        const int kc0 = (it % chunks) * KC;
        mbar_expect(full, bytes);
        tma_load(st, &map_a, k * bs + kc0, r * bs + i0, full);
        // Window rows of slot k: x_ext row (r + k) * bs + kc0.
        const int xr = (r + k) * bs + kc0;
        for (int j = 0; j < nx; ++j)
          tma_load(st + A_BYTES + j * XB_BYTES, &map_x, c0 + 8 * j, xr, full);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
          wrapped = true;
        }
      }
    }
    return;
  }

  const int wr = warp * 16;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool pair = (m & 1) == 0;
  int s = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ct = static_cast<int>(tile % col_tiles);
    const long long rest = tile / col_tiles;
    const int i0 = static_cast<int>(rest % row_tiles) * TM;
    const long long r = rest / row_tiles;
    const int c0 = ct * TN;
    Acc acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = Acc(0);
    for (int it = 0; it < iters; ++it) {
      mbar_wait(full0 + 8u * s, phase);
      const unsigned char* st = ring + static_cast<long long>(s) * STAGE;
      tma_product<NT>(st, reinterpret_cast<const T*>(st + A_BYTES), wr, acc);
      // The stage is free only once every lane's reads of it are done.
      // The producer's next write to it is a TMA (async-proxy) access,
      // which the barrier's release does not order after this lane's
      // generic-proxy loads: ptxas issues the arrive while the last loads'
      // data is still on its way, and the new box could land under them.
      // The proxy fence waits for them (scripts/tma_stress.py).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8u * s);
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    // Kernel 1's epilogue: Y from registers.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = i0 + wr + g + 8 * h;
      if (row >= bs) continue;
      Acc* out = y + (r * bs + row) * static_cast<long long>(m);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + nt * 8 + 2 * t;
        if (pair && c + 1 < m) {
          if constexpr (sizeof(Acc) == 8) {
            *reinterpret_cast<double2*>(out + c) =
                make_double2(acc[nt][2 * h], acc[nt][2 * h + 1]);
          } else {
            *reinterpret_cast<float2*>(out + c) =
                make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
          }
        } else {
          if (c < m) out[c] = acc[nt][2 * h];
          if (c + 1 < m) out[c + 1] = acc[nt][2 * h + 1];
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from libcuda.so.1, which the process has loaded
// (PyTorch loads it), so the library links against nothing more.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_type();
template <> constexpr CUtensorMapDataType tma_type<double>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
}
template <> constexpr CUtensorMapDataType tma_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType tma_type<Bf16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A row-major (rows, cols) tensor as a 2-D map with (box_rows, box_cols)
// boxes; elements past the edges load as zeros.
template <typename T>
cudaError_t encode(CUtensorMap* map, const T* base, long long rows,
                   long long cols, int box_rows, int box_cols,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res =
      fn(map, tma_type<T>(), 2, const_cast<T*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The ring's depth and dynamic shared memory of a TMA launch on the current
// device: kTmaStages, fewer where two blocks an SM would not fit.
template <typename T>
cudaError_t plan_tma(int tm, int tn, int& stages, int& smem) {
  int dev = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int two = per_sm / 2 - 1024;  // 1 KB a block the runtime keeps
  const int cap = tma_smem_bytes<T>(tm, tn, 2) <= two ? two : optin;
  stages = kTmaStages;
  while (stages > 2 && tma_smem_bytes<T>(tm, tn, stages) > cap) --stages;
  smem = tma_smem_bytes<T>(tm, tn, stages);
  return smem > optin ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The rule of the TMA route (kernels.ext_spmm_route is its Python form).
template <typename T>
bool tma_fits(const T* blocks, const T* x_ext, int bs, int m) {
  const int tm = fdt1::small_rows(bs) ? 16 : 128;
  return bs % tm == 0 && bs % Math<T>::KC == 0 &&
         (static_cast<long long>(m) * sizeof(T)) % 16 == 0 &&
         fdt1::aligned16(blocks) && fdt1::aligned16(x_ext);
}

template <typename T, int TM, int TN>
cudaError_t launch_tma_tn(const T* blocks, const T* x_ext,
                          typename Math<T>::Acc* y, int nbr, int bs, int K,
                          int bw, int m, cudaStream_t s) {
  constexpr int KC = Math<T>::KC;
  int stages = 0, smem = 0;
  cudaError_t err = plan_tma<T>(TM, TN, stages, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_x;
  err = encode(&map_a, blocks, static_cast<long long>(nbr) * bs,
               static_cast<long long>(K) * bs, TM, KC,
               row_bytes<T>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  err = encode(&map_x, x_ext, static_cast<long long>(nbr + 2 * bw) * bs, m,
               KC, 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto kernel = ext_tma_kernel<T, TM, TN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      TM * 2 + 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int col_tiles = (m + TN - 1) / TN;
  const int row_tiles = bs / TM;
  const long long tiles = static_cast<long long>(nbr) * row_tiles * col_tiles;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long grid = tiles < resident ? tiles : resident;
  kernel<<<static_cast<unsigned>(grid), TM * 2 + 32, smem, s>>>(
      map_a, map_x, y, nbr, bs, K, m, col_tiles, row_tiles, stages);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tma_tm(const T* blocks, const T* x_ext,
                          typename Math<T>::Acc* y, int nbr, int bs, int K,
                          int bw, int m, cudaStream_t s) {
  switch (fdt1::column_tile(m)) {
    case 8: return launch_tma_tn<T, TM, 8>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
    case 16: return launch_tma_tn<T, TM, 16>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
    case 32: return launch_tma_tn<T, TM, 32>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
    case 48: return launch_tma_tn<T, TM, 48>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
    default: return launch_tma_tn<T, TM, 64>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
  }
}

// The shard's first row in x_ext.
template <typename T>
const T* centre(const T* x_ext, int bs, int bw, int m) {
  return x_ext + static_cast<long long>(bw) * bs * m;
}

template <typename T>
int banded_ext(const T* blocks, const T* x_ext, typename Math<T>::Acc* y,
               int nbr, int bs, int K, int bw, int m, int route,
               void* stream) {
  if (nbr <= 0 || bs <= 0 || m <= 0) return 0;
  if (K != 2 * bw + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kTma) {
    if (!tma_fits(blocks, x_ext, bs, m)) return static_cast<int>(err);
    err = fdt1::small_rows(bs)
              ? launch_tma_tm<T, 16>(blocks, x_ext, y, nbr, bs, K, bw, m, s)
              : launch_tma_tm<T, 128>(blocks, x_ext, y, nbr, bs, K, bw, m, s);
  } else if (route == kCpAsync) {
    err = fdt1::launch_full(blocks, centre(x_ext, bs, bw, m),
                            fdt1::Inside<T>{fdt1::RowRange{0, nbr, 0}}, y, nbr,
                            nbr, bs, K, bw, m, s);
  }
  return static_cast<int>(err);
}

template <typename T>
int plan_entry(int route, int bs, int m, int* out) {
  const int tm = fdt1::small_rows(bs) ? 16 : 128;
  const int tn = fdt1::column_tile(m);
  int stages = 0, smem = 0;
  cudaError_t err = route == kTma
                        ? plan_tma<T>(tm, tn, stages, smem)
                        : fdt1::plan_ring<T>(tm, tn, 1, fdt1::kFull,
                                             fdt1::kDirect, stages, smem);
  out[0] = tm;
  out[1] = tn;
  out[2] = stages;
  out[3] = smem;
  out[4] = route == kTma ? tm * 2 + 32 : tm * 2;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// blocks, x_ext, y, nbr, bs, K, bw, m, route (0 cp.async, 1 tma), stream
int fdt_banded_ext_bsr_spmm_f64(const double* blocks, const double* x_ext,
                                double* y, int nbr, int bs, int K, int bw,
                                int m, int route, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, route, stream);
}

int fdt_banded_ext_bsr_spmm_f32(const float* blocks, const float* x_ext,
                                float* y, int nbr, int bs, int K, int bw,
                                int m, int route, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, route, stream);
}

int fdt_banded_ext_bsr_spmm_bf16(const Bf16* blocks, const Bf16* x_ext,
                                 float* y, int nbr, int bs, int K, int bw,
                                 int m, int route, void* stream) {
  return banded_ext(blocks, x_ext, y, nbr, bs, K, bw, m, route, stream);
}

// The layout of a launch at (bs, m) by route, into out[5]: row tile,
// column tile, ring depth, dynamic shared memory bytes, threads a block.
// dtype: 0 f64, 1 f32, 2 bf16.
int fdt_ext_spmm_plan(int dtype, int route, int bs, int m, int* out) {
  bs = max(bs, 1);
  m = max(m, 1);
  switch (dtype) {
    case 0: return plan_entry<double>(route, bs, m, out);
    case 1: return plan_entry<float>(route, bs, m, out);
    case 2: return plan_entry<Bf16>(route, bs, m, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
