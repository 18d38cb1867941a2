// Kernel 8's one-launch form on kernel 1's template (banded_spmm.cuh): the
// Push source and the ring protocol it runs around a CTA's walk. The
// design, and why it always makes progress, are at the top of
// remote_halo.cu; the window's memory is peer_window.cu's.
//
// Window layout (bytes from the window's base; kernels.py reads the same
// offsets: WINDOW_HEADER, window_slot_offset):
//   0    long long arrived[slot][parity]: the epoch whose rows a neighbour
//        last pushed into the slot's buffer (written by that neighbour)
//   32   long long consumed[slot]: the epoch up to which the neighbour that
//        this rank pushes `slot` to has read them (written by it)
//   48   unsigned count[4]: the CTAs of this launch that pushed (count 0;
//        count 1 is unused), and that read this rank's top, bot slot
//        (counts 2, 3; this rank's own; the last CTA of each resets it)
//   256  the slots: slot s, parity p at 256 + (2 s + p) * slot_bytes, each
//        a row-major (bw * bs, m) tile of the compute type
// Slot 0 (top) holds the predecessor's last bw * bs rows, slot 1 (bot) the
// successor's first.

#pragma once

#include "banded_spmm.cuh"

namespace fdt1 {

constexpr int kTop = 0;
constexpr int kBot = 1;
constexpr long long kWindowHeader = 256;
// What a fault record's `what` names: the wait for a slot's rows, or for
// the reader of a slot's previous rows.
constexpr int kWaitArrived = 1;
constexpr int kWaitConsumed = 2;

// The protocol's operands: the three windows (this rank's; the
// predecessor's, left; the successor's, right: all three this rank's at
// world size 1), the fault record (host memory the card writes: set, rank,
// epoch, slot, what, the flag's last value), this launch's numbers
// (kernels.push_plan: the epoch, its buffer parity, the consumed epoch its
// pushes wait for), and the number of CTAs that push (the grid's first).
struct PushRing {
  unsigned char* own;
  unsigned char* left;
  unsigned char* right;
  long long* fault;
  long long slot_bytes;
  long long epoch;
  long long reuse_after;
  long long timeout_ns;
  int parity;
  int rank;
  int pushers;
};

__device__ __forceinline__ long long* arrived(unsigned char* w, int slot,
                                              int parity) {
  return reinterpret_cast<long long*>(w) + 2 * slot + parity;
}
__device__ __forceinline__ long long* consumed(unsigned char* w, int slot) {
  return reinterpret_cast<long long*>(w + 32) + slot;
}
// count 0-1: pushes into slot top, bot; 2-3: reads of this rank's slots.
__device__ __forceinline__ unsigned* count(unsigned char* w, int i) {
  return reinterpret_cast<unsigned*>(w + 48) + i;
}
template <typename T>
__host__ __device__ __forceinline__ T* slot_rows(unsigned char* w, int slot,
                                                 int parity,
                                                 long long slot_bytes) {
  return reinterpret_cast<T*>(w + kWindowHeader +
                              (2 * slot + parity) * slot_bytes);
}

__device__ __forceinline__ long long ld_acquire_sys(const long long* p) {
  long long v;
  asm volatile("ld.acquire.sys.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release_sys(long long* p, long long v) {
  asm volatile("st.release.sys.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Record who waited on what, make it visible to the host, and stop the
// launch (the context is lost: the wrapper and the window read the record
// from host memory). Out of line, with scalar arguments, so that no CTA
// keeps a copy of the ring on its stack for it.
__device__ __noinline__ void push_fault(long long* fault, int rank,
                                        long long epoch, int slot, int what,
                                        long long seen) {
  volatile long long* f = fault;
  f[1] = rank;
  f[2] = epoch;
  f[3] = slot;
  f[4] = what;
  f[5] = seen;
  __threadfence_system();
  f[0] = 1;
  __threadfence_system();
  __trap();
}

// One thread: spin on `flag` (acquire, system scope) until it equals
// `want`, or with at_least until it is >= want; past ring.timeout_ns of
// %globaltimer, fault.
__device__ __forceinline__ void spin(const long long* flag, long long want,
                                     bool at_least, const PushRing& ring,
                                     int slot, int what) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    const long long v = ld_acquire_sys(flag);
    if (at_least ? v >= want : v == want) return;
    if (global_ns() - t0 > static_cast<unsigned long long>(ring.timeout_ns))
      push_fault(ring.fault, ring.rank, ring.epoch, slot, what, v);
    __nanosleep(64);
  }
}

// Thread 0, after every thread of the CTA passed a barrier behind its
// part: count the CTA in count(own, i); the launch's last of `ctas` resets
// the count, fences, and stores `epoch` into `flag` (in a neighbour's
// window), and into `flag2` where it is given, with a release at system
// scope. The fences on both sides of the count make every counted CTA's
// writes (or reads) happen before the stores.
__device__ __forceinline__ void count_and_signal(const PushRing& ring, int i,
                                                 int ctas, long long* flag,
                                                 long long* flag2 = nullptr) {
  __threadfence_system();
  unsigned* c = count(ring.own, i);
  if (atomicAdd(c, 1u) == static_cast<unsigned>(ctas) - 1) {
    atomicExch(c, 0u);
    __threadfence_system();
    st_release_sys(flag, ring.epoch);
    if (flag2 != nullptr) st_release_sys(flag2, ring.epoch);
  }
}

// Push: kernel 8 in one launch. The x rows are Split's (the shard's rows,
// and its halos from this rank's own window slots of the epoch's parity,
// top and bot), over a grid whose first rows are the edge block rows (the
// first bw, then the last bw, then the interior), so that the CTAs that
// push and wait are dispatched first.
template <typename T>
struct Push {
  const T* top;
  const T* bot;
  long long halo;
  int nbr;
  int bw;
  PushRing ring;
  __device__ __forceinline__ long long block_row(long long g) const {
    if (nbr <= 2 * bw || g < bw) return g;
    return g < 2 * bw ? nbr - 2 * bw + g : g - bw;
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

// Pusher p of `pushers`: its share of a flat copy of `count` elements
// from src to dst (16-byte stores where both are aligned to them).
template <typename T>
__device__ __forceinline__ void copy_share(T* dst, const T* src,
                                           long long count, int p,
                                           int pushers) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = static_cast<long long>(pushers) * blockDim.x;
  const long long first = static_cast<long long>(p) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15) == 0) {
    const long long nv = count / V;
    for (long long e = first; e < nv; e += stride)
      reinterpret_cast<uint4*>(dst)[e] =
          __ldg(reinterpret_cast<const uint4*>(src) + e);
    done = nv * V;
  }
  for (long long e = done + first; e < count; e += stride) dst[e] = src[e];
}

// Pusher p (the grid's CTA p, p < ring.pushers): once each receiving
// neighbour has read the previous rows of this parity's buffer, copy its
// share of the shard's first `halo` rows into the predecessor's bot slot
// and of its last into the successor's top slot (both contiguous: x is
// row-major); then count it among the pushers, the last of which sets both
// neighbours' arrived flags to the epoch.
template <typename T>
__device__ __forceinline__ void push_share(const PushRing& ring, const T* x,
                                           long long n, long long halo, int m,
                                           int p) {
  if (threadIdx.x == 0) {
    spin(consumed(ring.own, kBot), ring.reuse_after, true, ring, kBot,
         kWaitConsumed);
    spin(consumed(ring.own, kTop), ring.reuse_after, true, ring, kTop,
         kWaitConsumed);
  }
  __syncthreads();
  const long long count = halo * m;
  copy_share(slot_rows<T>(ring.left, kBot, ring.parity, ring.slot_bytes), x,
             count, p, ring.pushers);
  copy_share(slot_rows<T>(ring.right, kTop, ring.parity, ring.slot_bytes),
             x + (n - halo) * m, count, p, ring.pushers);
  __syncthreads();
  if (threadIdx.x == 0)
    count_and_signal(ring, 0, ring.pushers,
                     arrived(ring.left, kBot, ring.parity),
                     arrived(ring.right, kTop, ring.parity));
}

// The grid's first ring.pushers CTAs push (push_share); then an edge CTA
// (the first or last bw block rows) waits for the slots it reads to hold
// this epoch's rows. Interior CTAs that do not push return at once.
template <typename T>
__device__ __forceinline__ void before_walk(const Push<T>& src, const T* x,
                                            long long r0, int, int, int, int,
                                            int nbr, int bs, int bw, int m,
                                            int) {
  if (blockIdx.x < static_cast<unsigned>(src.ring.pushers))
    push_share(src.ring, x, static_cast<long long>(nbr) * bs, src.halo, m,
               static_cast<int>(blockIdx.x));
  const bool top = r0 < bw;
  const bool bot = r0 >= nbr - bw;
  if (!top && !bot) return;
  if (threadIdx.x == 0) {
    if (top)
      spin(arrived(src.ring.own, kTop, src.ring.parity), src.ring.epoch,
           false, src.ring, kTop, kWaitArrived);
    if (bot)
      spin(arrived(src.ring.own, kBot, src.ring.parity), src.ring.epoch,
           false, src.ring, kBot, kWaitArrived);
  }
  __syncthreads();
}

// An edge CTA, its halo rows in shared memory: count it among its slots'
// readers; the last reader of this rank's top slot tells the predecessor
// (its consumed[top]), the last of the bot slot the successor.
template <typename T>
__device__ __forceinline__ void after_walk(const Push<T>& src, long long r0,
                                           int nbr, int bw, int tiles) {
  const bool top = r0 < bw;
  const bool bot = r0 >= nbr - bw;
  if (threadIdx.x != 0 || (!top && !bot)) return;
  const int ctas = bw * tiles;
  if (top)
    count_and_signal(src.ring, 2 + kTop, ctas, consumed(src.ring.left, kTop));
  if (bot)
    count_and_signal(src.ring, 2 + kBot, ctas, consumed(src.ring.right, kBot));
}

}  // namespace fdt1
