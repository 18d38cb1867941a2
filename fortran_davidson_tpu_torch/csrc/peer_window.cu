// The halo window of kernel 8's one-launch form (remote_halo.cu,
// fdt_banded_remote_push_spmm_*): the device memory each rank of a
// row-sharded solve exposes to its ring neighbours, which push their edge
// rows and their flags into it from inside the kernel. Host C functions
// only, loaded with ctypes by fortran_davidson_tpu_torch/ops/kernels.py;
// the rendezvous (the handles' exchange, growth, release) is
// parallel/mesh.py's.
//
// The window is cudaMalloc'd, outside PyTorch's caching allocator, so that
// its IPC handle names this allocation alone, at offset 0. Its layout
// (kernels.window_bytes, the offsets at the top of remote_halo.cu): a
// 256-byte header of flags and counters, then two slots (top: the
// predecessor's last bw*bs rows; bot: the successor's first), each
// double-buffered by epoch parity. It is zeroed here once: the kernel
// writes a slot before it reads it, and the first epochs' flags start
// from 0.
//
// A neighbour's window is opened from its handle with
// cudaIpcMemLazyEnablePeerAccess; the rank that is its own neighbour (world
// size 1) uses its own pointer, since CUDA refuses to open a process's own
// handle.

#include <cuda_runtime.h>

#include <cstring>

extern "C" {

// bytes, ptr (void** out), handle (64 bytes out): a zeroed window and its
// IPC handle.
int fdt_window_alloc(long long bytes, void* ptr, void* handle) {
  if (bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(p, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, p);
  if (err != cudaSuccess) {
    cudaFree(p);
    return static_cast<int>(err);
  }
  std::memcpy(handle, &h, sizeof h);
  *static_cast<void**>(ptr) = p;
  return 0;
}

// handle (64 bytes), ptr (void** out): a neighbour's window in this
// process's address space.
int fdt_window_open(void* handle, void* ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  void* p = nullptr;
  const cudaError_t err =
      cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<void**>(ptr) = p;
  return 0;
}

// A neighbour's window opened by fdt_window_open.
int fdt_window_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// This rank's window from fdt_window_alloc.
int fdt_window_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// src (device), dst (host), bytes: a synchronous copy of the window's
// header, for the host's reads of its flags.
int fdt_window_read(void* src, void* dst, long long bytes) {
  return static_cast<int>(cudaMemcpy(dst, src, static_cast<size_t>(bytes),
                                     cudaMemcpyDeviceToHost));
}

}  // extern "C"
