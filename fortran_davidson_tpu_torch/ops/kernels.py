"""The BSR SpMM kernels: hand-written CUDA for Hopper, their plain PyTorch
versions, and launch counters (counterpart of
``fortran_davidson_tpu/ops/pallas_kernels.py``).

Two kernels carry the solver's main path, both in ``csrc/bsr_spmm.cu``:

- :func:`banded_bsr_spmm` replaces ``banded_bsr_spmm``
  (``fortran_davidson_tpu/ops/pallas_kernels.py:438``): DIA-banded
  block-ELL, where a block row reads one contiguous window of x.
- :func:`bsr_spmm` replaces ``bsr_spmm`` (``pallas_kernels.py:101``):
  general block-ELL, where a block row reads its own K column indices.

What bounds them on the H100, and what the simple design does about it,
is written at the top of ``csrc/bsr_spmm.cu``. They are not tuned yet.

Dispatch follows the tensors' device: CPU tensors take the plain version;
CUDA tensors launch the kernel, or raise for what it does not take (bf16
storage, mixed types). There is no fallback from one to the other. Each
wrapper counts its launches in ``wrapper.launches``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, into
``fortran_davidson_tpu_torch/_build/`` (named by a hash of the source, so
an edited source is rebuilt), and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bsr_spmm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # blocks, x, y, nbr, bs, K, bw, m, stream
    "fdt_banded_bsr_spmm_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fdt_banded_bsr_spmm_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # cols, blocks, x, y, nbr, bs, K, x_rows, m, stream
    "fdt_bsr_spmm_f64": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _P],
    "fdt_bsr_spmm_f32": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _P],
}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path() -> Path:
    """Where the built library lives: named by a hash of source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfdt_bsr_spmm_{digest}.so"


def build() -> tuple:
    """Compile ``csrc/bsr_spmm.cu`` unless it is built already.

    Returns ``(path, log)``; ``log`` holds ptxas's register/shared-memory
    report of a fresh build and is empty when the library already existed.
    """
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stderr


@functools.cache
def _library():
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type: float32 for sub-32-bit storage, else the type."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def _check_shapes(blocks, x, x_rows: int):
    if blocks.ndim != 3 or x.ndim != 2:
        raise ValueError(f"need (nbr, bs, K*bs) blocks and (n, m) x, got "
                         f"{tuple(blocks.shape)} / {tuple(x.shape)}")
    nbr, bs, kbs = blocks.shape
    if bs == 0 or kbs % bs:
        raise ValueError(f"blocks width {kbs} is not a multiple of bs={bs}")
    if x.shape[0] != x_rows:
        raise ValueError(f"x has {x.shape[0]} rows, expected {x_rows}")
    if blocks.device != x.device:
        raise ValueError(f"blocks on {blocks.device}, x on {x.device}")


def _launch(name: str, blocks, x, out_dtype, args_before, args_after):
    """Launch a kernel on the tensors' device and current stream."""
    if blocks.dtype != x.dtype:
        raise NotImplementedError(
            f"{name}: blocks {blocks.dtype} with x {x.dtype} has no CUDA "
            "kernel; cast both to one type")
    if x.dtype not in _SUFFIX:
        raise NotImplementedError(
            f"{name}: {x.dtype} storage has no CUDA kernel yet (float32 and "
            "float64 only; bf16 storage is on the ROADMAP)")
    if not (blocks.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: blocks and x must be contiguous")
    nbr, bs, _ = blocks.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=x.dtype, device=x.device)
    if y.numel():
        fn = getattr(_library(), f"fdt_{name}_{_SUFFIX[x.dtype]}")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*args_before, blocks.data_ptr(), x.data_ptr(),
                     y.data_ptr(), *args_after, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    return y.to(out_dtype)


def banded_bsr_spmm_plain(blocks, x, bandwidth: int, out_dtype=None):
    """Plain PyTorch ``banded_bsr_spmm``: pad ``bw`` block rows on each side
    of x, take the K contiguous slot slices (``_slot_slices_dia``,
    ``fortran_davidson_tpu/ops/sparse.py:518-526``) and contract each block
    row as one (bs, K*bs) @ (K*bs, m) product."""
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    m = x.shape[1]
    acc = _acc_dtype(x.dtype)
    xb = x.to(acc).reshape(nbr, bs, m)
    xp = torch.nn.functional.pad(xb, (0, 0, 0, 0, bandwidth, bandwidth))
    window = torch.cat([xp[k:k + nbr] for k in range(K)], dim=1)
    out = torch.bmm(blocks.to(acc), window).reshape(nbr * bs, m)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def banded_bsr_spmm(blocks, x, bandwidth: int, out_dtype=None):
    """Y = A @ X for DIA-banded block-ELL storage (slot k of block row r
    holds block column r - bw + k; out-of-range slots are zero blocks).

    Args:
      blocks: (nbr, bs, K*bs), K = 2*bandwidth + 1.
      x: (nbr*bs, m).
      out_dtype: output type (default ``x.dtype``).
    """
    _check_shapes(blocks, x, blocks.shape[0] * blocks.shape[1])
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    if K != 2 * bandwidth + 1:
        raise ValueError(f"banded storage needs K == 2*bw+1, got K={K}, "
                         f"bw={bandwidth}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return banded_bsr_spmm_plain(blocks, x, bandwidth, out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"banded_bsr_spmm: no kernel for {x.device}")
    y = _launch("banded_bsr_spmm", blocks, x, out_dtype, (),
                (nbr, bs, K, int(bandwidth), x.shape[1]))
    banded_bsr_spmm.launches += 1
    return y


banded_bsr_spmm.launches = 0


def bsr_spmm_plain(block_cols, blocks, x, out_dtype=None):
    """Plain PyTorch ``bsr_spmm``: gather the K (bs, m) slices of x by the
    column table and contract each block row as one product
    (``fortran_davidson_tpu/ops/sparse.py:689-697``)."""
    nbr, bs, kbs = blocks.shape
    m = x.shape[1]
    acc = _acc_dtype(x.dtype)
    xb = x.to(acc).reshape(-1, bs, m)
    gathered = xb[block_cols.long()].reshape(nbr, kbs, m)
    out = torch.bmm(blocks.to(acc), gathered).reshape(nbr * bs, m)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def bsr_spmm(block_cols, blocks, x, out_dtype=None):
    """Y = A @ X for general block-ELL storage.

    Args:
      block_cols: (nbr, K) int32 block-column index of each slot (padded
        slots may point anywhere in range; their blocks must be zero).
      blocks: (nbr, bs, K*bs).
      x: (nbc*bs, m).
      out_dtype: output type (default ``x.dtype``).
    """
    nbr, bs, kbs = blocks.shape
    if x.ndim != 2 or bs == 0 or x.shape[0] % bs:
        raise ValueError(f"x rows must be a multiple of bs={bs}")
    _check_shapes(blocks, x, x.shape[0])
    K = kbs // bs
    if tuple(block_cols.shape) != (nbr, K):
        raise ValueError(f"block_cols must be ({nbr}, {K}), got "
                         f"{tuple(block_cols.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return bsr_spmm_plain(block_cols, blocks, x, out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"bsr_spmm: no kernel for {x.device}")
    if (block_cols.dtype != torch.int32 or block_cols.device != x.device
            or not block_cols.is_contiguous()):
        raise ValueError("bsr_spmm: block_cols must be a contiguous int32 "
                         "tensor on x's device")
    y = _launch("bsr_spmm", blocks, x, out_dtype, (block_cols.data_ptr(),),
                (nbr, bs, K, x.shape[0], x.shape[1]))
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0


KERNELS = (banded_bsr_spmm, bsr_spmm)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
