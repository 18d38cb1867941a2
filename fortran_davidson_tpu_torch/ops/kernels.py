"""The block-sparse SpMM kernels: hand-written CUDA for Hopper, their plain
PyTorch versions, and launch counters (counterpart of
``fortran_davidson_tpu/ops/pallas_kernels.py``).

Eight kernels (kernel 8 in two forms), in ``csrc/``, and the TPU
measurement kernels as variants:

- :func:`banded_bsr_spmm` replaces ``banded_bsr_spmm``
  (``fortran_davidson_tpu/ops/pallas_kernels.py:438``): DIA-banded
  block-ELL, where a block row reads one contiguous window of x
  (``csrc/banded_spmm.cu``: the slab streamed once through a cp.async
  ring, f64 on DMMA, bf16 storage on mma.sync, f32 on FFMA).
- :func:`bsr_spmm` replaces ``bsr_spmm`` (``pallas_kernels.py:101``):
  general block-ELL, where a block row reads its own K column indices
  (``csrc/bsr_spmm.cu``: kernel 1's template with a column-table source,
  each chunk's x rows staged from its slot's block column).
- :func:`banded_bsr_spmm_gram` replaces ``banded_bsr_spmm_gram``
  (``pallas_kernels.py:592``): Y = A X and G = Vᵀ Y in one sweep, G in
  registers across a thread-block cluster and V read once: float32 on
  tensor cores (3xTF32, ``csrc/fused_gram.cu``); bf16 storage on
  ``mma.sync`` m16n8k16 and float64 on DMMA, one template
  (``csrc/fused_gram_typed.cuh``, built in ``csrc/fused_gram_bf16.cu`` and
  ``csrc/fused_gram_f64.cu``; their layout by :func:`fused_typed_plan`,
  their measurement variants by :func:`typed_gram_variant`).
- :func:`banded_q_bsr_spmm` replaces ``banded_q_bsr_spmm``
  (``pallas_kernels.py:755``): int8 off-diagonal blocks with per-slot
  scales plus the exact diagonal; float32 x on kernel 5's slot-by-slot
  tensor-core apply (``csrc/q_spmm.cu`` on ``csrc/fused_apply.cuh``),
  float64 x on kernel 1's template with an int8 slab, products on DMMA
  (``csrc/q_spmm_f64.cu``; its layout by :func:`q_spmm_f64_plan`).
- :func:`banded_q_bsr_spmm_gram` replaces ``banded_q_bsr_spmm_gram``
  (``pallas_kernels.py:886``): the int8 apply fused with the gram; float32
  x slot by slot on tensor cores (``csrc/fused_gram.cu``), float64 x on
  kernel 3's typed template with an int8 slab, products on DMMA
  (``csrc/fused_gram_q8f64.cu`` on ``csrc/fused_gram_typed.cuh``; its
  layout by :func:`fused_typed_plan` with ``quant=True``).
- :func:`banded_ext_bsr_spmm` replaces ``banded_ext_bsr_spmm``
  (``pallas_kernels.py:1190``): kernel 1 over a shard's halo-extended
  rows, every window valid, on kernel 1's design (``csrc/ext_spmm.cu``):
  the stream by TMA boxes into a ring fed by a producer warp where the
  shape and alignment allow (:func:`ext_spmm_route`), else kernel 1's
  cp.async template.
- :func:`banded_q_ext_bsr_spmm` replaces ``banded_q_ext_bsr_spmm``
  (``pallas_kernels.py:1059``): the int8 form; float32 x on kernel 4's
  tensor-core apply with all K slots (``csrc/q_spmm.cu``), float64 x on
  kernel 4's float64-x kernel with kernel 8's unmasked source
  (``csrc/q_ext_spmm_f64.cu``).
- :func:`banded_remote_halo_spmm` replaces ``banded_remote_halo_spmm``
  (``pallas_kernels.py:1416``): kernel 1's template over a shard's rows
  and its two received halos through three pointers, no halo-extended
  copy, in an interior and an edge launch (``csrc/remote_halo.cu``);
  and :func:`banded_remote_push_spmm`, that TPU kernel's own form: one
  launch pushes the shard's edge rows into its ring neighbours' halo
  windows (:class:`HaloWindow`, ``csrc/peer_window.cu``) and computes
  over its own, the protocol in ``csrc/remote_push.cuh``.

Measurement variants, never called by a path of the port:
:func:`banded_spmm_variant` (kernel 1's: ``"copy"``, the counterpart of
``bench.py:85`` ``_copy_roofline_kernel``, and the ``experiments/``
SpMM probes; ``csrc/banded_spmm_var_*.cu``; their layout by
:func:`banded_spmm_plan`) and :func:`fused_gram_variant` (kernels 3 and
5; kernel 5's bf16-dequant variants on the typed template's int8 slab,
``csrc/fused_gram_q8bf16.cu``, their plain versions
:func:`fused_gram_variant_plain`).

What bounds them on the H100, and what the designs do about it, is
written at the top of each source. Every kernel runs on tensor cores
(kernels 1, 2, 6 and 8 in float32 on FFMA).

Types: dense storage is float64, float32, or bfloat16 (bf16 blocks and x,
summed in float32, as the TPU kernels do); int8 storage takes float32 or
float64 x (float64: the band summed in float64 and rounded to float32,
as the plain version does).
A kernel writes Y in its accumulation type; an ``out_dtype`` other than
that is one conversion of those sums, so bf16 storage never rounds Y
through bf16. G is float32, shape (mv, m).

Dispatch follows the tensors' device: CPU tensors take the plain version;
CUDA tensors launch the kernel, or raise for what it does not take
(mixed types, int8 storage with x other than float32 or float64). There
is no fallback from one to the other. Each wrapper counts its launches in
``wrapper.launches``; those of kernels 4 and 7 with float64 x also in
``wrapper.f64_launches``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``nvcc`` per source, all started together, then linked into one library
in ``fortran_davidson_tpu_torch/_build/`` named by a hash of every file
under ``csrc/`` (so an edited source is rebuilt), loaded with ``ctypes``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

from fortran_davidson_tpu_torch.utils.errors import HaloPushFault

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SUFFIX = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16"}
# blocks, x, y, nbr, bs, K, bw, m, stream
_BANDED = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# cols, blocks, x, y, nbr, bs, K, x_rows, m, stream
_GENERAL = [_P, _P, _P, _P, _I, _I, _I, _L, _I, _P]
# blocks, x, v, ldv, y, partial, g, nbr, bs, K, bw, m, mv, n_groups, stream
_GRAM = [_P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
# The same with the variant before the stream (csrc/fused_gram.cu).
_FUSED = [*_GRAM[:-1], _I, _P]
_ARGTYPES = {
    **{f"fdt_banded_bsr_spmm_{s}": _BANDED for s in _SUFFIX.values()},
    **{f"fdt_bsr_spmm_{s}": _GENERAL for s in _SUFFIX.values()},
    # q, scale_rows, diag, x, y, nbr, bs, K, bw, m, stream
    **{f"fdt_banded_q_bsr_spmm_{s}": [_P, _P, *_BANDED]
       for s in ("f32", "f64")},
    "fdt_fused_gram_f32": _FUSED,
    # Kernel 3's bf16 and float64 entries and kernel 5's int8 entries with
    # float64 and bf16 x (csrc/fused_gram_typed.cuh).
    **{f"fdt_fused_gram_{s}": _FUSED for s in ("bf16", "f64")},
    # nbr, bs, K, m, mv, out[6]
    **{f"fdt_fused_gram_{s}_plan": [_I, _I, _I, _I, _I,
                                    ctypes.POINTER(ctypes.c_int)]
       for s in ("bf16", "f64", "q8bf16", "q8f64")},
    # q, scale_rows, diag, then the dense entry's arguments from x on
    **{f"fdt_fused_{s}": [_P, _P, _P, *_FUSED[1:]]
       for s in ("q_gram_f32", "gram_q8bf16", "gram_q8f64")},
    # quant, variant, nbr, bs, K, m, mv, out[6]
    "fdt_fused_gram_plan": [_I, _I, _I, _I, _I, _I, _I,
                            ctypes.POINTER(ctypes.c_int)],
    # nbr, m, out[5]
    "fdt_q_spmm_plan": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # bs, m, out[4]
    "fdt_q_spmm_f64_plan": [_I, _I, ctypes.POINTER(ctypes.c_int)],
    # blocks, x_ext, y, nbr, bs, K, bw, m, route, stream
    **{f"fdt_banded_ext_bsr_spmm_{s}": [*_BANDED[:-1], _I, _P]
       for s in _SUFFIX.values()},
    # dtype, route, bs, m, out[5]
    "fdt_ext_spmm_plan": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    # q, scale_rows, diag, x_ext, y, nbr, bs, K, bw, m, stream
    **{f"fdt_banded_q_ext_bsr_spmm_{s}": [_P, _P, *_BANDED]
       for s in ("f32", "f64")},
    # blocks, x, y, colsum, nbr, bs, K, bw, m, variant, rows_per_cta,
    # stages, store, evict_first, stream
    **{f"fdt_banded_spmm_variant_{s}": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P]
       for s in _SUFFIX.values()},
    # dtype, kernel1, bs, m, variant, rows_per_cta, store, stages, out[4]
    "fdt_banded_spmm_plan": [_I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int)],
    # blocks, x, top, bot, y, nbr, bs, K, bw, m, a0, na, b0, nb, stream
    **{f"fdt_banded_remote_halo_spmm_{s}": [_P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _I, _I, _I, _I, _I, _P]
       for s in _SUFFIX.values()},
    # blocks, x, y, nbr, bs, K, bw, m, own, left, right, fault, slot_bytes,
    # epoch, rank, timeout_ns, stream
    **{f"fdt_banded_remote_push_spmm_{s}": [*_BANDED[:-1], _P, _P, _P, _P, _L,
                                            _L, _I, _L, _P]
       for s in _SUFFIX.values()},
    # The halo window (csrc/peer_window.cu): bytes, ptr out, handle out;
    # handle, ptr out; ptr; ptr; src, dst, bytes.
    "fdt_window_alloc": [_L, _P, _P],
    "fdt_window_open": [_P, _P],
    "fdt_window_close": [_P],
    "fdt_window_free": [_P],
    "fdt_window_read": [_P, _P, _L],
}


def _find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def sources() -> list:
    """The translation units under ``csrc/`` (headers are included)."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the built library lives: named by a hash of every file under
    ``csrc/`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libfdt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile ``csrc/*.cu`` unless the library is built already: one
    ``nvcc`` per source, all started together, then one link.

    Returns ``(path, log)``; ``log`` holds each source's compile time
    (a line ``nvcc <source>: <seconds> s``, from the common start) and
    ptxas's register/shared-memory report of a fresh build, and is empty
    when the library already existed.
    """
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    start = time.monotonic()

    def finish(job):
        # Each process's pipes drained on a thread of its own, so that its
        # end is seen when it comes.
        stdout, stderr = job[2].communicate()
        return stdout, stderr, time.monotonic() - start

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        ends = list(pool.map(finish, jobs))
    logs, failed = [], []
    for (cmd, _, proc), (stdout, stderr, secs) in zip(jobs, ends):
        logs.append(f"nvcc {Path(cmd[-1]).name}: {secs:.1f} s\n"
                    + stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({' '.join(cmd)}):\n{stderr}")
    tmp = out.with_name(f"{tag}.tmp")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return out, "".join(logs)


@functools.cache
def _library():
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
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


def _check_banded(blocks, x, bandwidth: int, ext: bool = False) -> int:
    """Shape checks of DIA-banded storage over x, or with ``ext`` over a
    halo-extended x of (nbr + 2*bw)*bs rows; returns K."""
    nbr, bs = blocks.shape[0], blocks.shape[1]
    _check_shapes(blocks, x, (nbr + (2 * bandwidth if ext else 0)) * bs)
    K = blocks.shape[2] // bs
    if K != 2 * bandwidth + 1:
        raise ValueError(f"banded storage needs K == 2*bw+1, got K={K}, "
                         f"bw={bandwidth}")
    return K


def _check_v(v, x):
    if v is None:
        return
    if v.ndim != 2 or v.shape[0] != x.shape[0] or v.device != x.device:
        raise ValueError(f"v must be ({x.shape[0]}, mv) on {x.device}, got "
                         f"{tuple(v.shape)} on {v.device}")


def _on_cpu(name: str, x) -> bool:
    """True for CPU tensors (the plain version); False for CUDA tensors
    (the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise NotImplementedError(f"{name}: no kernel for {x.device}")
    return False


def _dense_suffix(name: str, blocks, x) -> str:
    if blocks.dtype != x.dtype:
        raise NotImplementedError(
            f"{name}: blocks {blocks.dtype} with x {x.dtype} has no CUDA "
            "kernel; cast both to one type")
    if x.dtype not in _SUFFIX:
        raise NotImplementedError(
            f"{name}: {x.dtype} storage has no CUDA kernel (float64, float32 "
            "and bfloat16 only)")
    return _SUFFIX[x.dtype]


def _require_contiguous(name: str, *tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every input must be contiguous")


def _run(entry: str, device, *args) -> None:
    """Call one C entry on ``device``'s current stream; raise on its error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {err}")


def _out(y, out_dtype):
    """Y left the kernel in its accumulation type; any other ``out_dtype``
    is one conversion of those sums."""
    return y if y.dtype == out_dtype else y.to(out_dtype)


def _gram_plain(vv, y):
    """G = vvᵀ y in float32, y rounded to vv's type first (the TPU
    kernels' staged tile) and the sums in vv's accumulation type."""
    acc = acc_dtype(vv.dtype)
    return (vv.to(acc).T @ y.to(vv.dtype).to(acc)).to(torch.float32)


# The fused float32 kernels (csrc/fused_gram.cu): the entry and its
# loader (0: float32 blocks, 1: int8), by wrapper name.
_FUSED_ENTRY = {"banded_bsr_spmm_gram": ("fdt_fused_gram_f32", 0),
                "banded_q_bsr_spmm_gram": ("fdt_fused_q_gram_f32", 1)}
# The fused float32 kernels' variants (csrc/fused_gram.cu): the full
# kernel, then its measurement variants (:func:`fused_gram_variant`), in
# the order of their C enum.
F32_VARIANTS = ("full", "nov", "nogram")
# Kernel 5's bf16-dequant variants (csrc/fused_gram_q8bf16.cu).
BF16_VARIANTS = ("bf16deq", "tg_bf16deq", "nov_bf16")
GRAM_VARIANTS = F32_VARIANTS + BF16_VARIANTS
FUSED_PLAN_KEYS = ("n_groups", "TN", "C", "MB", "smem_bytes",
                   "clusters_resident")


def _plan(entry: str, device_index: int, what: str, *args) -> dict:
    out = (ctypes.c_int * len(FUSED_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = getattr(_library(), entry)(*args, out)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} ({what})")
    return dict(zip(FUSED_PLAN_KEYS, out))


@functools.lru_cache(maxsize=256)
def fused_gram_plan(device_index: int, quant: int, variant: str, nbr: int,
                    bs: int, K: int, m: int, mv: int) -> dict:
    """The layout of a call of the float32 kernels of ``csrc/fused_gram.cu``
    (quant 0: float32 blocks, 1: int8; ``variant`` one of
    :data:`F32_VARIANTS`): row groups (one partial of G each: as many
    clusters as the card holds at once, from the occupancy API), column
    tile TN, cluster size C, G rows a block MB, dynamic shared memory a
    block, clusters resident."""
    return _plan("fdt_fused_gram_plan", device_index,
                 f"quant={quant} {variant} nbr={nbr} bs={bs} K={K} m={m} "
                 f"mv={mv}", quant, F32_VARIANTS.index(variant), nbr, bs, K,
                 m, mv)


# The typed template (csrc/fused_gram_typed.cuh): kernel 3's bf16 and
# float64 entries, and kernel 5's int8 entries with float64 x and with bf16
# x (the bf16-dequant variants). Their x types, and their variants in the
# order of the C enum: the full kernel; V streamed, no gram products; no V
# (the int8 entries: G's row 0 the column sums of Y); the int8 entries'
# gram pass over two ring tiles.
TYPED_TYPES = (torch.bfloat16, torch.float64)
TYPED_VARIANTS = ("full", "nogram", "nov", "tg")
# The bf16-dequant variants as variants of the int8 bf16 entry.
_BF16_TYPED = {"bf16deq": "full", "tg_bf16deq": "tg", "nov_bf16": "nov"}


@functools.lru_cache(maxsize=256)
def fused_typed_plan(device_index: int, dtype: torch.dtype, nbr: int,
                     bs: int, K: int, m: int, mv: int,
                     quant: bool = False) -> dict:
    """The layout of a call of an entry of ``csrc/fused_gram_typed.cuh``
    (x of ``dtype``; kernel 3's dense entries, or with ``quant`` kernel 5's
    int8 ones), as :func:`fused_gram_plan` reports the float32 kernels':
    row groups, column tile TN, cluster size C, G rows a block MB, dynamic
    shared memory a block, clusters resident. A width that no layout holds
    raises ``RuntimeError``."""
    slab = "int8 blocks, " if quant else ""
    return _plan(f"fdt_fused_gram_{'q8' if quant else ''}{_SUFFIX[dtype]}"
                 "_plan", device_index,
                 f"no layout holds {slab}{dtype} x nbr={nbr} bs={bs} K={K} "
                 f"m={m} mv={mv}", nbr, bs, K, m, mv)


def _gram_launch(name: str, sfx: str, lead_ptrs: tuple, x, v,
                 write_out: bool, acc, nbr: int, bs: int, K: int, bw: int,
                 variant: str = "full"):
    """Allocate Y (optional), G and the partials' scratch, and launch a
    fused SpMM+Gram entry: float32 x to ``csrc/fused_gram.cu``; float64 and
    bf16 x, dense (kernel 3) or int8 (kernel 5), to
    ``csrc/fused_gram_typed.cuh``."""
    if v is not None and v.dtype != x.dtype:
        raise NotImplementedError(
            f"{name}: v {v.dtype} with x {x.dtype} has no CUDA kernel; "
            "cast v to x's type")
    if v is not None and v.shape[1] > 1 and v.stride(1) != 1:
        raise ValueError(f"{name}: v's rows must be contiguous (any row "
                         "stride)")
    n, m = x.shape
    mv = m if v is None else v.shape[1]
    dev = x.device
    y = torch.empty((n, m), dtype=acc, device=dev) if write_out else None
    g = torch.empty((mv, m), dtype=torch.float32, device=dev)
    launched = g.numel() > 0 and n > 0
    if not launched:
        return y, g, launched
    vp = None if v is None or variant == "nov" else v.data_ptr()
    ldv = m if v is None else v.stride(0)
    yp = None if y is None else y.data_ptr()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if x.dtype == torch.float32:
        entry, quant = _FUSED_ENTRY[name]
        n_groups = fused_gram_plan(index, quant, variant, nbr, bs, K, m,
                                   mv)["n_groups"]
        scratch = torch.empty((n_groups, mv, m), dtype=torch.float32,
                              device=dev)
        _run(entry, dev, *lead_ptrs, x.data_ptr(), vp, ldv, yp,
             scratch.data_ptr(), g.data_ptr(), nbr, bs, K, bw, m, mv,
             n_groups, F32_VARIANTS.index(variant))
    else:
        quant = name == "banded_q_bsr_spmm_gram"
        vp = None if v is None else v.data_ptr()
        n_groups = fused_typed_plan(index, x.dtype, nbr, bs, K, m, mv,
                                    quant)["n_groups"]
        scratch = torch.empty((n_groups, mv, m), dtype=acc_dtype(x.dtype),
                              device=dev)
        _run(f"fdt_fused_gram_{'q8' if quant else ''}{sfx}", dev, *lead_ptrs,
             x.data_ptr(), vp, ldv, yp, scratch.data_ptr(), g.data_ptr(),
             nbr, bs, K, bw, m, mv, n_groups, TYPED_VARIANTS.index(variant))
    return y, g, launched


def fused_gram_variant(name: str, lead: tuple, x, v, *, bandwidth: int,
                       variant: str):
    """One launch of a measurement variant of the float32 kernel 3
    (``name="banded_bsr_spmm_gram"``, ``lead=(blocks,)``) or kernel 5
    (``"banded_q_bsr_spmm_gram"``, ``lead=(qblocks, scale_rows, diag)``)
    on CUDA tensors; returns G, (mv, m) float32.

    ``"nov"`` reads no V; ``"nogram"`` streams V as the full kernel does
    and skips the gram product; on float32 x and v both reduce Y to its
    column sums, which they return in G's row 0 (the other rows are zero),
    at the main cases' column tile (128 for kernel 3; 24 or 128 for kernel
    5, as at m = 20 and at the probe's m = 256). With the full kernel they
    split its time into apply, V stream and gram (the counterparts of
    ``experiments/fused_probe.py``'s ``nov`` and ``nogram``). Kernel 5
    also takes them on float64 x and v (its float64-x entry on
    ``csrc/fused_gram_typed.cuh``: ``"nov"`` returns Y's column sums in G's
    row 0, ``"nogram"`` a G of zeros).

    Kernel 5 only, on bf16 x (n, m) and bf16 v (n, mv), any m and mv:
    ``"bf16deq"``, ``"tg_bf16deq"`` and ``"nov_bf16"`` (v None), the
    probe's bf16-dequant modes: the blocks dequantized and rounded to bf16,
    bf16 products with float32 sums, d ∘ x in float32; G = vᵀ bf16(Y), with
    the gram's pass over one block row's tile or (``"tg_bf16deq"``) over
    two, or (``"nov_bf16"``) Y's float32 column sums in G's row 0
    (:func:`fused_gram_variant_plain`), on the typed template's int8 slab
    (``csrc/fused_gram_q8bf16.cu``).

    Not counted in the wrappers' launches; the port's paths never call it.
    What no kernel takes raises before anything launches."""
    if variant not in GRAM_VARIANTS[1:]:
        raise ValueError(f"variant must be one of {GRAM_VARIANTS[1:]}, got "
                         f"{variant!r}")
    bf16 = variant in BF16_VARIANTS
    quant = name == "banded_q_bsr_spmm_gram"
    if bf16:
        if not quant:
            raise ValueError(f"{variant} is a variant of "
                             "banded_q_bsr_spmm_gram only")
        if (v is None) != (variant == "nov_bf16"):
            raise ValueError(f"{variant}: v must be "
                             + ("None" if variant == "nov_bf16" else "given"))
    want = ((torch.bfloat16,) if bf16 else
            (torch.float32, torch.float64) if quant else (torch.float32,))
    if x.device.type != "cuda" or x.dtype not in want or (
            v is not None and v.dtype != x.dtype):
        raise NotImplementedError(f"{name} {variant}: CUDA tensors of "
                                  f"{want} only")
    _check_v(v, x)
    if quant:
        K = _check_quantized(*lead, x, bandwidth)
        ptrs = _quantized_args(name, *lead, x, want)
    else:
        K = _check_banded(lead[0], x, bandwidth)
        _dense_suffix(name, lead[0], x)
        _require_contiguous(name, lead[0], x)
        ptrs = (lead[0].data_ptr(),)
    nbr, bs, _ = lead[0].shape
    _, g, _ = _gram_launch(name, _SUFFIX[x.dtype], ptrs, x, v, False,
                           acc_dtype(x.dtype), nbr, bs, K, int(bandwidth),
                           _BF16_TYPED.get(variant, variant))
    return g


def q_dequant_bf16(qblocks, scale_rows):
    """The blocks of the bf16-dequant variants: bf16(bf16(q) · bf16(s))
    (``experiments/fused_probe.py:67-69``): q exact in bf16, the product
    of two bf16 values exact in float32, one rounding to bf16."""
    return (qblocks.to(torch.bfloat16)
            * scale_rows[:, None, :].to(torch.bfloat16))


def q_bf16_apply_plain(qblocks, scale_rows, diag, x, bandwidth: int):
    """Y of the bf16-dequant variants (``fused_probe.py:44-77``, dequant
    ``"bf16"``): :func:`q_dequant_bf16` blocks times the bf16 window of x
    (exact products, float32 sums), plus d ∘ x in float32."""
    y = banded_bsr_spmm_plain(q_dequant_bf16(qblocks, scale_rows), x,
                              bandwidth, out_dtype=torch.float32)
    return y + diag.reshape(-1, 1) * x.to(torch.float32)


def fused_gram_variant_plain(name: str, lead: tuple, x, v, *,
                             bandwidth: int, variant: str):
    """Plain PyTorch version of kernel 5's bf16-dequant variants
    (:func:`fused_gram_variant`; ``experiments/fused_probe.py:44-130``):
    Y = :func:`q_dequant_bf16` blocks times the bf16 window of x, summed in
    float32, plus d ∘ x in float32; then G = vᵀ bf16(Y) in float32 for
    ``"bf16deq"`` and ``"tg_bf16deq"`` (one function, two summation orders
    on the card), or for ``"nov_bf16"`` an (m, m) G whose row 0 is Y's
    column sums and the rest zeros. Only the tests and ``chip_smoke.py``
    call it."""
    if variant not in BF16_VARIANTS or name != "banded_q_bsr_spmm_gram":
        raise ValueError(f"plain versions exist for banded_q_bsr_spmm_gram's "
                         f"{BF16_VARIANTS}, not {name} {variant!r}")
    y = q_bf16_apply_plain(*lead, x, bandwidth)
    if variant == "nov_bf16":
        g = torch.zeros((x.shape[1], x.shape[1]), dtype=torch.float32,
                        device=x.device)
        g[0] = y.sum(dim=0)
        return g
    return v.to(torch.float32).T @ y.to(torch.bfloat16).to(torch.float32)


# -- kernel 1: DIA-banded SpMM ------------------------------------------

def banded_bsr_spmm_plain(blocks, x, bandwidth: int, out_dtype=None):
    """Plain PyTorch ``banded_bsr_spmm``: pad ``bw`` block rows on each side
    of x, take the K contiguous slot slices (``_slot_slices_dia``,
    ``fortran_davidson_tpu/ops/sparse.py:518-526``) and contract each block
    row as one (bs, K*bs) @ (K*bs, m) product."""
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    m = x.shape[1]
    acc = acc_dtype(x.dtype)
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
      x: (nbr*bs, m), the blocks' type.
      out_dtype: output type (default ``x.dtype``).
    """
    K = _check_banded(blocks, x, bandwidth)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    name = "banded_bsr_spmm"
    if _on_cpu(name, x):
        return banded_bsr_spmm_plain(blocks, x, bandwidth, out_dtype)
    sfx = _dense_suffix(name, blocks, x)
    _require_contiguous(name, blocks, x)
    nbr, bs, _ = blocks.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=acc_dtype(x.dtype),
                    device=x.device)
    if y.numel():
        _run(f"fdt_{name}_{sfx}", x.device, blocks.data_ptr(), x.data_ptr(),
             y.data_ptr(), nbr, bs, K, int(bandwidth), x.shape[1])
        banded_bsr_spmm.launches += 1
    return _out(y, out_dtype)


banded_bsr_spmm.launches = 0


# Kernel 1's measurement variants, in the order of the C enum
# (csrc/banded_spmm.cuh), and the options of the full kernel.
SPMM_VARIANTS = ("full", "noy", "copy", "writeonly")
SPMM_STORES = ("direct", "tma")
SPMM_BLOCK_POLICIES = ("normal", "evict_first")
SPMM_ROWS_PER_CTA = (1, 2, 4)
SPMM_MAX_STAGES = 8
SPMM_PLAN_KEYS = ("TM", "TN", "stages", "smem_bytes")


@functools.lru_cache(maxsize=256)
def banded_spmm_plan(device_index: int, dtype: torch.dtype, bs: int, m: int,
                     variant=None, rows_per_cta: int = 1, store: str = "direct",
                     stages=None) -> dict:
    """The layout of a launch of kernel 1 (``variant=None``) or of one of
    its variants (``csrc/banded_spmm.cuh``, as the launch takes it): the
    row tile TM (rows of a block row one CTA covers), the column tile TN,
    the ring's depth and the dynamic shared memory a CTA."""
    out = (ctypes.c_int * len(SPMM_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = _library().fdt_banded_spmm_plan(
            list(_SUFFIX).index(dtype), int(variant is None), bs, m,
            SPMM_VARIANTS.index(variant or "full"), rows_per_cta,
            SPMM_STORES.index(store), 0 if stages is None else int(stages),
            out)
    if err != 0:
        raise RuntimeError(f"fdt_banded_spmm_plan: CUDA error {err} ({dtype}, "
                           f"bs={bs}, m={m}, variant={variant}, rows_per_cta="
                           f"{rows_per_cta}, store={store}, stages={stages})")
    return dict(zip(SPMM_PLAN_KEYS, out))


def banded_spmm_variant_plain(blocks, x, bandwidth: int, *, variant: str,
                              row_tile=None):
    """Plain PyTorch version of each variant's function, in the
    accumulation type:

    - ``"full"``: Y = A @ X (:func:`banded_bsr_spmm_plain`);
    - ``"noy"``: each CTA's column sums of Y, one row per (block row, row
      tile of ``row_tile`` rows): ((nbr * tiles), m); on the card the row
      tile is the launch's, ``banded_spmm_plan(...)["TM"]``;
    - ``"copy"``: Y[r*bs + i, c] = sum_k xwin_r[k*bs + i, c] +
      sum_l blocks[r, i, l], x rows outside [0, n) zero (adds only);
    - ``"writeonly"``: Y[i, c] = i.
    """
    if variant not in SPMM_VARIANTS:
        raise ValueError(f"variant must be one of {SPMM_VARIANTS}, got "
                         f"{variant!r}")
    if variant == "noy" and row_tile is None:
        raise ValueError("variant 'noy' needs the row tile of its launch")
    nbr, bs, kbs = blocks.shape
    K = kbs // bs
    m = x.shape[1]
    acc = acc_dtype(x.dtype)
    if variant == "writeonly":
        rows = torch.arange(nbr * bs, dtype=acc, device=x.device)
        return rows[:, None].expand(nbr * bs, m).contiguous()
    if variant == "copy":
        xb = x.to(acc).reshape(nbr, bs, m)
        xp = torch.nn.functional.pad(xb, (0, 0, 0, 0, bandwidth, bandwidth))
        xsum = sum(xp[k:k + nbr] for k in range(K))
        out = xsum + blocks.to(acc).sum(dim=2)[:, :, None]
        return out.reshape(nbr * bs, m)
    y = banded_bsr_spmm_plain(blocks, x, bandwidth, out_dtype=acc)
    if variant == "full":
        return y
    tm = int(row_tile)
    tiles = -(-bs // tm)
    yb = torch.nn.functional.pad(y.reshape(nbr, bs, m),
                                 (0, 0, 0, tiles * tm - bs))
    return yb.reshape(nbr, tiles, tm, m).sum(dim=2).reshape(nbr * tiles, m)


def banded_spmm_variant(blocks, x, bandwidth: int, *, variant: str,
                        rows_per_cta: int = 1, stages=None,
                        store: str = "direct", block_policy: str = "normal",
                        out=None):
    """One launch of a measurement variant of kernel 1 on CUDA tensors
    (``csrc/banded_spmm_var_*.cu``); returns what
    :func:`banded_spmm_variant_plain` computes.

    Args:
      variant: ``"full"`` (the kernel, with the options below),
        ``"noy"`` (every read and product, no Y: one column-sum row a
        CTA), ``"copy"`` (the counterpart of ``bench.py:85``
        ``_copy_roofline_kernel``: the same reads as the kernel, adds
        only, Y written once), ``"writeonly"`` (Y's bytes written, nothing
        read).
      rows_per_cta: block rows a CTA (1, 2, 4); above 1 the schedule is
        x-stationary (each window chunk staged once for every block row of
        the CTA that reads it).
      stages: depth of the cp.async ring (2 to 8; default: 4, fewer where
        shared memory runs out).
      store: ``"direct"`` (Y from registers) or ``"tma"`` (Y staged in
        shared memory and written by bulk copies; m * itemsize of Y a
        multiple of 16 bytes).
      block_policy: ``"normal"`` or ``"evict_first"`` (an L2 eviction hint
        on the slab stream, so that x, read 2*bw + 1 times, stays in L2).
      out: for ``"full"``, ``"copy"`` and ``"writeonly"``, a contiguous
        (n, m) tensor of the accumulation type to write Y into (x's own
        buffer, for one); default a new one.

    ``rows_per_cta``, ``store`` and ``block_policy`` go to the full kernel
    one at a time. ``"copy"`` takes float64, float32 and bf16 storage and
    any bs; the others float64 and bf16 with bs > 16. Not counted in
    ``banded_bsr_spmm.launches``: every variant's launch counts in
    ``banded_spmm_variant.launches``, and the copy's (kernel 9's) also in
    ``banded_spmm_variant.copy_launches``; the port's paths never call it.
    """
    name = "banded_spmm_variant"
    if variant not in SPMM_VARIANTS:
        raise ValueError(f"variant must be one of {SPMM_VARIANTS}, got "
                         f"{variant!r}")
    if rows_per_cta not in SPMM_ROWS_PER_CTA:
        raise ValueError(f"rows_per_cta must be one of {SPMM_ROWS_PER_CTA}")
    if store not in SPMM_STORES or block_policy not in SPMM_BLOCK_POLICIES:
        raise ValueError(f"store must be one of {SPMM_STORES} and "
                         f"block_policy one of {SPMM_BLOCK_POLICIES}")
    options = ((rows_per_cta != 1) + (store != "direct")
               + (block_policy != "normal"))
    if options > (1 if variant == "full" else 0):
        raise ValueError("rows_per_cta, store and block_policy vary the full "
                         "kernel, one at a time")
    if stages is not None and not 2 <= int(stages) <= SPMM_MAX_STAGES:
        raise ValueError(f"stages must be in [2, {SPMM_MAX_STAGES}]")
    if x.device.type != "cuda":
        raise NotImplementedError(
            f"{name}: CUDA tensors only (the plain version is "
            "banded_spmm_variant_plain)")
    K = _check_banded(blocks, x, bandwidth)
    sfx = _dense_suffix(name, blocks, x)
    nbr, bs, _ = blocks.shape
    if variant != "copy" and (sfx == "f32" or bs <= 16):
        raise NotImplementedError(
            f"{name} {variant!r}: float64 and bf16 storage with bs > 16 only "
            "(\"copy\" takes every type and bs)")
    _require_contiguous(name, blocks, x)
    n, m = x.shape
    acc = acc_dtype(x.dtype)
    if store == "tma" and (m * acc.itemsize) % 16:
        raise ValueError(f"{name}: store='tma' needs Y rows of a multiple of "
                         f"16 bytes, got m={m} in {acc}")
    colsum = y = None
    if variant == "noy":
        dev = x.device.index
        tm = banded_spmm_plan(torch.cuda.current_device() if dev is None
                              else dev, x.dtype, bs, m, variant)["TM"]
        colsum = torch.empty((nbr * -(-bs // tm), m), dtype=acc,
                             device=x.device)
    elif out is None:
        y = torch.empty((n, m), dtype=acc, device=x.device)
    else:
        if (tuple(out.shape) != (n, m) or out.dtype != acc
                or out.device != x.device or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous {(n, m)} {acc} tensor "
                             f"on {x.device}")
        y = out
    if n and m:
        _run(f"fdt_{name}_{sfx}", x.device, blocks.data_ptr(), x.data_ptr(),
             None if y is None else y.data_ptr(),
             None if colsum is None else colsum.data_ptr(), nbr, bs, K,
             int(bandwidth), m, SPMM_VARIANTS.index(variant), rows_per_cta,
             0 if stages is None else int(stages), SPMM_STORES.index(store),
             SPMM_BLOCK_POLICIES.index(block_policy))
        banded_spmm_variant.launches += 1
        if variant == "copy":
            banded_spmm_variant.copy_launches += 1
    return colsum if variant == "noy" else y


banded_spmm_variant.launches = 0
banded_spmm_variant.copy_launches = 0


# -- kernel 2: general block-ELL SpMM -----------------------------------

def bsr_spmm_plain(block_cols, blocks, x, out_dtype=None):
    """Plain PyTorch ``bsr_spmm``: gather the K (bs, m) slices of x by the
    column table and contract each block row as one product
    (``fortran_davidson_tpu/ops/sparse.py:689-697``)."""
    nbr, bs, kbs = blocks.shape
    m = x.shape[1]
    acc = acc_dtype(x.dtype)
    xb = x.to(acc).reshape(-1, bs, m)
    gathered = xb[block_cols.long()].reshape(nbr, kbs, m)
    out = torch.bmm(blocks.to(acc), gathered).reshape(nbr * bs, m)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def bsr_spmm(block_cols, blocks, x, out_dtype=None):
    """Y = A @ X for general block-ELL storage.

    Args:
      block_cols: (nbr, K) int32 block-column index of each slot (padded
        slots may point anywhere in range; their blocks must be zero). On
        the card a column outside [0, nbc) reads zeros; the plain version
        takes columns in range only.
      blocks: (nbr, bs, K*bs).
      x: (nbc*bs, m), the blocks' type.
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
    name = "bsr_spmm"
    if _on_cpu(name, x):
        return bsr_spmm_plain(block_cols, blocks, x, out_dtype)
    if (block_cols.dtype != torch.int32 or block_cols.device != x.device
            or not block_cols.is_contiguous()):
        raise ValueError("bsr_spmm: block_cols must be a contiguous int32 "
                         "tensor on x's device")
    sfx = _dense_suffix(name, blocks, x)
    _require_contiguous(name, blocks, x)
    y = torch.empty((nbr * bs, x.shape[1]), dtype=acc_dtype(x.dtype),
                    device=x.device)
    if y.numel():
        _run(f"fdt_{name}_{sfx}", x.device, block_cols.data_ptr(),
             blocks.data_ptr(), x.data_ptr(), y.data_ptr(), nbr, bs, K,
             x.shape[0], x.shape[1])
        bsr_spmm.launches += 1
    return _out(y, out_dtype)


bsr_spmm.launches = 0


# -- kernel 3: DIA-banded SpMM + Gram -----------------------------------

def banded_bsr_spmm_gram_plain(blocks, x, v=None, *, bandwidth: int,
                               write_out: bool = True, out_dtype=None):
    """Plain PyTorch ``banded_bsr_spmm_gram``: the plain apply, summed in
    the accumulation type, then G = Vᵀ Y (:func:`_gram_plain`)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    y = banded_bsr_spmm_plain(blocks, x, bandwidth,
                              out_dtype=acc_dtype(x.dtype))
    g = _gram_plain(x if v is None else v, y)
    return (y.to(out_dtype), g) if write_out else g


def banded_bsr_spmm_gram(blocks, x, v=None, *, bandwidth: int,
                         write_out: bool = True, out_dtype=None):
    """Fused banded SpMM + Gram: ``Y = A @ X`` and ``G = Vᵀ Y``.

    Args:
      blocks: (nbr, bs, K*bs) DIA-aligned storage, K = 2*bandwidth + 1.
      x: (nbr*bs, m), the blocks' type.
      v: (nbr*bs, mv) gram operand of x's type, rows contiguous (any row
        stride, e.g. the leading columns of the basis), or ``None`` for
        G = Xᵀ A X.
      write_out: also return Y; ``False`` returns G alone.
      out_dtype: Y's type (default ``x.dtype``).

    Returns:
      ``(Y, G)``, or ``G`` alone; G is float32 of shape (mv, m).
    """
    K = _check_banded(blocks, x, bandwidth)
    _check_v(v, x)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    name = "banded_bsr_spmm_gram"
    if _on_cpu(name, x):
        return banded_bsr_spmm_gram_plain(blocks, x, v, bandwidth=bandwidth,
                                          write_out=write_out,
                                          out_dtype=out_dtype)
    sfx = _dense_suffix(name, blocks, x)
    _require_contiguous(name, blocks, x)
    nbr, bs, _ = blocks.shape
    y, g, launched = _gram_launch(name, sfx, (blocks.data_ptr(),), x, v,
                                  write_out, acc_dtype(x.dtype), nbr, bs, K,
                                  int(bandwidth))
    if launched:
        banded_bsr_spmm_gram.launches += 1
        if x.dtype in TYPED_TYPES:
            counter = f"{_SUFFIX[x.dtype]}_launches"
            setattr(banded_bsr_spmm_gram, counter,
                    getattr(banded_bsr_spmm_gram, counter) + 1)
    return (_out(y, out_dtype), g) if write_out else g


banded_bsr_spmm_gram.launches = 0
# Kernel 3's bf16 and float64 entries (csrc/fused_gram_typed.cuh), counted
# also apart.
banded_bsr_spmm_gram.bf16_launches = 0
banded_bsr_spmm_gram.f64_launches = 0


def typed_gram_variant(blocks, x, v=None, *, bandwidth: int, variant: str,
                       write_out: bool = True):
    """One launch of a measurement variant of kernel 3's bf16 or float64
    entry (``"nogram"`` streams V and skips the gram's products, ``"nov"``
    reads no V; G is then not Vᵀ Y), which
    split its time as :func:`fused_gram_variant` splits float32's. CUDA
    tensors only; Y in the sums' type. Not counted in the wrapper's
    launches; the port's paths never call it."""
    K = _check_banded(blocks, x, bandwidth)
    _check_v(v, x)
    name = "banded_bsr_spmm_gram"
    if variant not in TYPED_VARIANTS[1:3]:
        raise ValueError(f"variant must be one of {TYPED_VARIANTS[1:3]}, got "
                         f"{variant!r}")
    if x.device.type != "cuda" or x.dtype not in TYPED_TYPES:
        raise NotImplementedError(f"{name} {variant}: bf16 or float64 CUDA "
                                  "tensors only")
    sfx = _dense_suffix(name, blocks, x)
    _require_contiguous(name, blocks, x)
    nbr, bs, _ = blocks.shape
    y, g, _ = _gram_launch(name, sfx, (blocks.data_ptr(),), x, v, write_out,
                           acc_dtype(x.dtype), nbr, bs, K, int(bandwidth),
                           variant=variant)
    return (y, g) if write_out else g


# -- kernel 4: int8 DIA-banded SpMM -------------------------------------

def _check_quantized(qblocks, scale_rows, diag, x, bandwidth: int,
                     ext: bool = False) -> int:
    """Shape and device checks of int8 banded storage over x (halo-extended
    with ``ext``); returns K."""
    K = _check_banded(qblocks, x, bandwidth, ext)
    nbr, bs, kbs = qblocks.shape
    if (tuple(scale_rows.shape) != (nbr, kbs)
            or tuple(diag.shape) != (nbr, bs)):
        raise ValueError(f"quantized banded needs ({nbr}, {kbs}) scale_rows "
                         f"and ({nbr}, {bs}) diag, got "
                         f"{tuple(scale_rows.shape)} / {tuple(diag.shape)}")
    if scale_rows.device != x.device or diag.device != x.device:
        raise ValueError("qblocks, scale_rows, diag and x must share a device")
    return K


def _quantized_args(name: str, qblocks, scale_rows, diag, x,
                    x_types=None) -> tuple:
    """Type and layout checks of the int8 kernels; their leading pointers.
    x is float32 or float64 (an entry each; ``x_types`` for another
    entry's), never cast."""
    x_types = x_types or (torch.float32, torch.float64)
    if x.dtype not in x_types:
        raise NotImplementedError(
            f"{name}: {x.dtype} x has no CUDA kernel (x of {x_types})")
    if (qblocks.dtype != torch.int8 or scale_rows.dtype != torch.float32
            or diag.dtype != torch.float32):
        raise ValueError(f"{name}: need int8 qblocks with float32 scale_rows "
                         "and diag")
    _require_contiguous(name, qblocks, scale_rows, diag, x)
    return qblocks.data_ptr(), scale_rows.data_ptr(), diag.data_ptr()


def banded_q_bsr_spmm_plain(qblocks, scale_rows, diag, x, bandwidth: int,
                            out_dtype=None):
    """Plain PyTorch ``banded_q_bsr_spmm``: the JAX package's fallback
    (``fortran_davidson_tpu/ops/sparse.py:1011-1025``): dequantize to x's
    type, the banded product summed into float32, plus d ∘ x in float32."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    deq = (qblocks.to(torch.float32) * scale_rows[:, None, :]).to(x.dtype)
    y = banded_bsr_spmm_plain(deq, x, bandwidth, out_dtype=torch.float32)
    y = y + diag.reshape(-1, 1) * x.to(torch.float32)
    return y.to(out_dtype)


def banded_q_bsr_spmm(qblocks, scale_rows, diag, x, bandwidth: int,
                      out_dtype=None):
    """y = (Q ∘ s) @ x_window + d ∘ x_centre on int8 DIA-banded storage.

    Args:
      qblocks: (nbr, bs, K*bs) int8, the quantized off-diagonal blocks.
      scale_rows: (nbr, K*bs) float32, each slot's scale over its lanes.
      diag: (nbr, bs) float32, the exact diagonal.
      x: (nbr*bs, m); float32 or float64 on a GPU (float64: the band
        summed in float64 and rounded to float32, d ∘ x added in float32,
        as the plain version does; counted also in ``f64_launches``).
      out_dtype: output type (default ``x.dtype``).
    """
    K = _check_quantized(qblocks, scale_rows, diag, x, bandwidth)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    name = "banded_q_bsr_spmm"
    if _on_cpu(name, x):
        return banded_q_bsr_spmm_plain(qblocks, scale_rows, diag, x,
                                       bandwidth, out_dtype)
    lead = _quantized_args(name, qblocks, scale_rows, diag, x)
    nbr, bs, _ = qblocks.shape
    y = torch.empty((nbr * bs, x.shape[1]), dtype=x.dtype, device=x.device)
    if y.numel():
        _run(f"fdt_{name}_{_SUFFIX[x.dtype]}", x.device, *lead, x.data_ptr(),
             y.data_ptr(),
             nbr, bs, K, int(bandwidth), x.shape[1])
        banded_q_bsr_spmm.launches += 1
        banded_q_bsr_spmm.f64_launches += x.dtype == torch.float64
    return _out(y, out_dtype)


banded_q_bsr_spmm.launches = 0
banded_q_bsr_spmm.f64_launches = 0

Q_SPMM_PLAN_KEYS = ("TN", "smem_bytes", "blocks_per_sm", "col_tiles",
                    "n_groups")


@functools.lru_cache(maxsize=256)
def q_spmm_plan(device_index: int, nbr: int, m: int) -> dict:
    """The layout of a float32-x launch of kernel 4 (``csrc/q_spmm.cu``):
    column tile, dynamic shared memory a block, blocks an SM, column tiles,
    row groups (blocks a column tile, each walking a range of block
    rows)."""
    out = (ctypes.c_int * len(Q_SPMM_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = _library().fdt_q_spmm_plan(nbr, m, out)
    if err != 0:
        raise RuntimeError(f"fdt_q_spmm_plan: CUDA error {err} (nbr={nbr}, "
                           f"m={m})")
    return dict(zip(Q_SPMM_PLAN_KEYS, out))


@functools.lru_cache(maxsize=256)
def q_spmm_f64_plan(device_index: int, bs: int, m: int) -> dict:
    """The layout of a float64-x launch of kernels 4 and 7
    (``csrc/q_spmm_f64.cu``, kernel 1's template): row tile, column tile,
    ring depth and dynamic shared memory a CTA, as :func:`banded_spmm_plan`
    reports kernel 1's."""
    out = (ctypes.c_int * len(SPMM_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = _library().fdt_q_spmm_f64_plan(bs, m, out)
    if err != 0:
        raise RuntimeError(f"fdt_q_spmm_f64_plan: CUDA error {err} (bs={bs}, "
                           f"m={m})")
    return dict(zip(SPMM_PLAN_KEYS, out))


# -- kernel 5: int8 DIA-banded SpMM + Gram ------------------------------

def banded_q_bsr_spmm_gram_plain(qblocks, scale_rows, diag, x, v=None, *,
                                 bandwidth: int, write_out: bool = True,
                                 out_dtype=None):
    """Plain PyTorch ``banded_q_bsr_spmm_gram``: the plain int8 apply in
    float32, then G = Vᵀ Y (:func:`_gram_plain`)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    y = banded_q_bsr_spmm_plain(qblocks, scale_rows, diag, x, bandwidth,
                                out_dtype=torch.float32)
    g = _gram_plain(x if v is None else v, y)
    return (y.to(out_dtype), g) if write_out else g


def banded_q_bsr_spmm_gram(qblocks, scale_rows, diag, x, v=None, *,
                           bandwidth: int, write_out: bool = True,
                           out_dtype=None):
    """int8 fused banded SpMM + Gram (see :func:`banded_bsr_spmm_gram` for
    ``v``, ``write_out`` and the return contract, and
    :func:`banded_q_bsr_spmm` for the storage); x and v float32 (the
    tensor-core kernel) or float64 (the typed template's int8 slab: kernel
    4's float64-x Y, then the gram summed in float64; counted also in
    ``f64_launches``) on a GPU."""
    K = _check_quantized(qblocks, scale_rows, diag, x, bandwidth)
    _check_v(v, x)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    name = "banded_q_bsr_spmm_gram"
    if _on_cpu(name, x):
        return banded_q_bsr_spmm_gram_plain(
            qblocks, scale_rows, diag, x, v, bandwidth=bandwidth,
            write_out=write_out, out_dtype=out_dtype)
    lead = _quantized_args(name, qblocks, scale_rows, diag, x)
    nbr, bs, _ = qblocks.shape
    y, g, launched = _gram_launch(name, _SUFFIX[x.dtype], lead, x, v,
                                  write_out, x.dtype, nbr, bs, K,
                                  int(bandwidth))
    if launched:
        banded_q_bsr_spmm_gram.launches += 1
        banded_q_bsr_spmm_gram.f64_launches += x.dtype == torch.float64
    return (_out(y, out_dtype), g) if write_out else g


banded_q_bsr_spmm_gram.launches = 0
banded_q_bsr_spmm_gram.f64_launches = 0


# -- kernel 6: DIA-banded SpMM over a halo-extended input --------------

# Kernel 6's routes, in the order of the C enum (csrc/ext_spmm.cu).
EXT_ROUTES = ("cp.async", "tma")
EXT_PLAN_KEYS = ("TM", "TN", "stages", "smem_bytes", "threads")


def ext_spmm_route(dtype: torch.dtype, bs: int, m: int, blocks_ptr: int = 0,
                   x_ext_ptr: int = 0) -> str:
    """Kernel 6's route for these operands, decided before the launch
    (``csrc/ext_spmm.cu`` refuses a ``"tma"`` launch that breaks it):
    ``"tma"`` where the tensor maps can describe them, namely bs a multiple
    of the row tile (16 for bs <= 16, else 128) and of the chunk depth (16
    elements, 32 for bf16), the x_ext row of m elements a multiple of 16
    bytes, and both bases 16-byte aligned; ``"cp.async"`` (kernel 1's
    template) for every other shape."""
    tm = 16 if bs <= 16 else 128
    kc = 32 if dtype == torch.bfloat16 else 16
    fits = (bs % tm == 0 and bs % kc == 0 and (m * dtype.itemsize) % 16 == 0
            and blocks_ptr % 16 == 0 and x_ext_ptr % 16 == 0)
    return "tma" if fits else "cp.async"


@functools.lru_cache(maxsize=256)
def ext_spmm_plan(device_index: int, dtype: torch.dtype, bs: int, m: int,
                  route: str) -> dict:
    """The layout of a kernel-6 launch by ``route`` (``csrc/ext_spmm.cu``):
    row tile, column tile, ring depth, dynamic shared memory a block and
    threads a block (the TMA route's include its producer warp)."""
    out = (ctypes.c_int * len(EXT_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = _library().fdt_ext_spmm_plan(list(_SUFFIX).index(dtype),
                                           EXT_ROUTES.index(route), bs, m,
                                           out)
    if err != 0:
        raise RuntimeError(f"fdt_ext_spmm_plan: CUDA error {err} ({dtype}, "
                           f"bs={bs}, m={m}, route={route})")
    return dict(zip(EXT_PLAN_KEYS, out))


def _ext_windows(x_ext, nbr: int, bs: int, K: int, acc):
    """The (nbr, K*bs, m) windows x_ext[r*bs : (r+K)*bs], in ``acc``."""
    m = x_ext.shape[1]
    xb = x_ext.to(acc).reshape(nbr + K - 1, bs, m)
    return xb.unfold(0, K, 1).permute(0, 3, 1, 2).reshape(nbr, K * bs, m)


def banded_ext_bsr_spmm_plain(blocks, x_ext, *, bandwidth: int,
                              out_dtype=None):
    """Plain PyTorch ``banded_ext_bsr_spmm``: unfold x_ext into the
    (nbr, K*bs, m) windows and contract each block row as one product,
    summed in the accumulation type."""
    nbr, bs, kbs = blocks.shape
    acc = acc_dtype(x_ext.dtype)
    out = torch.bmm(blocks.to(acc),
                    _ext_windows(x_ext, nbr, bs, kbs // bs, acc))
    out = out.reshape(nbr * bs, x_ext.shape[1])
    return out.to(x_ext.dtype if out_dtype is None else out_dtype)


def _ext_launch(name, route, blocks, x_ext, bandwidth, out_dtype):
    """Kernel 6 on CUDA tensors, on ``route`` (None: the rule's); raises
    if the TMA route is asked of operands that break the rule. Returns Y
    and whether the kernel was launched."""
    K = _check_banded(blocks, x_ext, bandwidth, ext=True)
    sfx = _dense_suffix(name, blocks, x_ext)
    _require_contiguous(name, blocks, x_ext)
    nbr, bs, _ = blocks.shape
    m = x_ext.shape[1]
    rule = ext_spmm_route(x_ext.dtype, bs, m, blocks.data_ptr(),
                          x_ext.data_ptr())
    route = rule if route is None else route
    if route == "tma" and rule != "tma":
        raise ValueError(f"{name}: the TMA route does not take bs={bs}, "
                         f"m={m} {x_ext.dtype} at these addresses")
    y = torch.empty((nbr * bs, m), dtype=acc_dtype(x_ext.dtype),
                    device=x_ext.device)
    if y.numel():
        _run(f"fdt_banded_ext_bsr_spmm_{sfx}", x_ext.device,
             blocks.data_ptr(), x_ext.data_ptr(), y.data_ptr(), nbr, bs, K,
             int(bandwidth), m, EXT_ROUTES.index(route))
    return _out(y, out_dtype), bool(y.numel())


def banded_ext_bsr_spmm(blocks, x_ext, *, bandwidth: int, out_dtype=None):
    """Y = A_local @ X for a shard's DIA-banded rows, over the halo-extended
    input (``fortran_davidson_tpu/ops/pallas_kernels.py:1190``), on the
    route :func:`ext_spmm_route` gives these operands.

    Args:
      blocks: (nbr, bs, K*bs), K = 2*bandwidth + 1, the shard's block rows.
      x_ext: ((nbr + 2*bandwidth)*bs, m), the blocks' type: the shard's
        rows framed by ``bandwidth`` block rows of halo on each side.
      out_dtype: output type (default ``x_ext.dtype``).
    """
    name = "banded_ext_bsr_spmm"
    out_dtype = x_ext.dtype if out_dtype is None else out_dtype
    if _on_cpu(name, x_ext):
        _check_banded(blocks, x_ext, bandwidth, ext=True)
        return banded_ext_bsr_spmm_plain(blocks, x_ext, bandwidth=bandwidth,
                                         out_dtype=out_dtype)
    y, launched = _ext_launch(name, None, blocks, x_ext, bandwidth,
                              out_dtype)
    banded_ext_bsr_spmm.launches += launched
    return y


banded_ext_bsr_spmm.launches = 0


def banded_ext_bsr_spmm_at(route: str, blocks, x_ext, *, bandwidth: int,
                           out_dtype=None):
    """Kernel 6 on a route of the caller's choice, for measurement (CUDA
    tensors only; not counted in ``banded_ext_bsr_spmm.launches``):
    ``"cp.async"`` takes any operands, ``"tma"`` those that
    :func:`ext_spmm_route` sends there (else it raises)."""
    if route not in EXT_ROUTES:
        raise ValueError(f"route must be one of {EXT_ROUTES}, got {route!r}")
    name = "banded_ext_bsr_spmm_at"
    if _on_cpu(name, x_ext):
        raise NotImplementedError(f"{name}: CUDA tensors only")
    return _ext_launch(name, route, blocks, x_ext, bandwidth,
                       x_ext.dtype if out_dtype is None else out_dtype)[0]


# -- kernel 7: int8 DIA-banded SpMM over a halo-extended input ---------

def banded_q_ext_bsr_spmm_plain(qblocks, scale_rows, diag, x_ext, *,
                                bandwidth: int, out_dtype=None):
    """Plain PyTorch ``banded_q_ext_bsr_spmm``: dequantize to x's type, the
    windowed product summed into float32, plus d ∘ x_centre in float32
    (the JAX package's ``local_q_xla``, ``parallel/halo.py:318-331``)."""
    out_dtype = x_ext.dtype if out_dtype is None else out_dtype
    nbr, bs, _ = qblocks.shape
    deq = (qblocks.to(torch.float32) * scale_rows[:, None, :]).to(x_ext.dtype)
    y = banded_ext_bsr_spmm_plain(deq, x_ext, bandwidth=bandwidth,
                                  out_dtype=torch.float32)
    centre = x_ext[bandwidth * bs:(bandwidth + nbr) * bs]
    y = y + diag.reshape(-1, 1) * centre.to(torch.float32)
    return y.to(out_dtype)


def banded_q_ext_bsr_spmm(qblocks, scale_rows, diag, x_ext, *,
                          bandwidth: int, out_dtype=None):
    """y = (Q ∘ s) @ x_ext[window] + d ∘ x_ext[centre] on a shard's int8
    DIA-banded rows (``fortran_davidson_tpu/ops/pallas_kernels.py:1059``;
    storage as :func:`banded_q_bsr_spmm`, input as
    :func:`banded_ext_bsr_spmm`); x_ext float32 (kernel 4's apply over all
    K slots) or float64 (kernel 4's float64-x kernel over all K slots,
    counted also in ``f64_launches``) on a GPU: either way a shard's rows
    put together give kernel 4's Y bit for bit."""
    K = _check_quantized(qblocks, scale_rows, diag, x_ext, bandwidth,
                         ext=True)
    nbr, bs, _ = qblocks.shape
    out_dtype = x_ext.dtype if out_dtype is None else out_dtype
    name = "banded_q_ext_bsr_spmm"
    if _on_cpu(name, x_ext):
        return banded_q_ext_bsr_spmm_plain(qblocks, scale_rows, diag, x_ext,
                                           bandwidth=bandwidth,
                                           out_dtype=out_dtype)
    lead = _quantized_args(name, qblocks, scale_rows, diag, x_ext)
    y = torch.empty((nbr * bs, x_ext.shape[1]), dtype=x_ext.dtype,
                    device=x_ext.device)
    if y.numel():
        _run(f"fdt_{name}_{_SUFFIX[x_ext.dtype]}", x_ext.device, *lead,
             x_ext.data_ptr(),
             y.data_ptr(), nbr, bs, K, int(bandwidth), x_ext.shape[1])
        banded_q_ext_bsr_spmm.launches += 1
        banded_q_ext_bsr_spmm.f64_launches += x_ext.dtype == torch.float64
    return _out(y, out_dtype)


banded_q_ext_bsr_spmm.launches = 0
banded_q_ext_bsr_spmm.f64_launches = 0


# -- kernel 8: DIA-banded SpMM over a shard and its received halos ------

ROW_SETS = ("all", "interior", "edge")


def remote_row_ranges(nbr: int, bandwidth: int, rows: str) -> list:
    """The block-row ranges ``[(lo, hi), ...]`` of one launch over
    ``rows``: ``"interior"`` is [bw, nbr - bw), which reads no halo;
    ``"edge"`` the first and last bw block rows, or every row when
    nbr <= 2*bw (then ``"interior"`` is empty)."""
    if rows not in ROW_SETS[1:]:
        raise ValueError(f"rows must be one of {ROW_SETS[1:]}, got {rows!r}")
    bw = int(bandwidth)
    if nbr <= 2 * bw:
        return [] if rows == "interior" or not nbr else [(0, nbr)]
    if rows == "interior":
        return [(bw, nbr - bw)]
    return [(0, bw), (nbr - bw, nbr)]


def _ext_slice(from_prev, x, from_next, lo: int, hi: int):
    """Rows [lo, hi) of ``[from_prev; x; from_next]``, read from the parts
    they overlap only (an interior range reads x alone)."""
    parts, start = [], 0
    for t in (from_prev, x, from_next):
        a, b = max(lo - start, 0), min(hi - start, t.shape[0])
        if a < b:
            parts.append(t[a:b])
        start += t.shape[0]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def banded_remote_halo_spmm_plain(blocks, x_local, from_prev, from_next, *,
                                  bandwidth: int, out_dtype=None):
    """Plain PyTorch ``banded_remote_halo_spmm``: kernel 6's plain version
    over ``[from_prev; x_local; from_next]``."""
    return banded_ext_bsr_spmm_plain(
        blocks, torch.cat([from_prev, x_local, from_next]),
        bandwidth=bandwidth, out_dtype=out_dtype)


def _check_remote(blocks, x, from_prev, from_next, bandwidth: int, rows,
                  out):
    """Checks of kernel 8's arguments; returns K."""
    K = _check_banded(blocks, x, bandwidth)
    halo = (int(bandwidth) * blocks.shape[1], x.shape[1])
    for name, t in (("from_prev", from_prev), ("from_next", from_next)):
        if tuple(t.shape) != halo:
            raise ValueError(f"{name} must be {halo}, got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is "
                             f"{x.dtype} on {x.device}")
    if rows not in ROW_SETS:
        raise ValueError(f"rows must be one of {ROW_SETS}, got {rows!r}")
    if out is None and rows != "all":
        raise ValueError(f"rows={rows!r} writes part of Y: pass the output "
                         "that the other launch fills as out=")
    if out is not None and (tuple(out.shape) != tuple(x.shape)
                            or out.dtype != acc_dtype(x.dtype)
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(x.shape)} "
                         f"{acc_dtype(x.dtype)} tensor on {x.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return K


def banded_remote_halo_spmm(blocks, x_local, from_prev, from_next, *,
                            bandwidth: int, rows: str = "all", out=None,
                            out_dtype=None):
    """Y = A_local @ [from_prev; x_local; from_next] for a shard's
    DIA-banded rows (``fortran_davidson_tpu/ops/pallas_kernels.py:1416``),
    reading the shard's rows and the two halos where they lie.

    Args:
      blocks: (nbr, bs, K*bs), K = 2*bandwidth + 1, the shard's block rows.
      x_local: (nbr*bs, m), the blocks' type: the shard's rows.
      from_prev, from_next: (bandwidth*bs, m), x's type: the ring
        predecessor's last and the successor's first rows.
      rows: ``"interior"`` or ``"edge"``, one launch over those block rows
        (:func:`remote_row_ranges`) into ``out``, which is then required.
        An ``"interior"`` launch reads neither halo, so it may run while
        they are still in flight; ``"edge"`` then fills the rest of
        ``out``. ``"all"`` (default): the two launches, one after the other.
      out: a contiguous (nbr*bs, m) tensor of the accumulation type that
        receives the rows; by default a new one.
      out_dtype: Y's type when ``out`` is not given (default x's type).

    Returns:
      ``out`` when given (the accumulation type), else Y in ``out_dtype``.
    """
    K = _check_remote(blocks, x_local, from_prev, from_next, bandwidth, rows,
                      out)
    nbr, bs, _ = blocks.shape
    bw, m = int(bandwidth), x_local.shape[1]
    acc = acc_dtype(x_local.dtype)
    y = (torch.empty((nbr * bs, m), dtype=acc, device=x_local.device)
         if out is None else out)
    name = "banded_remote_halo_spmm"
    on_cpu = _on_cpu(name, x_local)
    if not on_cpu:
        sfx = _dense_suffix(name, blocks, x_local)
        _require_contiguous(name, blocks, x_local, from_prev, from_next)
    for sel in ROW_SETS[1:] if rows == "all" else (rows,):
        ranges = remote_row_ranges(nbr, bw, sel)
        if on_cpu:
            for lo, hi in ranges:
                y[lo * bs:hi * bs] = banded_ext_bsr_spmm_plain(
                    blocks[lo:hi], _ext_slice(from_prev, x_local, from_next,
                                              lo * bs, (hi + 2 * bw) * bs),
                    bandwidth=bw, out_dtype=acc)
        elif ranges and m:
            (a0, a1), (b0, b1) = (ranges + [(0, 0)])[:2]
            _run(f"fdt_{name}_{sfx}", x_local.device, blocks.data_ptr(),
                 x_local.data_ptr(), from_prev.data_ptr(),
                 from_next.data_ptr(), y.data_ptr(), nbr, bs, K, bw, m, a0,
                 a1 - a0, b0, b1 - b0)
            banded_remote_halo_spmm.launches += 1
    if out is not None:
        return out
    return _out(y, x_local.dtype if out_dtype is None else out_dtype)


banded_remote_halo_spmm.launches = 0


# -- kernel 8 in one launch: the halos pushed from inside the kernel --------

# The window's slots: top holds the ring predecessor's last bw*bs rows
# (from_prev), bot the successor's first (from_next).
SLOTS = ("top", "bot")
TOP, BOT = 0, 1
# The window's layout (csrc/remote_push.cuh): a header of int64 words,
# arrived[slot][parity] at words 0-3 and consumed[slot] at words 4-5 (then
# the kernel's own counters), and the slots from byte 256, each buffer a
# multiple of 256 bytes.
WINDOW_HEADER = 256
_ARRIVED, _CONSUMED = 0, 4
# The bound of every wait of the protocol: past it the kernel records
# rank, epoch and slot and traps (the plain version raises).
PUSH_SPIN_LIMIT_NS = 10_000_000_000
# A fault record's ``what`` (csrc/remote_push.cuh).
_WAITS = {1: "arrived", 2: "consumed"}


class PushPlan(NamedTuple):
    """One apply's place in the protocol (:func:`push_plan`)."""

    parity: int       # the buffer of each slot that the epoch writes and reads
    reuse_after: int  # its pushers wait until the reader's consumed >= this


def push_plan(epoch: int) -> PushPlan:
    """The buffers and the waits of the push form's ``epoch``-th apply
    (1, 2, ...: the operator's host counter, the same on every rank).

    Epoch ``e`` writes and reads each slot's buffer ``e % 2``. Its pushers
    first wait until the receiving neighbour has read that buffer's
    previous rows, those of epoch ``e - 2`` (``consumed >= e - 2``: the
    window starts at 0, so epochs 1 and 2 wait on nothing); its readers
    wait until the slot's ``arrived`` flag of that buffer is ``e``, then,
    once the rows are read, set the sender's ``consumed`` to ``e``. The
    kernel takes the epoch alone and computes the same two numbers
    (``csrc/remote_halo.cu``); the plain version takes them from here.
    """
    if isinstance(epoch, bool) or not isinstance(epoch, int) or epoch < 1:
        raise ValueError(f"epoch must be an int >= 1, got {epoch!r}")
    return PushPlan(epoch % 2, epoch - 2)


def window_slot_bytes(rows: int, m: int, dtype: torch.dtype) -> int:
    """The bytes of one slot buffer that holds (rows, m) of ``dtype``,
    rounded up to 256."""
    return -(-rows * m * dtype.itemsize // 256) * 256


def window_slot_offset(slot: int, parity: int, slot_bytes: int) -> int:
    """Byte offset of slot ``slot``'s buffer ``parity`` in a window."""
    return WINDOW_HEADER + (2 * slot + parity) * slot_bytes


def window_bytes(slot_bytes: int) -> int:
    """The bytes of a window whose slot buffers hold ``slot_bytes``."""
    return WINDOW_HEADER + 4 * slot_bytes


class HaloWindow:
    """One rank's halo window and its ring neighbours' as it reaches them:
    what :func:`banded_remote_push_spmm` pushes into and reads.

    ``ptrs`` are the base addresses of this rank's window and of its
    predecessor's (left) and successor's (right), which are this rank's
    own at world size 1; ``mems``, where the memory is a tensor (the CPU,
    a window of one rank), are the same three as uint8 tensors, which the
    plain version needs. ``fault`` is the kernel's fault record, an int64
    tensor in host memory (page-locked on the card, where the kernel writes
    it): set, rank, epoch, slot, the wait, the flag's last value;
    ``fault_word`` is a numpy view of it, which the fault checks read
    without a tensor operation.
    ``epoch`` counts the applies that used the window
    (:meth:`next_epoch`); a new window starts again at 0.
    """

    def __init__(self, *, rank: int, slot_bytes: int, ptrs, fault,
                 device, mems=None):
        self.rank = int(rank)
        self.slot_bytes = int(slot_bytes)
        self.ptrs = tuple(int(p) for p in ptrs)
        self.fault = fault
        self.fault_word = fault.numpy()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.mems = None if mems is None else tuple(mems)
        self.state = {"epoch": 0}
        self.release = lambda: None
        _WINDOWS.add(self)
        if device.type == "cuda":
            _watch_faults()

    @classmethod
    def local(cls, device, slot_bytes: int) -> "HaloWindow":
        """The window of a rank that is its own ring neighbour (world size
        1), in tensor memory on ``device``: left and right are its own."""
        device = torch.device(device)
        mem = torch.zeros(window_bytes(slot_bytes), dtype=torch.uint8,
                          device=device)
        return cls(rank=0, slot_bytes=slot_bytes, ptrs=(mem.data_ptr(),) * 3,
                   fault=new_fault_record(device), device=device,
                   mems=(mem,) * 3)

    @property
    def epoch(self) -> int:
        return self.state["epoch"]

    def next_epoch(self) -> int:
        """The epoch of the next apply."""
        self.state["epoch"] += 1
        return self.state["epoch"]

    def buffer(self, which: int, slot: int, parity: int, dtype, rows: int,
               m: int):
        """Slot ``slot``'s buffer ``parity`` of window ``which`` (0 own, 1
        left, 2 right) as a (rows, m) tensor of ``dtype`` (tensor memory
        only)."""
        off = window_slot_offset(slot, parity, self.slot_bytes)
        return self.mems[which][off:off + rows * m * dtype.itemsize].view(
            dtype).view(rows, m)

    def flags(self, which: int):
        """Window ``which``'s arrived (words 0-3) and consumed (4-5) flags
        as an int64 tensor view (tensor memory only)."""
        return self.mems[which][:48].view(torch.int64)

    def raise_if_faulted(self) -> None:
        """Raise :class:`HaloPushFault` if a wait of the protocol ran out
        on this rank (the record in host memory, readable after the trap
        that lost the context)."""
        rec = [int(v) for v in self.fault.tolist()]
        if rec[0]:
            raise HaloPushFault(rec[1], rec[2], SLOTS[rec[3]],
                                _WAITS.get(rec[4], str(rec[4])), rec[5])


# Every live window, whose fault records halo_push_faults reads.
_WINDOWS = weakref.WeakSet()


@contextlib.contextmanager
def halo_push_faults(windows=None):
    """Name a push fault where its CUDA error surfaces. A wait of the push
    form that ran out traps, which loses the CUDA context: the next CUDA
    call anywhere raises a generic ``RuntimeError``, and the rank, epoch
    and slot are in the window's fault record. Inside this context such an
    error is raised as the :class:`HaloPushFault` of a window whose record
    is set, from the CUDA error; other errors pass unchanged. ``windows``:
    the windows to read (an apply's own); by default every live window
    whose record was set inside the context. The solver's loop
    (``core.loop.run_chunked``) and the push route's apply run inside it.
    """
    before = ()
    if windows is None:
        before = weakref.WeakSet(w for w in list(_WINDOWS) if _faulted(w))
    try:
        yield
    except HaloPushFault:
        raise
    except RuntimeError as exc:
        for window in list(_WINDOWS) if windows is None else windows:
            if window not in before and _faulted(window):
                try:
                    window.raise_if_faulted()
                except HaloPushFault as fault:
                    raise fault from exc
        raise


def _faulted(window) -> bool:
    return bool(window.fault_word[0])


# How often the fault watch reads the live windows' records, in seconds.
FAULT_WATCH_S = 0.01
_WATCH = {}


def _watch_faults() -> None:
    """Start, once, the thread that writes each push fault's message to
    stderr as soon as a kernel writes its record, before it traps. NCCL's
    watchdog thread may end the process on the CUDA error that follows,
    before the solve raises :class:`HaloPushFault`; the message (rank,
    epoch, slot) is then in the log all the same. Card windows only: the
    plain version raises where it waits."""
    if _WATCH:
        return

    def watch():
        told = weakref.WeakSet()
        while True:
            time.sleep(FAULT_WATCH_S)
            try:
                windows = list(_WINDOWS)
            except RuntimeError:  # the set changed while it was read
                continue
            for window in windows:
                if window in told or not _faulted(window):
                    continue
                told.add(window)
                try:
                    window.raise_if_faulted()
                except HaloPushFault as fault:
                    print(f"HaloPushFault: {fault}", file=sys.stderr,
                          flush=True)
    _WATCH["thread"] = threading.Thread(target=watch, daemon=True,
                                        name="halo-push-faults")
    _WATCH["thread"].start()


def new_fault_record(device):
    """A zeroed fault record for a window on ``device``: host memory,
    page-locked where the card writes it."""
    pin = torch.device(device).type == "cuda"
    return torch.zeros(8, dtype=torch.int64, pin_memory=pin)


def _window_call(entry: str, device, *args) -> int:
    with torch.cuda.device(device):
        return getattr(_library(), entry)(*args)


def window_alloc(device, nbytes: int) -> tuple:
    """``(ptr, handle)``: a zeroed window of ``nbytes`` on ``device``,
    cudaMalloc'd outside PyTorch's caching allocator, and its 64-byte IPC
    handle (``csrc/peer_window.cu``)."""
    ptr, handle = ctypes.c_void_p(0), ctypes.create_string_buffer(64)
    err = _window_call("fdt_window_alloc", device, nbytes, ctypes.byref(ptr),
                       handle)
    if err:
        raise RuntimeError(f"fdt_window_alloc({nbytes}): CUDA error {err}")
    return ptr.value, handle.raw


def window_open(device, handle: bytes) -> int:
    """A neighbour's window, from its IPC handle, in this process's address
    space (peer access enabled lazily)."""
    ptr = ctypes.c_void_p(0)
    err = _window_call("fdt_window_open", device,
                       ctypes.create_string_buffer(handle, 64),
                       ctypes.byref(ptr))
    if err:
        raise RuntimeError(f"cudaIpcOpenMemHandle: CUDA error {err}")
    return ptr.value


def window_close(device, ptr: int) -> None:
    err = _window_call("fdt_window_close", device, ptr)
    if err:
        raise RuntimeError(f"cudaIpcCloseMemHandle: CUDA error {err}")


def window_free(device, ptr: int) -> None:
    err = _window_call("fdt_window_free", device, ptr)
    if err:
        raise RuntimeError(f"cudaFree of a halo window: CUDA error {err}")


def window_flags(device, ptr: int) -> list:
    """The six flag words of the window at ``ptr`` (a synchronous copy)."""
    words = (ctypes.c_longlong * 6)()
    err = _window_call("fdt_window_read", device, ptr, words, 48)
    if err:
        raise RuntimeError(f"reading a halo window: CUDA error {err}")
    return list(words)


def _wait_flag(window: HaloWindow, epoch: int, slot: int, what: int,
               flag, want: int, at_least: bool) -> None:
    """The plain version's wait: poll ``flag`` (a one-element tensor) until
    it is ``want`` (``>=`` with ``at_least``); past PUSH_SPIN_LIMIT_NS
    record the fault and raise, as the kernel traps."""
    deadline = time.monotonic() + PUSH_SPIN_LIMIT_NS * 1e-9
    while True:
        v = int(flag)
        if (v >= want) if at_least else (v == want):
            return
        if time.monotonic() > deadline:
            window.fault.copy_(torch.tensor(
                [1, window.rank, epoch, slot, what, v, 0, 0]))
            window.raise_if_faulted()
        time.sleep(1e-5)


def banded_remote_push_spmm_plain(blocks, x_local, window, *,
                                  bandwidth: int, epoch: int,
                                  out_dtype=None):
    """Plain PyTorch ``banded_remote_push_spmm``: the kernel's dataflow on
    the window's tensors. Wait until each receiving neighbour has read the
    buffer's previous rows, copy the shard's first ``bw*bs`` rows into the
    predecessor's bot slot and its last into the successor's top slot and
    set their arrived flags to ``epoch``; wait for this rank's own slots to
    hold ``epoch``'s rows; then :func:`banded_remote_halo_spmm_plain` over
    them, and set the senders' consumed flags. Ranks simulated in one
    process run it on threads of their own (each waits for the others'
    pushes)."""
    if window.mems is None:
        raise ValueError("the plain push needs a window of tensor memory")
    plan = push_plan(epoch)
    bs, bw, m = blocks.shape[1], int(bandwidth), x_local.shape[1]
    halo, dt, p = bw * bs, x_local.dtype, plan.parity
    own, left, right = (window.flags(i) for i in range(3))
    pushes = ((BOT, 1, left, x_local[:halo]), (TOP, 2, right, x_local[-halo:]))
    for slot, which, flags, rows in pushes:
        _wait_flag(window, epoch, slot, 2, own[_CONSUMED + slot],
                   plan.reuse_after, True)
        window.buffer(which, slot, p, dt, halo, m).copy_(rows)
        flags[_ARRIVED + 2 * slot + p] = epoch
    for slot in (TOP, BOT):
        _wait_flag(window, epoch, slot, 1, own[_ARRIVED + 2 * slot + p],
                   epoch, False)
    y = banded_remote_halo_spmm_plain(
        blocks, x_local, window.buffer(0, TOP, p, dt, halo, m),
        window.buffer(0, BOT, p, dt, halo, m), bandwidth=bw,
        out_dtype=out_dtype)
    left[_CONSUMED + TOP] = epoch
    right[_CONSUMED + BOT] = epoch
    return y


def _check_push(blocks, x, window, bandwidth: int, epoch: int) -> int:
    """Checks of the push form's arguments; returns K."""
    K = _check_banded(blocks, x, bandwidth)
    push_plan(epoch)
    if not isinstance(window, HaloWindow):
        raise ValueError(f"window must be a HaloWindow, got "
                         f"{type(window).__name__}")
    if window.device != x.device:
        raise ValueError(f"window on {window.device}, x on {x.device}")
    need = int(bandwidth) * blocks.shape[1] * x.shape[1] * x.dtype.itemsize
    if window.slot_bytes < need:
        raise ValueError(f"window slots of {window.slot_bytes} B are too "
                         f"small for {need} B of halo rows")
    if blocks.shape[0] < int(bandwidth):
        raise ValueError(f"bandwidth {bandwidth} exceeds the shard's "
                         f"{blocks.shape[0]} block rows")
    return K


def banded_remote_push_spmm(blocks, x_local, window, *, bandwidth: int,
                            epoch: int, out_dtype=None):
    """Y = A_local @ [from_prev; x_local; from_next] for a shard's
    DIA-banded rows in one launch that also moves the halos: the TPU
    kernel's form (``fortran_davidson_tpu/ops/pallas_kernels.py:1416``,
    its in-kernel remote copies).

    The launch writes the shard's first ``bw*bs`` rows of x into the ring
    predecessor's window and its last into the successor's (through peer
    pointers), and reads its own halos from this rank's window once its
    neighbours' pushes of the same ``epoch`` have arrived
    (``csrc/remote_halo.cu``, ``csrc/remote_push.cuh``). Every rank calls
    it with the same epochs, in the same order (:func:`push_plan`).

    Args:
      blocks: (nbr, bs, K*bs), K = 2*bandwidth + 1, the shard's block rows.
      x_local: (nbr*bs, m), the blocks' type: the shard's rows.
      window: this rank's :class:`HaloWindow` on x's device, its slots at
        least ``bandwidth*bs*m`` elements of x's type.
      epoch: this apply's epoch, >= 1.
      out_dtype: Y's type (default x's type).
    """
    K = _check_push(blocks, x_local, window, bandwidth, epoch)
    out_dtype = x_local.dtype if out_dtype is None else out_dtype
    name = "banded_remote_push_spmm"
    if _on_cpu(name, x_local):
        return banded_remote_push_spmm_plain(
            blocks, x_local, window, bandwidth=bandwidth, epoch=epoch,
            out_dtype=out_dtype)
    window.raise_if_faulted()
    sfx = _dense_suffix(name, blocks, x_local)
    _require_contiguous(name, blocks, x_local)
    nbr, bs, _ = blocks.shape
    m = x_local.shape[1]
    y = torch.empty((nbr * bs, m), dtype=acc_dtype(x_local.dtype),
                    device=x_local.device)
    if y.numel():
        _run(f"fdt_{name}_{sfx}", x_local.device, blocks.data_ptr(),
             x_local.data_ptr(), y.data_ptr(), nbr, bs, K, int(bandwidth), m,
             *window.ptrs, window.fault.data_ptr(), window.slot_bytes, epoch,
             window.rank, PUSH_SPIN_LIMIT_NS)
        banded_remote_push_spmm.launches += 1
    return _out(y, out_dtype)


banded_remote_push_spmm.launches = 0


KERNELS = (banded_bsr_spmm, bsr_spmm, banded_bsr_spmm_gram,
           banded_q_bsr_spmm, banded_q_bsr_spmm_gram, banded_ext_bsr_spmm,
           banded_q_ext_bsr_spmm, banded_remote_halo_spmm,
           banded_remote_push_spmm)


# The wrappers whose float64-x launches are also counted apart
# (``f64_launches``): kernels 4 and 7.
F64_X_KERNELS = (banded_q_bsr_spmm, banded_q_ext_bsr_spmm)


def reset_launch_counts() -> None:
    for fn in (*KERNELS, banded_spmm_variant):
        fn.launches = 0
    for fn in F64_X_KERNELS:
        fn.f64_launches = 0
    banded_bsr_spmm_gram.bf16_launches = 0
    banded_bsr_spmm_gram.f64_launches = 0
    banded_q_bsr_spmm_gram.f64_launches = 0
    banded_spmm_variant.copy_launches = 0
