"""Native (C++) host-side assembly: COO -> padded ELL and RCM ordering.

The port's copy of ``fortran_davidson_tpu/native/``: ``assembly.cpp`` is
that package's file with its code unchanged (one comment cites the
reference's build file without a machine path), and this binding follows
its ``__init__.py``. The first call compiles ``assembly.cpp`` with the
system ``g++`` into ``fortran_davidson_tpu_torch/_build/`` (named by a
hash of the source and the flags, written under a temporary name and
renamed into place) and binds it with ctypes. Host code, not a device
kernel: every function has a numpy or scipy fallback, and the native
path never changes a result, only assembly time
(``tests/test_torch_ell.py`` holds native against numpy).

:func:`status` says whether the library was built and which functions
took it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "assembly.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
# Which calls took the native library (counted per function).
_used = {"ell_from_coo": 0, "rcm_order": 0}


def library_path() -> Path:
    """Where the built library lives: named by a hash of the source and
    the flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + b"\0" + _SRC.read_bytes())
    return _BUILD_DIR / f"assembly_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load() -> Optional[ctypes.CDLL]:
    """The bound native library, building it if needed; None if no
    toolchain is available (callers fall back to numpy or scipy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for suffix, t in (("f64", np.float64), ("f32", np.float32)):
            fn = getattr(lib, f"ell_from_coo_{suffix}")
            fn.restype = i64
            fn.argtypes = [
                i64, i64, p_i64, p_i64,
                np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS"), i64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
        lib.rcm_order.restype = i64
        lib.rcm_order.argtypes = [i64, i64, p_i64, p_i64, p_i64]
        _lib = lib
        return _lib


def status() -> dict:
    """``{"built": bool, "path": str or None, "used": {function: calls}}``:
    whether the library is loaded, and how many calls of each function
    ran in it (the rest took the fallback)."""
    return {"built": _lib is not None,
            "path": str(library_path()) if _lib is not None else None,
            "used": dict(_used)}


def rcm_order(rows, cols, n: int):
    """Reverse Cuthill-McKee ordering of the symmetrized COO pattern.

    Returns the (n,) new-to-old permutation (``perm[i]`` = original index
    of the node at new position ``i``). Native C++ when available; else
    ``scipy.sparse.csgraph.reverse_cuthill_mckee`` (an ordering of equal
    quality, not the same one), else None. Out-of-range indices raise
    ``ValueError``.
    """
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    if len(rows) != len(cols):
        raise ValueError(f"COO rows and cols differ in length: {len(rows)} "
                         f"and {len(cols)}")
    lib = load()
    if lib is not None:
        perm = np.empty(n, np.int64)
        if lib.rcm_order(n, len(rows), rows, cols, perm) < 0:
            raise ValueError("COO indices out of range")
        _used["rcm_order"] += 1
        return perm
    try:
        import scipy.sparse
        import scipy.sparse.csgraph as csg
    except ImportError:
        return None
    if len(rows) and not (min(rows.min(), cols.min()) >= 0
                          and max(rows.max(), cols.max()) < n):
        raise ValueError("COO indices out of range")
    pattern = scipy.sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)).tocsr()
    return np.asarray(csg.reverse_cuthill_mckee(pattern, symmetric_mode=True),
                      np.int64)


def ell_from_coo(rows, cols, vals, n: int, pad_width: Optional[int] = None):
    """Native COO -> padded-ELL assembly (duplicates summed); returns
    ``(indices, values)`` as numpy arrays, or None when the library is
    unavailable or the dtype is neither float64 nor float32. Out-of-range
    indices and a ``pad_width`` below the widest row raise ``ValueError``.
    """
    lib = load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals)
    if vals.dtype == np.float64:
        fn = lib.ell_from_coo_f64
    elif vals.dtype == np.float32:
        fn = lib.ell_from_coo_f32
    else:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    nnz = len(rows)
    if not len(cols) == len(vals) == nnz or vals.ndim != 1:
        raise ValueError(f"COO rows, cols and vals differ in length: {nnz}, "
                         f"{len(cols)} and {len(vals)}")
    needed = fn(n, nnz, rows, cols, vals, 0, None, None)
    if needed < 0:
        raise ValueError("COO indices out of range")
    L = max(int(needed), 1)
    if pad_width is not None:
        if pad_width < needed:
            raise ValueError(
                f"pad_width={pad_width} < max row nnz {needed}")
        L = max(pad_width, 1)
    indices = np.empty((n, L), np.int32)
    values = np.empty((n, L), vals.dtype)
    rc = fn(n, nnz, rows, cols, vals, L,
            indices.ctypes.data_as(ctypes.c_void_p),
            values.ctypes.data_as(ctypes.c_void_p))
    if rc < 0:
        raise ValueError("COO indices out of range")
    _used["ell_from_coo"] += 1
    return indices, values
