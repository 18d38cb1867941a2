"""Dtype and device policy of the PyTorch port.

The reference computes everything in ``real64`` (``src/numeric_kinds.f90:10``).
The solver supports float64 (the default, reference parity) and float32.
PyTorch has float64 natively on the CPU and on the GPU, so there is no
counterpart of the JAX package's x64 switch.

Devices: the port runs on the card unless the caller asks for the CPU.
An entry point that builds tensors from numpy, Python values or a seed
puts them on :func:`default_device` of its ``device`` argument; a tensor
that already lives on a device keeps following it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from fortran_davidson_tpu_torch.utils.errors import DeviceUnavailableError


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises :class:`DeviceUnavailableError` for ``None`` when there is no
    CUDA device: it never drops to the CPU quietly.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_device_tensor(obj, device=None) -> torch.Tensor:
    """``obj`` as a tensor: on ``device`` when it is given; else a tensor
    stays on its own device and anything else goes to
    :func:`default_device` (the GPU)."""
    if isinstance(obj, torch.Tensor) and device is None:
        return obj
    return torch.as_tensor(obj, device=default_device(device))


_BY_NAME = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _BY_NAME:
        raise ValueError(f"Unsupported dtype {dtype!r}")
    return _BY_NAME[name]


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a float32/float64 torch dtype (or name)."""
    dt = as_torch_dtype(dtype)
    if dt == torch.bfloat16:
        raise ValueError("numpy has no bfloat16")
    return np.dtype(str(dt).removeprefix("torch."))


def ensure_x64() -> None:
    """Kept for the JAX package's API, where it turns on JAX's 64-bit
    mode. PyTorch has float64 on the CPU and the GPU at all times: a
    no-op."""


def canonical_dtype(dtype) -> torch.dtype:
    """Normalize a user-supplied solver dtype (float32 or float64)."""
    dt = as_torch_dtype(dtype)
    if dt not in (torch.float32, torch.float64):
        raise ValueError(
            f"Unsupported dtype {dt}; the Davidson solver supports float32 and "
            "float64 (bfloat16 is an operator storage type only).")
    return dt


def eps(dtype) -> float:
    return float(torch.finfo(as_torch_dtype(dtype)).eps)


def safe_denominator(d, dtype=None, floor_scale: float = 1e2):
    """Clamp near-zero denominators away from zero, preserving sign.

    The reference divides by ``lambda_j - A_ii`` unguarded
    (``src/davidson.f90:691-693``), which can produce inf/NaN when a Ritz
    value collides with a diagonal entry. Values with magnitude below
    ``floor_scale * eps * max|d|`` are replaced by that floor with the
    original sign (sign(0) treated as +). No host synchronisation.
    """
    dt = d.dtype if dtype is None else as_torch_dtype(dtype)
    scale = torch.max(torch.abs(d))
    floor = floor_scale * eps(dt) * torch.clamp(scale, min=1.0)
    mag = torch.maximum(torch.abs(d), floor)
    sign = torch.where(d < 0, -1.0, 1.0).to(dt)
    return sign * mag


# ``matmul_precision`` names that let cuBLAS take float32 products in a
# reduced mode. PyTorch's flag API offers one such mode for float32 GEMMs
# on the card, TF32 (``allow_tf32``): ``"tensorfloat32"`` and
# ``"bfloat16_3x"`` (the JAX package's 3-pass bf16, ~float32 accurate on a
# TPU) map onto it, and so does ``"bfloat16"``, whose bf16 mode the CUDA
# backend does not take.
REDUCED_PRECISIONS = ("tensorfloat32", "bfloat16_3x", "bfloat16")


@contextlib.contextmanager
def full_precision_matmuls(precision=None):
    """The solver's matmul-precision context (the GPU form of the JAX
    package's ``_precision_ctx``, ``fortran_davidson_tpu/core/loop.py:54-68``).

    ``precision`` is a resolved ``matmul_precision``. ``None``,
    ``"float32"`` and ``"highest"`` turn TF32 off: it keeps ~10 mantissa
    bits, which poisons the projected matrix, Ritz products and residuals
    of a float32 solve and the compensated Grams and applies of the
    refined path. A name in :data:`REDUCED_PRECISIONS` turns it on.
    Only the CUDA backend's flags are touched, so a solve on the CPU
    stays full float32 whatever the name, as the JAX package's does; no
    effect on float64. Every flag is restored on exit, also when the
    block raises. The solver's loop and the refined functions that can be
    called outside it (``core/refine.refined_pairs``, ``polish``) run
    under it.
    """
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    reduced = precision in REDUCED_PRECISIONS
    torch.backends.cuda.matmul.allow_tf32 = reduced
    torch.backends.cudnn.allow_tf32 = reduced
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
