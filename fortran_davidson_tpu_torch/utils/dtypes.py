"""Dtype policy of the PyTorch port.

The reference computes everything in ``real64`` (``src/numeric_kinds.f90:10``).
The solver supports float64 (the default, reference parity) and float32.
PyTorch has float64 natively on the CPU and on the GPU, so there is no
counterpart of the JAX package's x64 switch.
"""

from __future__ import annotations

import numpy as np
import torch

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
