"""Strict-numerics debugging switches (counterpart of
``fortran_davidson_tpu/utils/debugging.py``).

The reference's CI builds Debug with runtime checks and floating-point
traps (``-fcheck=all -ffpe-trap=zero,overflow,underflow``,
``src/CMakeLists.txt:15-17``); the JAX package turns on
``jax_debug_nans``. PyTorch has no counterpart of that flag:
``torch.autograd.set_detect_anomaly`` checks backward passes only, and
the solver runs under ``no_grad``. So the trap is a process-wide flag
that the Davidson loop (``core/loop.py``) reads: while it is set, the
loop adds the finiteness of each iteration's Ritz values and the
NaN-freedom of its residual norms to the one host synchronisation it
already makes, and raises ``FloatingPointError`` (what ``jax_debug_nans``
raises) naming the iteration. A residual norm may be +inf: the refined
path marks a pair that does not exist yet so. With the flag off the loop
makes no extra synchronisation and its bits are unchanged.

    from fortran_davidson_tpu_torch.utils.debugging import strict_numerics
    strict_numerics()          # NaN trap for every later solve
"""

from __future__ import annotations

import contextlib

_TRAP = {"nans": False}


def nans_trapped() -> bool:
    """Whether the loop checks each iteration for NaNs (read per solve)."""
    return _TRAP["nans"]


def strict_numerics(debug_nans: bool = True, enable_x64: bool = True) -> None:
    """Enable the NaN trap globally (call before solves).

    ``enable_x64`` is accepted for the JAX package's signature and does
    nothing: PyTorch has float64 natively, and a solve's dtype is its
    ``dtype`` option.
    """
    del enable_x64
    if debug_nans:
        _TRAP["nans"] = True


@contextlib.contextmanager
def nan_trap():
    """Context manager: the NaN trap for the enclosed solves only."""
    prev = _TRAP["nans"]
    _TRAP["nans"] = True
    try:
        yield
    finally:
        _TRAP["nans"] = prev
