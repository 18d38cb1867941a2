"""Correction-vector schemes: DPR and Olsen (counterpart of
``fortran_davidson_tpu/core/correction.py``).

DPR: ``corr[i, j] = r[i, j] / (lambda_j * B_ii - A_ii)`` with near-zero
denominators clamped (``src/davidson.f90:688-696``). Olsen adds the skew
projection that keeps the correction orthogonal to the Ritz vector.
GJD is a known method name, but its solver (the block MINRES of
``core/krylov.py``) is not ported yet: the solver entry point rejects it.
"""

from __future__ import annotations

import torch

from fortran_davidson_tpu_torch.utils.dtypes import safe_denominator
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError

METHODS = ("DPR", "GJD", "OLSEN")


def validate_method(method: str) -> str:
    m = str(method).upper()
    if m not in METHODS:
        raise InvalidOptionsError(
            f"Unknown correction method {method!r}; available: {METHODS}")
    return m


def dpr_correction(R, lam, diag_a, diag_b, mask):
    """DPR correction for a block of residuals.

    Args:
      R: (n, b) residual block (inactive columns zero).
      lam: (b,) Ritz values.
      diag_a, diag_b: (n,) diagonals of A and B (ones for B = I).
      mask: (b,) active-column mask.
    """
    den = safe_denominator(lam[None, :] * diag_b[:, None] - diag_a[:, None])
    return (R / den) * mask[None, :]


def olsen_correction(R, lam, X, diag_a, diag_b, mask):
    """Olsen correction: ``t = K⁻¹r - μ K⁻¹x`` with
    ``μ = xᵀK⁻¹r / xᵀK⁻¹x``, so that ``xᵀt = 0`` (K = diag(λB - A))."""
    den = safe_denominator(lam[None, :] * diag_b[:, None] - diag_a[:, None])
    kinv_r = R / den
    kinv_x = X / den
    num = torch.sum(X * kinv_r, dim=0)
    dnm = torch.sum(X * kinv_x, dim=0)
    mu = torch.where(torch.abs(dnm) > 0,
                     num / torch.where(dnm != 0, dnm, 1.0), 0.0)
    return (kinv_r - kinv_x * mu[None, :]) * mask[None, :]
