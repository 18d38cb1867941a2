"""Small dense linear-algebra surface (lapack_wrapper parity), the
counterpart of ``fortran_davidson_tpu/utils/linalg.py``.

Named equivalents of the reference's LAPACK wrapper routines
(``src/lapack_wrapper.f90:9-10``). The eager helper
:func:`check_finite` raises :class:`NumericalError` naming the routine,
the way ``check_lapack_call`` aborts (``src/lapack_wrapper.f90:395-408``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from fortran_davidson_tpu_torch.core.orthogonal import (cholesky_nan, cholqr2,
                                                        eigh)
from fortran_davidson_tpu_torch.utils.errors import NumericalError


def generalized_eigensolver(H, S=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """All eigenpairs, ascending — DSYEV / DSYGV(itype=1) semantics
    (``src/lapack_wrapper.f90:14-91``). With S, eigenvectors come back
    S-orthonormal."""
    if S is None:
        return eigh(H)
    L = cholesky_nan(S)
    C1 = torch.linalg.solve_triangular(L, H, upper=False)
    C = torch.linalg.solve_triangular(L, C1.T, upper=False).T
    C = 0.5 * (C + C.T)
    w, Y = eigh(C)
    return w, torch.linalg.solve_triangular(L.T, Y, upper=True)


def generalized_eigensolver_lowest(H, lowest: int, S=None):
    """Lowest-k eigenpairs (a working DSYGVX,
    ``src/lapack_wrapper.f90:93-174``)."""
    w, W = generalized_eigensolver(H, S)
    return w[:lowest], W[:, :lowest]


def qr_orthonormalize(X, method: str = "cholqr2"):
    """Orthonormal basis of span(X) — DGEQRF+DORGQR semantics
    (``src/lapack_wrapper.f90:176-236``); CholeskyQR2 by default,
    ``method="qr"`` for Householder."""
    if method == "qr":
        return torch.linalg.qr(X)[0]
    return cholqr2(X)[0]


def solve_symmetric(A, b, retry_jitter: bool = True):
    """Solve the symmetric (possibly indefinite) system A x = b — DSYSV
    semantics, with the reference's singular-pivot retry
    (``src/lapack_wrapper.f90:267-273``): a solve that fails or gives
    non-finite values is redone with a tiny diagonal regularization.
    ``solve_ex`` reports failure on the device, so neither solve waits
    for the host."""
    x, info = torch.linalg.solve_ex(A, b)
    if not retry_jitter:
        return x
    tiny = torch.finfo(A.dtype).tiny ** 0.25
    scale = torch.clamp(torch.max(torch.abs(A)), min=1.0)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    x2, _ = torch.linalg.solve_ex(A + tiny * scale * eye, b)
    ok = torch.all(torch.isfinite(x)) & (info == 0)
    return torch.where(ok, x, x2)


def sort_eigenpairs(w, V=None, ascending: bool = True):
    """Sort eigenvalues (and matching eigenvector columns) — DLASRT plus
    the reference's index-recovery scan (``src/lapack_wrapper.f90:367-392``)."""
    order = torch.argsort(w if ascending else -w, stable=True)
    if V is None:
        return w[order]
    return w[order], V[:, order]


def check_finite(name: str, *arrays) -> None:
    """Raise :class:`NumericalError` naming ``name`` if any array holds a
    non-finite value."""
    for arr in arrays:
        if not bool(torch.all(torch.isfinite(torch.as_tensor(arr)))):
            raise NumericalError(
                f"Call to routine {name} produced non-finite values")
