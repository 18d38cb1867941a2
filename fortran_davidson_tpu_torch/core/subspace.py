"""Rayleigh-Ritz projection on a padded subspace (counterpart of
``fortran_davidson_tpu/core/subspace.py``).

Inactive basis columns are exactly zero, so the projected matrices have
zero rows/columns there. Large, distinct penalties on the inactive
diagonal (and 1s on the inactive diagonal of the B projection) make the
padded problem block-diagonal: the active eigenpairs come out first in
ascending order and the inactive ones sort last. The penalties decide the
eigenpair order, so they are the JAX package's exactly.

The solver may hand over a leading (w, w) window of the padded
(m_max, m_max) problem when it knows columns past w are inactive; the
penalties then take ``m_max`` so each column's value is unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from fortran_davidson_tpu_torch.core import orthogonal
from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
from fortran_davidson_tpu_torch.utils import ds as dsm


def initial_subspace(diag, m_init: int, m_max: int, rows: Rows = LOCAL):
    """Canonical unit vectors at the positions of the ``m_init`` smallest
    diagonal entries (ascending, ties by index), padded to ``m_max``.

    Mirrors ``generate_preconditioner`` (``src/array_utils.f90:136-160``).
    ``diag`` holds the local rows; the pick is over all rows (``rows``),
    and a rank sets the ones that fall in its rows.
    """
    n = diag.shape[0]
    idx = rows.smallest(diag, m_init) - rows.offset
    col = torch.arange(m_init, device=diag.device)
    mine = (idx >= 0) & (idx < n)
    V = torch.zeros((n, m_max), dtype=diag.dtype, device=diag.device)
    V[idx[mine], col[mine]] = 1.0
    return V


def initial_subspace_with_guess(diag, X0, m_init: int, m_max: int,
                                rows: Rows = LOCAL, precise: bool = False):
    """Warm-started basis: the (n, j) guess ``X0`` plus the canonical
    preconditioner fill, SVQB-orthonormalized together (rank-deficient
    guesses lose their redundant directions).

    Returns ``(V0, col_ok, m0)`` with ``m0`` the live count as a 0-d
    tensor (no host synchronisation). ``precise`` (the refined path) takes
    compensated Grams and the expand step's noise-floor rank threshold.
    """
    n = diag.shape[0]
    j = X0.shape[1]
    dt = diag.dtype
    eps = torch.finfo(dt).eps
    rank_rtol = (max(m_init * eps, (10.0 * eps) ** 2 * rows.size * n)
                 if precise else None)
    C = torch.zeros((n, m_init), dtype=dt, device=diag.device)
    C[:, :j] = X0.to(dt)
    if m_init > j:
        C[:, j:] = initial_subspace(diag, m_init - j, m_init - j, rows)
    Q, alive = orthogonal.svqb(C, torch.ones((m_init,), dtype=dt,
                                             device=diag.device),
                               rank_rtol=rank_rtol, return_alive=True,
                               rows=rows, precise=precise)
    V0 = torch.zeros((n, m_max), dtype=dt, device=diag.device)
    V0[:, :m_init] = Q
    col_ok = torch.zeros((m_max,), dtype=dt, device=diag.device)
    col_ok[:m_init] = alive
    return V0, col_ok, torch.sum(alive).to(torch.int64)


def project(V, AV, rows: Rows = LOCAL):
    """Projected (Gram) matrix H = V^T (A V)."""
    return rows.sum(V.T @ AV)


def project_ds(V, AV, rows: Rows = LOCAL) -> "dsm.DS":
    """The compensated projection H = Vᵀ(AV) as a DS pair
    (``utils.ds.gram_ds``): the refined Rayleigh-Ritz's H_ds, and S_ds =
    Vᵀ(BV) for a pencil."""
    return dsm.gram_ds(V, AV, rows=rows)


def _pad_penalties(H, mask, m_max: Optional[int] = None):
    """Large, distinct diagonal entries for the inactive block.

    Must exceed every active eigenvalue; |lambda| <= ||H||_F and the padded
    rows/cols of H are zero, so 16(||H||_F + 1) is a safe bound. Distinct
    offsets keep the padded block non-degenerate.
    """
    w = H.shape[0]
    m_max = w if m_max is None else m_max
    scale = 16.0 * (torch.linalg.norm(H) + 1.0)
    offsets = 1.0 + torch.arange(w, dtype=H.dtype, device=H.device) / m_max
    return (1.0 - mask) * scale * offsets


def masked_eigh(H, mask, m_max: Optional[int] = None):
    """Eigendecomposition of the active block of a padded symmetric H:
    the first sum(mask) eigenpairs (ascending) are the active ones."""
    return orthogonal.eigh(H + torch.diag(_pad_penalties(H, mask, m_max)))


def masked_generalized_eigh(H, S, mask, m_max: Optional[int] = None):
    """H w = lambda S w on the active block by Cholesky reduction (DSYGV
    itype=1, ``src/lapack_wrapper.f90:59-78``); W^T S W = I."""
    Hm = H + torch.diag(_pad_penalties(H, mask, m_max))
    Sm = S + torch.diag(1.0 - mask)
    L = orthogonal.cholesky_nan(Sm)
    C1 = torch.linalg.solve_triangular(L, Hm, upper=False)
    C = torch.linalg.solve_triangular(L, C1.T, upper=False).T
    C = 0.5 * (C + C.T)
    w, Y = orthogonal.eigh(C)
    W = torch.linalg.solve_triangular(L.T, Y, upper=True)
    return w, W


def ritz_decomposition(H, S, mask, m_max: Optional[int] = None):
    """Dispatch standard vs generalized masked Rayleigh-Ritz."""
    if S is None:
        return masked_eigh(H, mask, m_max)
    return masked_generalized_eigh(H, S, mask, m_max)
