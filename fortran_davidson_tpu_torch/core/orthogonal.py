"""Masked block orthonormalization (counterpart of
``fortran_davidson_tpu/core/orthogonal.py``, non-refined branches).

The reference re-orthonormalizes the entire grown basis with a
Householder QR every expansion (``src/davidson.f90:213``). The port, like
the JAX package, keeps the existing basis columns untouched and
orthonormalizes only the new block against them with CGS2 followed by an
intra-block rank-revealing SVQB (or Householder QR), so cached A@V stays
valid and the operator runs on the new columns only. In exact arithmetic
the span equals the reference's QR span, so iteration counts match.

Invariants (as in the JAX package): inactive columns are exactly zero,
active columns need not be a prefix of the basis, and vanished directions
are dropped, never filled with arbitrary vectors.
"""

from __future__ import annotations

from typing import Optional

import torch


def col_mask(m, m_max: int, dtype, device=None):
    """(m_max,) float mask: 1.0 for columns < m (m an int or a 0-d tensor)."""
    if isinstance(m, torch.Tensor):
        device = m.device
    return (torch.arange(m_max, device=device) < m).to(dtype)


def project_out(V, block):
    """Remove the component of ``block`` lying in span(V's nonzero columns)."""
    return block - V @ (V.T @ block)


def _eye(m: int, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def cholesky_nan(G):
    """Lower Cholesky factor without a host synchronisation.

    ``torch.linalg.cholesky`` checks LAPACK/cuSOLVER's info on the host;
    ``cholesky_ex`` does not. A failed factorization gives NaNs, as
    ``jnp.linalg.cholesky`` does, so a broken basis cannot pass silently.
    """
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def orthonormalize_block(V, block, mask, n_reorth: int = 2,
                         method: str = "cholqr2",
                         rank_width: Optional[int] = None):
    """Orthonormalize ``block`` against the basis ``V`` and itself.

    Args:
      V: (n, w) basis (inactive columns exactly zero).
      block: (n, b) candidate new directions; only columns where ``mask``
        is 1 are meaningful and they form a prefix.
      mask: (b,) float prefix mask of active block columns.
      n_reorth: number of CGS passes against V (2 = CGS2).
      rank_width: the padded block width the SVQB rank threshold is scaled
        with (default ``b``). The solver passes the JAX engine's padded
        width when it hands over a narrower block, so the threshold, and
        with it which columns survive, is the JAX package's.

    Returns:
      ``(q, alive)``: (n, b) block with orthonormal active columns,
      orthogonal to V (dropped columns exactly zero, survivors compacted
      to a prefix), and the (b,) float mask of surviving columns.
    """
    dt = block.dtype
    block = block * mask[None, :]
    norms_before = torch.linalg.vector_norm(block, dim=0)
    for _ in range(n_reorth):
        block = project_out(V, block)
    # Drop columns that lost (nearly) all their mass to the projection:
    # what survives is roundoff of the subtraction, not a new direction.
    norms_after = torch.linalg.vector_norm(block, dim=0)
    finfo = torch.finfo(dt)
    drop_tol = finfo.eps ** 0.5
    alive = (norms_after > drop_tol * torch.clamp(norms_before,
                                                  min=finfo.tiny)) \
        & (mask > 0.5)
    block = block * alive[None, :].to(dt)
    mask = mask * alive.to(dt)
    if method == "qr":
        # Compact survivors to a prefix first: with an interior zero
        # column, Householder QR routes components of later columns onto
        # the arbitrary completion column at the hole.
        order = torch.argsort((~alive).to(torch.int8), stable=True)
        block = block[:, order]
        mask = mask[order]
        q, _ = torch.linalg.qr(block)
        q = q * mask[None, :]
        # Householder QR completes zero columns with arbitrary directions
        # that may lie in span(V): sweep once more and renormalize.
        q = project_out(V, q)
        norms = torch.linalg.vector_norm(q, dim=0)
        inv = torch.where(norms > 0, 1.0 / torch.where(norms > 0, norms, 1.0),
                          0.0)
        return q * inv[None, :], (norms > 0.5).to(dt)
    return svqb(block, mask, return_alive=True, rank_width=rank_width)


def cholqr_once(X, unit_diag=None, jitter: float = 0.0):
    """One CholeskyQR pass: X = Q R via R = chol(X^T X)^T, Q = X R^{-1}.

    ``unit_diag``: optional (m,) 0/1 mask; positions with 0 get a unit
    Gram diagonal so exactly-zero (padded) columns pass through as zero
    columns instead of breaking the factorization.
    """
    G = X.T @ X
    if unit_diag is not None:
        G = G + torch.diag(1.0 - unit_diag)
    if jitter:
        G = G + jitter * torch.mean(torch.diagonal(G)) * _eye(G.shape[0], G)
    L = cholesky_nan(G)
    Linv = torch.linalg.solve_triangular(L, _eye(L.shape[0], L), upper=False)
    return X @ Linv.T, L.T


def cholqr2(X, unit_diag=None, jitter: float = 0.0):
    """CholeskyQR2 (Yamamoto et al.): two passes give orthogonality at
    working precision for cond(X) up to ~1/sqrt(eps)."""
    Q1, R1 = cholqr_once(X, unit_diag, jitter)
    Q2, R2 = cholqr_once(Q1, unit_diag, jitter)
    return Q2, R2 @ R1


def svqb(block, mask, rank_rtol=None, return_alive: bool = False,
         rank_width: Optional[int] = None):
    """SVQB (Stathopoulos & Wu 2002): rank-revealing block
    orthonormalization through the eigendecomposition of the Gram matrix.

    Directions whose Gram eigenvalue falls below ``rank_rtol * s_max``
    are dropped (zero columns) instead of being completed with arbitrary
    vectors. ``mask`` marks the active columns (inactive columns are zero
    and stay zero). Kept columns are compacted into a prefix.
    """
    dt = block.dtype
    width = block.shape[1] if rank_width is None else rank_width
    norms = torch.linalg.vector_norm(block, dim=0)
    inv = torch.where(norms > 0, 1.0 / torch.where(norms > 0, norms, 1.0), 0.0)
    Bh = block * inv[None, :]
    active = (norms > 0).to(dt) * mask
    G = Bh.T @ Bh + torch.diag(1.0 - active)
    s, U = torch.linalg.eigh(G)
    if rank_rtol is None:
        rank_rtol = width * torch.finfo(dt).eps
    keep = s > rank_rtol * s[-1]
    factor = torch.where(keep, torch.rsqrt(torch.clamp(
        s, min=torch.finfo(dt).tiny)), 0.0).to(dt)
    Q = Bh @ (U * factor[None, :])
    # Refinement pass (the CholQR2 second sweep) on the surviving columns.
    alive = (torch.sum(Q * Q, dim=0) > 0.5).to(dt)
    Q, _ = cholqr_once(Q * alive[None, :], unit_diag=alive)
    Q = Q * alive[None, :]
    order = torch.argsort((alive < 0.5).to(torch.int8), stable=True)
    if return_alive:
        return Q[:, order], alive[order]
    return Q[:, order]


def thin_qr_collapse(X, method: str = "cholqr2"):
    """Thin QR of the collapsed Ritz block, returned as (Q, R) so the
    cached A@V / B@V follow by a triangular solve with no operator
    application (see ``fortran_davidson_tpu.core.orthogonal``)."""
    if method == "qr":
        return torch.linalg.qr(X)
    return cholqr2(X)


def right_tri_solve(Y, R):
    """Y @ R^{-1} for upper-triangular R (an explicit small inverse + GEMM,
    so the tall block is never transposed)."""
    Rinv = torch.linalg.solve_triangular(R, _eye(R.shape[0], R), upper=True)
    return Y @ Rinv
