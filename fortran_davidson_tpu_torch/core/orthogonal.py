"""Masked block orthonormalization (counterpart of
``fortran_davidson_tpu/core/orthogonal.py``).

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

``precise=True`` (the refined path) measures every Gram compensated
(``utils.ds.gram_ds``, summed over the ranks of a sharded solve by the
``rows`` hook): a plain float32 Gram at n = 10M mismeasures by
~sqrt(n)*eps, and neither CGS nor CholeskyQR can correct below what the
Gram measures.
"""

from __future__ import annotations

from typing import Optional

import torch

from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
from fortran_davidson_tpu_torch.utils import ds as dsm


def col_mask(m, m_max: int, dtype, device=None):
    """(m_max,) float mask: 1.0 for columns < m (m an int or a 0-d tensor)."""
    if isinstance(m, torch.Tensor):
        device = m.device
    return (torch.arange(m_max, device=device) < m).to(dtype)


def project_out(V, block, rows: Rows = LOCAL, precise: bool = False):
    """Remove the component of ``block`` lying in span(V's nonzero columns).

    ``precise``: compensated coefficients Vᵀblock (the plain float32 dot
    carries ~sqrt(n)*eps relative noise, which caps how small a genuine
    new direction the projection can leave standing).
    """
    if precise:
        g = dsm.gram_ds(V, block, rows=rows)
        return block - V @ (g.hi + g.lo)
    return block - V @ rows.sum(V.T @ block)


def _gram(X, rows: Rows, precise: bool):
    """Gram XᵀX, compensated when ``precise``."""
    if precise:
        g = dsm.gram_ds(X, rows=rows)
        return g.hi + g.lo
    return rows.sum(X.T @ X)


def _eye(m: int, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def eigh(M):
    """``torch.linalg.eigh``, taken in float64 for a float32 matrix on a GPU.

    cuSOLVER's float32 eigh on an H100 loses ~1e-4 of ‖M‖ (400×400,
    spectrum 0-400: eigenvalue error 3.6e-2, against 2.0e-4 from LAPACK
    on the CPU), enough that float32 solves at a 1e-3 relative tolerance
    stall or report pairs that are not converged. The float64 call is no
    slower there: 3.9 ms against 5.6 ms at 400, 17.9 against 16.4 ms at
    1408 (CUDA events, H100 80GB HBM3 at 700 W).
    """
    if M.dtype == torch.float32 and M.is_cuda:
        w, U = torch.linalg.eigh(M.double())
        return w.float(), U.float()
    return torch.linalg.eigh(M)


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
                         rank_width: Optional[int] = None,
                         rows: Rows = LOCAL, precise: bool = False):
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
      rows: the row-reduction hook (``core/rows.py``); in a row-sharded
        solve the ``"qr"`` method is the TSQR of :func:`tsqr`.
      precise: compensated Grams, the survivor floor 256·eps instead of
        sqrt(eps), and SVQB's noise floor: a surviving column carries
        rounding noise at ~eps·sqrt(n) relative, so a Gram eigenvalue
        below ``(10·eps)²·n`` (n the global row count) is junk, not a
        direction.

    Returns:
      ``(q, alive)``: (n, b) block with orthonormal active columns,
      orthogonal to V (dropped columns exactly zero, survivors compacted
      to a prefix), and the (b,) float mask of surviving columns.
    """
    dt = block.dtype
    block = block * mask[None, :]
    norms_before = rows.norms(block)
    for _ in range(n_reorth):
        block = project_out(V, block, rows, precise)
    # Drop columns that lost (nearly) all their mass to the projection:
    # what survives is roundoff of the subtraction, not a new direction.
    # With compensated coefficients the floor is the remaining V @ coeffs
    # product's, ~sqrt(m)*eps: down to 256*eps is signal.
    norms_after = rows.norms(block)
    finfo = torch.finfo(dt)
    drop_tol = 256.0 * finfo.eps if precise else finfo.eps ** 0.5
    alive = (norms_after > drop_tol * torch.clamp(norms_before,
                                                  min=finfo.tiny)) \
        & (mask > 0.5)
    block = block * alive[None, :].to(dt)
    mask = mask * alive.to(dt)
    rank_rtol = None
    if precise:
        width = block.shape[1] if rank_width is None else rank_width
        rank_rtol = max(width * finfo.eps,
                        (10.0 * finfo.eps) ** 2 * rows.size * block.shape[0])
    if method == "qr":
        # Compact survivors to a prefix first: with an interior zero
        # column, Householder QR routes components of later columns onto
        # the arbitrary completion column at the hole.
        order = torch.argsort((~alive).to(torch.int8), stable=True)
        block = block[:, order]
        mask = mask[order]
        q, _ = tsqr(block, rows)
        q = q * mask[None, :]
        # Householder QR completes zero columns with arbitrary directions
        # that may lie in span(V): sweep once more and renormalize.
        q = project_out(V, q, rows)
        norms = rows.norms(q)
        inv = torch.where(norms > 0, 1.0 / torch.where(norms > 0, norms, 1.0),
                          0.0)
        return q * inv[None, :], (norms > 0.5).to(dt)
    return svqb(block, mask, rank_rtol=rank_rtol, return_alive=True,
                rank_width=rank_width, rows=rows, precise=precise)


def tsqr(X, rows: Rows = LOCAL):
    """Householder QR of a tall block whose rows are spread over the ranks
    of ``rows`` (TSQR, Demmel et al. 2012): ``(Q, R)`` with ``Q`` the
    rank's rows of the orthonormal factor and ``R`` the same (w, w)
    triangle on every rank.

    Each rank factors its own (n_local, w) rows, X_r = Q_r R_r; the ranks'
    R_r, stacked in rank order (:meth:`Rows.gather`), are factored again,
    [R_0; R_1; ...] = Q' R, by every rank on the same bits; the rank's Q is
    Q_r times its (w, w) slice of Q'. On one rank the second stage is
    skipped, so the result is ``torch.linalg.qr``'s bits. Column signs
    may differ from a Householder QR of the gathered block (each stage
    picks its own reflector signs); the span, and with it the Ritz
    values, do not.
    """
    Q1, R1 = torch.linalg.qr(X)
    if rows.size == 1:
        rows.skipped("all-gather", R1)
        return Q1, R1
    Q2, R = torch.linalg.qr(rows.gather(R1))
    r = R1.shape[0]
    return Q1 @ Q2[rows.rank * r:(rows.rank + 1) * r], R


def cholqr_once(X, unit_diag=None, jitter: float = 0.0,
                rows: Rows = LOCAL, precise: bool = False):
    """One CholeskyQR pass: X = Q R via R = chol(X^T X)^T, Q = X R^{-1}.

    ``unit_diag``: optional (m,) 0/1 mask; positions with 0 get a unit
    Gram diagonal so exactly-zero (padded) columns pass through as zero
    columns instead of breaking the factorization.
    """
    G = _gram(X, rows, precise)
    if unit_diag is not None:
        G = G + torch.diag(1.0 - unit_diag)
    if jitter:
        G = G + jitter * torch.mean(torch.diagonal(G)) * _eye(G.shape[0], G)
    L = cholesky_nan(G)
    Linv = torch.linalg.solve_triangular(L, _eye(L.shape[0], L), upper=False)
    return X @ Linv.T, L.T


def cholqr2(X, unit_diag=None, jitter: float = 0.0, rows: Rows = LOCAL,
            precise: bool = False):
    """CholeskyQR2 (Yamamoto et al.): two passes give orthogonality at
    working precision for cond(X) up to ~1/sqrt(eps)."""
    Q1, R1 = cholqr_once(X, unit_diag, jitter, rows, precise)
    Q2, R2 = cholqr_once(Q1, unit_diag, jitter, rows, precise)
    return Q2, R2 @ R1


def svqb(block, mask, rank_rtol=None, return_alive: bool = False,
         rank_width: Optional[int] = None, rows: Rows = LOCAL,
         precise: bool = False):
    """SVQB (Stathopoulos & Wu 2002): rank-revealing block
    orthonormalization through the eigendecomposition of the Gram matrix.

    Directions whose Gram eigenvalue falls below ``rank_rtol * s_max``
    are dropped (zero columns) instead of being completed with arbitrary
    vectors. ``mask`` marks the active columns (inactive columns are zero
    and stay zero). Kept columns are compacted into a prefix.
    """
    dt = block.dtype
    width = block.shape[1] if rank_width is None else rank_width
    norms = rows.norms(block)
    inv = torch.where(norms > 0, 1.0 / torch.where(norms > 0, norms, 1.0), 0.0)
    Bh = block * inv[None, :]
    active = (norms > 0).to(dt) * mask
    G = _gram(Bh, rows, precise) + torch.diag(1.0 - active)
    s, U = eigh(G)
    if rank_rtol is None:
        rank_rtol = width * torch.finfo(dt).eps
    keep = s > rank_rtol * s[-1]
    factor = torch.where(keep, torch.rsqrt(torch.clamp(
        s, min=torch.finfo(dt).tiny)), 0.0).to(dt)
    Q = Bh @ (U * factor[None, :])
    # Refinement pass (the CholQR2 second sweep) on the surviving columns.
    alive = (rows.sum(torch.sum(Q * Q, dim=0)) > 0.5).to(dt)
    Q, _ = cholqr_once(Q * alive[None, :], unit_diag=alive, rows=rows,
                       precise=precise)
    Q = Q * alive[None, :]
    order = torch.argsort((alive < 0.5).to(torch.int8), stable=True)
    if return_alive:
        return Q[:, order], alive[order]
    return Q[:, order]


def thin_qr_collapse(X, method: str = "cholqr2", rows: Rows = LOCAL,
                     precise: bool = False):
    """Thin QR of the collapsed Ritz block, returned as (Q, R) so the
    cached A@V / B@V follow by a triangular solve with no operator
    application (see ``fortran_davidson_tpu.core.orthogonal``); in a
    row-sharded solve ``method="qr"`` is the TSQR of :func:`tsqr`."""
    if method == "qr":
        return tsqr(X, rows)
    return cholqr2(X, rows=rows, precise=precise)


def right_tri_solve(Y, R):
    """Y @ R^{-1} for upper-triangular R (an explicit small inverse + GEMM,
    so the tall block is never transposed)."""
    Rinv = torch.linalg.solve_triangular(R, _eye(R.shape[0], R), upper=True)
    return Y @ Rinv
