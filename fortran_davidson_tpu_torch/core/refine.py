"""Refined (double-single) residuals, Rayleigh quotients, Ritz vectors and
the eigenpair polish (counterpart of ``fortran_davidson_tpu/core/refine.py``).

A float32 solve floors at ~sqrt(n)*eps residuals at the 1M-10M-row
scale. Double-single arithmetic (:mod:`fortran_davidson_tpu_torch.utils.ds`)
restores float64-grade measurement and attainment where float32
cancellation loses it:

- the residual ``r = (A - λB)x`` of a diagonal-dominant operator,
  evaluated as ``A_off x - λ B_off x + ds((d_A - λ d_B) ∘ x)`` with the
  diagonal part exact and the cancelling adds exact (``A_off =
  A.offdiag()``);
- the Rayleigh quotient ``xᵀAx / xᵀBx`` by compensated column dots;
- the k wanted eigenvectors of the projected problem, refined first-order
  against its DS residual (the float32 eigh floors at ~eps*||H||);
- a polish of the k returned pairs with the vectors held as hi/lo pairs,
  below what any float32-stored vector can reach.

:func:`refined_pairs` and :func:`polish` pin TF32 off themselves
(``utils.dtypes.full_precision_matmuls``): they can be called outside
the solver's loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
from fortran_davidson_tpu_torch.utils import ds as dsm
from fortran_davidson_tpu_torch.utils.ds import DS
from fortran_davidson_tpu_torch.utils.dtypes import full_precision_matmuls


def pencil_shifted_diag_apply(diag_a, diag_b, lam_hi, lam_lo, X) -> DS:
    """``(diag_a - λ ∘ diag_b)[:, None] * X`` in double-single.

    ``diag_b=None`` is the standard problem (B = I). λ is a DS scalar per
    column: (k,) hi/lo. X: (n, k).
    """
    if diag_b is None:
        lam_prod_hi = torch.broadcast_to(lam_hi[None, :],
                                         (diag_a.shape[0], lam_hi.shape[0]))
        lam_prod_lo = torch.broadcast_to(lam_lo[None, :], lam_prod_hi.shape)
    else:
        p, e = dsm.two_prod(lam_hi[None, :], diag_b[:, None])
        lam_prod_hi = p
        lam_prod_lo = e + lam_lo[None, :] * diag_b[:, None]
    s, e = dsm.two_sum(diag_a[:, None], -lam_prod_hi)
    shift_hi, shift_lo = dsm.fast_two_sum(s, e - lam_prod_lo)
    p, e = dsm.two_prod(shift_hi, X)
    return DS(*dsm.fast_two_sum(p, e + shift_lo * X))


def _diag_quad_form(d, X, Y=None, extra_lo=None, rows: Rows = LOCAL) -> DS:
    """Fully compensated Σ_i d_i X_i Y_i per column (Y defaults to X)."""
    return dsm.weighted_dot_cols_ds(d, X, Y, extra_lo=extra_lo, rows=rows)


def _assemble_residual(AoffX, shift: DS, lam: DS, BoffX=None) -> DS:
    """R = A_off x + (d_A - λ d_B)∘x [- λ B_off x] with exact adds: the
    large terms cancel to ~the true residual near convergence."""
    s, e = dsm.two_sum(AoffX, shift.hi)
    lo = e + shift.lo
    if BoffX is not None:
        p, ep = dsm.two_prod(lam.hi, BoffX)
        s2, e2 = dsm.two_sum(s, -p)
        s, lo = s2, lo + e2 - ep - lam.lo * BoffX
    return DS(*dsm.fast_two_sum(s, lo))


def _ds_col_norms(R: DS, rows: Rows = LOCAL):
    """Column norms of a DS residual: ||hi||² + 2<hi, lo> compensated."""
    sq = dsm.col_sumsq_pair_ds(R.hi, R.lo, rows=rows)
    pos = sq.hi > 0
    return dsm.ds_sqrt(DS(torch.clamp(sq.hi, min=0.0),
                          torch.where(pos, sq.lo,
                                      torch.zeros_like(sq.lo)))).to_float()


def _ds_matmul_cols(M_ds: DS, Wk) -> DS:
    """``M @ Wk`` with M an (m, m) DS matrix, exact to ~eps² (O(m²k))."""
    p, e = dsm.two_prod(M_ds.hi[:, :, None], Wk[None, :, :])  # (m, m, k)
    my = dsm.ds_sum_tree(p.transpose(0, 1), axis=0, lo=e.transpose(0, 1))
    return dsm.ds_add(my, dsm.ds(M_ds.lo @ Wk))


def _first_order_update(W, w, r_f, k: int):
    """Eigenbasis perturbation ``y_j ← y_j + Σ_{i≠j} cᵢⱼ/(θ_j−θ_i) yᵢ``
    from the projected residual coefficients ``c = Wᵀ r`` (shared by the
    standard and pencil refinements; W is S-orthonormal for a pencil)."""
    m = W.shape[0]
    c = W.T @ r_f                                   # (m, k)
    denom = w[:k][None, :] - w[:, None]             # θ_j - θ_i
    gap_floor = 16.0 * torch.finfo(r_f.dtype).eps * (
        torch.abs(w[:k])[None, :] + 1.0)
    safe = torch.where(torch.abs(denom) < gap_floor,
                       torch.full_like(denom, float("inf")), denom)
    coef = c / safe
    eye_k = (torch.arange(m, device=W.device)[:, None]
             == torch.arange(k, device=W.device)[None, :])
    coef = torch.where(eye_k, torch.zeros_like(coef), coef)
    return W[:, :k] + W @ coef


def refine_ritz(H_ds: DS, w, W, k: int):
    """First-order refinement of the k wanted eigenvectors of the
    projected matrix against its DS residual ``H y_j - θ_j y_j``."""
    Wk = W[:, :k]
    hy = _ds_matmul_cols(H_ds, Wk)
    tp, te = dsm.two_prod(Wk, w[None, :k])
    r = dsm.ds_sub(hy, DS(tp, te))
    return _first_order_update(W, w, r.hi + r.lo, k)


def refine_ritz_pencil(H_ds: DS, S_ds: DS, w, W, k: int):
    """First-order refinement of the k wanted eigenvectors of the
    projected pencil ``H y = θ S y`` against its DS residual
    ``H y_j − θ_j S y_j`` (W S-orthonormal, DSYGV semantics)."""
    Wk = W[:, :k]
    hy = _ds_matmul_cols(H_ds, Wk)
    sy = _ds_matmul_cols(S_ds, Wk)
    tp, te = dsm.two_prod(sy.hi, w[None, :k])
    tsy = DS(tp, te + sy.lo * w[None, :k])
    r = dsm.ds_sub(hy, tsy)
    return _first_order_update(W, w, r.hi + r.lo, k)


class RefinedPairs(NamedTuple):
    evals: torch.Tensor       # (k,) refined Rayleigh quotients
    errors: torch.Tensor      # (k,) true residual 2-norms
    residual: torch.Tensor    # (n, k) high-precision residual block


@full_precision_matmuls()
def refined_pairs(A_off, diag_a, X, B_off=None, diag_b=None,
                  rows: Rows = LOCAL) -> RefinedPairs:
    """Refined eigenvalues and true residuals for the column block ``X``:
    one off-diagonal apply per operator, the rest compensated elementwise
    and reduction work. ``X`` need not be normalized; in a row-sharded
    solve it holds the rank's rows, and ``rows`` sums over the ranks."""
    gen = diag_b is not None
    AoffX = A_off.matmat(X).to(X.dtype)
    BoffX = (B_off.matmat(X).to(X.dtype) if (gen and B_off is not None)
             else None)
    num = dsm.ds_add(dsm.dot_cols_ds(X, AoffX, rows),
                     _diag_quad_form(diag_a, X, rows=rows))
    if gen:
        den = (dsm.dot_cols_ds(X, BoffX, rows) if BoffX is not None
               else dsm.ds(torch.zeros(X.shape[1], dtype=X.dtype,
                                       device=X.device)))
        den = dsm.ds_add(den, _diag_quad_form(diag_b, X, rows=rows))
    else:
        den = dsm.dot_cols_ds(X, X, rows)
    # A nonexistent (all-zero) pair has xᵀBx == 0: floor the denominator
    # to 1 so λ, the residual and the error come out 0, not NaN.
    dead = den.hi == 0
    den = DS(torch.where(dead, torch.ones_like(den.hi), den.hi),
             torch.where(dead, torch.zeros_like(den.lo), den.lo))
    lam = dsm.ds_div(num, den)
    shift = pencil_shifted_diag_apply(diag_a, diag_b, lam.hi, lam.lo, X)
    lam_b = DS(torch.broadcast_to(lam.hi[None, :], X.shape),
               torch.broadcast_to(lam.lo[None, :], X.shape))
    R = _assemble_residual(AoffX, shift, lam_b, BoffX)
    return RefinedPairs(evals=lam.to_float(), errors=_ds_col_norms(R, rows),
                        residual=R.hi + R.lo)


class PolishResult(NamedTuple):
    evals: torch.Tensor       # (k,) hi words of the refined eigenvalues
    evecs_hi: torch.Tensor    # (n, k)
    evecs_lo: torch.Tensor    # (n, k) double-single low words
    errors: torch.Tensor      # (k,) final true residual norms
    # Low words of the eigenvalues: ``float64(evals) + float64(evals_lo)``
    # is the value the residual check used (float32 ``evals`` alone
    # carries ~6e-8·λ of representation rounding).
    evals_lo: Optional[torch.Tensor] = None  # (k,)


@full_precision_matmuls()
def polish(A_off, diag_a, evals, evecs, iterations: int = 3,
           B_off=None, diag_b=None, update: str = "dpr",
           rows: Rows = LOCAL) -> PolishResult:
    """Jacobi (DPR-style) eigenpair refinement with double-single vectors.

    Each iteration applies ``A_off`` to the hi and lo words (through the
    operator's ``matmat_ds`` where it has one), measures the Rayleigh
    quotient and the true residual in DS, and updates ``x ← x + δ`` with
    ``δ = r / (λ d_B - d_A)`` floored at 1e-3·max(|λ|, 1)
    (``update="dpr"``), or with the Olsen-projected ``δ = M⁻¹r − μ M⁻¹x``
    on near-exact denominators (``update="olsen"``, which keeps updating
    the coordinates with λ ≈ d that the floored step freezes), then
    renormalizes in DS. In a row-sharded solve ``evecs`` holds the
    rank's rows, and ``rows`` sums over the ranks.
    """
    if update not in ("dpr", "olsen"):
        raise ValueError(
            f"polish update must be 'dpr' or 'olsen', got {update!r}")
    gen = diag_b is not None
    x_hi = evecs
    x_lo = torch.zeros_like(evecs)
    lam = evals
    lam_ds = dsm.ds(evals)
    errors = None

    for _ in range(iterations):
        Yds = A_off.matmat_ds(x_hi, x_lo)
        if Yds is not None:
            AoffX, Aoff_lo = Yds
        else:
            AoffX = (A_off.matmat(x_hi).to(x_hi.dtype)
                     + A_off.matmat(x_lo).to(x_hi.dtype))
            Aoff_lo = None
        BoffX = ((B_off.matmat(x_hi) + B_off.matmat(x_lo)).to(x_hi.dtype)
                 if (gen and B_off is not None) else None)

        num = dsm.ds_add(
            dsm.dot_cols_ds(x_hi, AoffX, rows),
            _diag_quad_form(diag_a, x_hi,
                            extra_lo=2.0 * (diag_a[:, None] * x_lo) * x_hi,
                            rows=rows))
        if Aoff_lo is not None:
            num = dsm.ds_add(num, dsm.ds(rows.sum(torch.sum(x_hi * Aoff_lo,
                                                            dim=0))))
        if gen:
            den = dsm.ds_add(
                dsm.dot_cols_ds(x_hi, BoffX, rows) if BoffX is not None
                else dsm.ds(torch.zeros_like(lam)),
                _diag_quad_form(diag_b, x_hi,
                                extra_lo=2.0 * (diag_b[:, None] * x_lo)
                                * x_hi, rows=rows))
        else:
            den = dsm.col_sumsq_pair_ds(x_hi, x_lo, rows)
        lam_ds = dsm.ds_div(num, den)
        lam = lam_ds.to_float()

        shift = pencil_shifted_diag_apply(diag_a, diag_b, lam_ds.hi,
                                          lam_ds.lo, x_hi)
        if gen:
            shift_lo_term = (diag_a[:, None]
                             - lam_ds.hi[None, :] * diag_b[:, None]) * x_lo
        else:
            shift_lo_term = (diag_a[:, None] - lam_ds.hi[None, :]) * x_lo
        if Aoff_lo is not None:
            shift_lo_term = shift_lo_term + Aoff_lo
        lam_b = DS(torch.broadcast_to(lam_ds.hi[None, :], x_hi.shape),
                   torch.broadcast_to(lam_ds.lo[None, :], x_hi.shape))
        R_ds = _assemble_residual(
            AoffX, DS(shift.hi, shift.lo + shift_lo_term), lam_b, BoffX)
        errors = _ds_col_norms(R_ds, rows)
        R = R_ds.hi + R_ds.lo

        if gen:
            denom = lam[None, :] * diag_b[:, None] - diag_a[:, None]
        else:
            denom = lam[None, :] - diag_a[:, None]
        floor = 1e-3 * torch.clamp(torch.abs(lam), min=1.0)[None, :]
        den_fl = torch.where(torch.abs(denom) < floor,
                             torch.sign(denom) * floor
                             + (denom == 0).to(denom.dtype) * floor,
                             denom)
        delta = R / den_fl
        if update == "olsen":
            tiny = 1e-30 + 1e-12 * torch.clamp(torch.abs(lam),
                                               min=1.0)[None, :]
            sgn = torch.where(denom < 0, -1.0, 1.0).to(denom.dtype)
            den_raw = torch.where(torch.abs(denom) < tiny, sgn * tiny, denom)
            Mr = R / den_raw
            Mx = x_hi / den_raw
            mu_den, mag, mu_num = rows.sum(torch.stack([
                torch.sum(x_hi * Mx, dim=0),
                torch.sum(torch.abs(x_hi * Mx), dim=0),
                torch.sum(x_hi * Mr, dim=0)]))
            # Where μ's denominator sinks to its summation noise, μ is
            # garbage: those columns take the floored-DPR step.
            noise = 16.0 * torch.finfo(R.dtype).eps * mag + 1e-30
            ill = torch.abs(mu_den) < noise
            mu_den = torch.where(ill, torch.where(mu_den < 0, -noise, noise),
                                 mu_den)
            mu = mu_num / mu_den
            delta = torch.where(ill[None, :], delta, Mr - mu[None, :] * Mx)
        s, e2 = dsm.two_sum(x_hi, delta)
        x_hi, x_lo = dsm.fast_two_sum(s, e2 + x_lo)

        nrm = dsm.ds_sqrt(dsm.col_sumsq_pair_ds(x_hi, x_lo, rows))
        inv = dsm.ds_div(dsm.ds(torch.ones_like(lam)), nrm)
        p2, e3 = dsm.two_prod(x_hi, inv.hi[None, :])
        x_hi, x_lo = dsm.fast_two_sum(
            p2, e3 + x_hi * inv.lo[None, :] + x_lo * inv.hi[None, :])

    ehi, elo = dsm.fast_two_sum(lam_ds.hi, lam_ds.lo)
    return PolishResult(evals=ehi, evecs_hi=x_hi, evecs_lo=x_lo,
                        errors=errors, evals_lo=elo)
