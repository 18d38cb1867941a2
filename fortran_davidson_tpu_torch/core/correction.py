"""Correction-vector schemes: DPR, Olsen and GJD (counterpart of
``fortran_davidson_tpu/core/correction.py``).

DPR: ``corr[i, j] = r[i, j] / (lambda_j * B_ii - A_ii)`` with near-zero
denominators clamped (``src/davidson.f90:688-696``). Olsen adds the skew
projection that keeps the correction orthogonal to the Ritz vector. GJD
solves, for every active Ritz pair, ``(I - x xᵀ)(A - λB)(I - x xᵀ) t = -r``
matrix-free with the column-batched MINRES of ``core/krylov.py``, never
building the n x n system the reference factorizes per pair
(``src/davidson.f90:719-732``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fortran_davidson_tpu_torch.core.krylov import minres_block
from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
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


def olsen_correction(R, lam, X, diag_a, diag_b, mask, rows: Rows = LOCAL):
    """Olsen correction: ``t = K⁻¹r - μ K⁻¹x`` with
    ``μ = xᵀK⁻¹r / xᵀK⁻¹x``, so that ``xᵀt = 0`` (K = diag(λB - A))."""
    den = safe_denominator(lam[None, :] * diag_b[:, None] - diag_a[:, None])
    kinv_r = R / den
    kinv_x = X / den
    num, dnm = rows.sum(torch.stack([torch.sum(X * kinv_r, dim=0),
                                     torch.sum(X * kinv_x, dim=0)]))
    mu = torch.where(torch.abs(dnm) > 0,
                     num / torch.where(dnm != 0, dnm, 1.0), 0.0)
    return (kinv_r - kinv_x * mu[None, :]) * mask[None, :]


def _pseudo_projector(X, rows: Rows = LOCAL):
    """T -> (I - x_j x_jᵀ) t_j, column by column, as a block op."""
    def apply(T):
        return T - X * rows.sum(torch.sum(X * T, dim=0))[None, :]
    return apply


def gjd_correction(apply_a: Callable, apply_b: Optional[Callable], lam, X, R,
                   mask, inner_iters: int, inner_tol,
                   diag_a=None, diag_b=None, olsen_start: bool = False,
                   scale: bool = True, return_inner_iters: bool = False,
                   warm_t=None, rows: Rows = LOCAL):
    """GJD correction by batched matrix-free MINRES.

    With the operator diagonals supplied (and ``scale``), each pair's
    equation is scaled symmetrically by the DPR diagonal
    ``D_j = |λ_j B_ii - A_ii|`` (floored at 1% of its column mean):
    solve ``D^-1/2 P (A - λB) P D^-1/2 y = -D^-1/2 r``, ``t = D^-1/2 y``.
    ``olsen_start`` starts the inner solve from the Olsen correction and
    stops it at the original system's absolute target; ``warm_t`` (the
    previous outer iteration's raw correction, ``gjd_warm_start``) takes
    precedence where it is nonzero. Both starts pass an overshoot guard
    that scales a start whose ``op(t0)`` dwarfs the rhs back toward a
    cold start.

    Args:
      apply_a / apply_b: block applies (apply_b None => B = I).
      lam: (b,) Ritz values; X, R: (n, b) Ritz vectors and residuals.
      mask: (b,) active-column mask.
      inner_iters: cap on MINRES steps.
      inner_tol: relative inner tolerance, scalar or (b,).
      diag_a / diag_b: diagonals for the DPR scaling or the Olsen start.
      rows: the row-reduction hook of a sharded solve.

    The caller holds the precision context (TF32 off), as the solver's
    loop does. Returns ``t``, or ``(t, iters)`` with ``iters`` the (b,)
    steps each column ran.
    """
    proj = _pseudo_projector(X, rows)

    def shifted(T):
        AT = apply_a(T)
        BT = T if apply_b is None else apply_b(T)
        return AT - BT * lam[None, :]

    def op(T):
        return proj(shifted(proj(T)))

    rhs = -(R * mask[None, :])
    t0 = None
    rhs_orig = rhs
    if olsen_start and diag_a is not None:
        db0 = torch.ones_like(diag_a) if diag_b is None else diag_b
        t0 = proj(olsen_correction(R, lam, X, diag_a, db0, mask, rows))
    if warm_t is not None:
        # The previous raw correction, re-projected against the current
        # Ritz vectors; columns with no history keep the Olsen or cold
        # start.
        tw = proj(warm_t * mask[None, :])
        if t0 is None:
            t0 = tw
        else:
            t0 = torch.where((rows.norms(tw) > 0)[None, :], tw, t0)
    if t0 is not None:
        # Overshoot guard: columns whose op(t0) exceeds twice the rhs are
        # scaled back toward a cold start.
        opt0 = op(t0)
        nr = rows.norms(rhs)
        no = rows.norms(opt0)
        s = torch.where(no > 2.0 * nr,
                        2.0 * nr / torch.where(no > 0, no,
                                               torch.ones_like(no)),
                        torch.ones_like(no))
        t0 = t0 * s[None, :]
        rhs = rhs - opt0 * s[None, :]

    def finish(t, iters):
        t = (t if t0 is None else t + t0) * mask[None, :]
        return (t, iters) if return_inner_iters else t

    if diag_a is None or not scale:
        # Unscaled MINRES on the exact projected operator; a started
        # solve stops at the original system's absolute target.
        atol = None if t0 is None else inner_tol * rows.norms(rhs_orig)
        t, iters = minres_block(op, rhs, maxiter=inner_iters, rtol=inner_tol,
                                col_active=mask, return_iters=True,
                                atol=atol, rows=rows)
        return finish(t, iters)

    db = torch.ones_like(diag_a) if diag_b is None else diag_b
    den = torch.abs(lam[None, :] * db[:, None] - diag_a[:, None])
    floor = 1e-2 * rows.col_mean(den)[None, :]
    sc = torch.rsqrt(torch.maximum(den, torch.clamp(floor, min=1e-30)))

    def op_scaled(T):
        return sc * op(sc * T)

    atol = None if t0 is None else inner_tol * rows.norms(sc * rhs_orig)
    y, iters = minres_block(op_scaled, sc * rhs, maxiter=inner_iters,
                            rtol=inner_tol, col_active=mask,
                            return_iters=True, atol=atol, rows=rows)
    return finish(sc * y, iters)
