"""Batched matrix-free MINRES, the inner solver of GJD (counterpart of
``fortran_davidson_tpu/core/krylov.py``).

The correction equations of all Ritz pairs are solved together by a
column-batched MINRES (Paige & Saunders 1975): one Lanczos/MINRES state
per column, every recurrence vectorized over columns, one block operator
application per step. MINRES handles the symmetric-indefinite shifted
operators (A - λB is indefinite for interior λ) that CG cannot.

The JAX package runs the steps in a ``lax.while_loop`` on the device.
Here the loop is on the host, and it asks the device whether any column
is still active only every ``_POLL`` steps: a frozen column never
changes, so the steps past the last active one leave every column as it
was and the result is the same as testing at every step, with a
``_POLL``-th of the host reads (counted in ``minres_block.polls``).
Each column counts its own active steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows

# Steps between the host reads of "is any column still active".
_POLL = 4


def _safe_div(num, den):
    ok = torch.abs(den) > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _stall_params(dt):
    """The no-progress cutoff, gated by dtype: a column freezes unless its
    residual improves by the fraction within the window of consecutive
    steps. float64: (8, 0.001), a true no-progress detector only; float32:
    (16, 0.25), ~1.8%/step sustained, below which a column at the float32
    attainable floor grinds the iteration cap for nothing (the JAX
    package's measurement at 10M rows)."""
    if torch.finfo(dt).bits >= 64:
        return 8, 0.001
    return 16, 0.25


def minres_block(matvec: Callable, B, *, maxiter: int, rtol,
                 col_active=None, return_iters: bool = False, atol=None,
                 rows: Rows = LOCAL):
    """Solve op(x_j) = b_j for every column j of B with batched MINRES.

    Args:
      matvec: block operator, (n, m) -> (n, m); column j is acted on by
        the j-th (symmetric) operator of the batch.
      B: (n, m) right-hand sides.
      maxiter: cap on MINRES steps.
      rtol: relative residual tolerance (vs ||b_j||), scalar or (m,).
      col_active: optional (m,) mask; inactive columns return 0.
      return_iters: also return the (m,) int64 count of steps each column
        ran (the batch ran their maximum, one block apply each).
      atol: optional absolute tolerance (scalar or (m,)); stopping uses
        ``max(rtol * ||b_j||, atol_j)``.
      rows: the row-reduction hook of a sharded solve.

    Returns:
      X: (n, m) solutions (zero for inactive/zero columns); with
      ``return_iters``, ``(X, iters)``.
    """
    n, m = B.shape
    dt = B.dtype
    dev = B.device
    stall_window, stall_improvement = _stall_params(dt)
    zeros_m = torch.zeros((m,), dtype=dt, device=dev)

    beta1 = rows.norms(B)
    active = beta1 > 0
    if col_active is not None:
        active = active & (torch.as_tensor(col_active, device=dev) > 0)
    tol_abs = torch.as_tensor(rtol, dtype=dt, device=dev) * beta1
    if atol is not None:
        tol_abs = torch.maximum(tol_abs, torch.broadcast_to(
            torch.as_tensor(atol, dtype=dt, device=dev), (m,)))
    active = active & (beta1 > tol_abs)

    x = torch.zeros_like(B)
    r1, r2, y = B, B, B
    w = torch.zeros_like(B)
    w2 = torch.zeros_like(B)
    oldb, beta, dbar, epsln = zeros_m, beta1, zeros_m, zeros_m
    phibar = beta1
    cs = -torch.ones((m,), dtype=dt, device=dev)
    sn = zeros_m
    best = beta1
    no_prog = torch.zeros((m,), dtype=torch.int64, device=dev)
    iters = torch.zeros((m,), dtype=torch.int64, device=dev)
    tiny = torch.finfo(dt).tiny

    for it in range(maxiter):
        if it % _POLL == 0:
            minres_block.polls += 1
            if not bool(torch.any(active)):
                break
        act = active
        actf = act.to(dt)[None, :]

        s = _safe_div(torch.ones_like(beta), beta)
        v = y * s[None, :]
        y_new = matvec(v * actf) * actf
        if it >= 1:
            y_new = y_new - r1 * _safe_div(beta, oldb)[None, :]
        alfa = rows.sum(torch.sum(v * y_new, dim=0))
        y_new = y_new - r2 * _safe_div(alfa, beta)[None, :]
        r1_new, r2_new = r2, y_new
        oldb_new = beta
        beta_new = rows.norms(y_new)

        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_new = sn * beta_new
        dbar_new = -cs * beta_new

        gamma = torch.sqrt(gbar ** 2 + beta_new ** 2)
        gamma = torch.clamp(gamma, min=tiny)
        cs_new = gbar / gamma
        sn_new = beta_new / gamma
        phi = cs_new * phibar
        phibar_new = sn_new * phibar

        w_new = (v - w2 * oldeps[None, :] - w * delta[None, :]) \
            / gamma[None, :]
        x_new = x + w_new * (phi * act.to(dt))[None, :]

        # Freeze columns that converged, broke down (beta == 0: the
        # Krylov space is exhausted), or stopped progressing. ``best`` is
        # an anchor, moved only when the cumulative improvement since the
        # last anchor clears the bar.
        improved = phibar_new < best * (1.0 - stall_improvement)
        no_prog_new = torch.where(improved, torch.zeros_like(no_prog),
                                  no_prog + 1)
        best_new = torch.where(improved, phibar_new, best)
        still = (act & (phibar_new > tol_abs) & (beta_new > 0)
                 & (no_prog_new < stall_window))

        # Frozen columns keep their state bit for bit.
        def keep(new, old):
            return torch.where(act if new.ndim == 1 else act[None, :],
                               new, old)

        x = keep(x_new, x)
        w2, w = keep(w, w2), keep(w_new, w)
        r1, r2, y = keep(r1_new, r1), keep(r2_new, r2), keep(y_new, y)
        oldb, beta = keep(oldb_new, oldb), keep(beta_new, beta)
        dbar, epsln = keep(dbar_new, dbar), keep(epsln_new, epsln)
        phibar = keep(phibar_new, phibar)
        cs, sn = keep(cs_new, cs), keep(sn_new, sn)
        best, no_prog = keep(best_new, best), keep(no_prog_new, no_prog)
        iters = iters + act.to(torch.int64)
        active = still

    if return_iters:
        return x, iters
    return x


# Host reads made by minres_block so far, counted as the kernel wrappers
# count their launches (``ops/kernels.py``); readers take differences.
minres_block.polls = 0
