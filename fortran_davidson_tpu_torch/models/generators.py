"""Problem generators (counterpart of
``fortran_davidson_tpu/models/generators.py``).

The generators are numpy-seeded or deterministic, and build on
``device``, by default the GPU. ``generate_diagonal_dominant`` has the
JAX package's construction but draws from ``np.random.default_rng(seed)``
(``jax.random`` has no counterpart here), so its values differ from the
JAX package's: parity tests build that fixture with the JAX package and
hand it over as numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops.operators import MatrixFreeOperator
from fortran_davidson_tpu_torch.utils import ds as dsm
from fortran_davidson_tpu_torch.utils.dtypes import (canonical_dtype,
                                                     default_device)


def generate_diagonal_dominant(n: int, sparsity: float, diag_val=None,
                               seed: int = 0, dtype=torch.float64,
                               device=None) -> torch.Tensor:
    """Random dense symmetric diagonal-dominant matrix (test fixture;
    ``src/array_utils.f90:86-113``): a uniform upper triangle scaled by
    ``sparsity``, symmetrized, on a diagonal of ``1..n`` (or ``diag_val``).
    Seeded by numpy, so not the JAX package's values."""
    dt = canonical_dtype(dtype)
    rng = np.random.default_rng(seed)
    arr = np.triu(rng.random((n, n)) * sparsity, 1)
    arr = arr + arr.T
    diag = (np.arange(1, n + 1, dtype=np.float64) if diag_val is None
            else np.full((n,), diag_val, dtype=np.float64))
    return torch.as_tensor(arr + np.diag(diag),
                           device=default_device(device)).to(dt)


def bse_surrogate(n: int = 864, coupling: float = 5e-4, seed: int = 864,
                  dtype=torch.float64, device=None):
    """Deterministic dense BSE-style regression matrix, bit-equal to the
    JAX package's (stands in for the reference's 864x864 fixture,
    ``src/tests/test_reorder.f90:17-26``)."""
    dt = canonical_dtype(dtype)
    rng = np.random.default_rng(seed)
    off = (rng.random((n, n)) - 0.5) * coupling
    off = np.triu(off, 1)
    off = off + off.T
    t = np.arange(n) / max(n - 1, 1)
    diag = 0.3 + 0.45 * t ** 1.2
    return torch.as_tensor(off + np.diag(diag),
                           device=default_device(device)).to(dt)


def _rank2_trig_factors(n: int, dtype, device=None):
    """cos(t_i + t_j) = c_i c_j - s_i s_j with slowly-varying phases."""
    t = (torch.arange(n, dtype=dtype, device=device)
         * (2.0 * math.pi / max(n, 1)) * 0.37)
    return torch.cos(t), torch.sin(t)


def low_rank_plus_diag_apply(X, diag, factors, weights):
    """Apply diag(d) + sum_r w_r u_r u_r^T (diagonal of the low-rank part
    removed, so ``diag`` is the exact operator diagonal)."""
    U = factors  # (n, r)
    low = (U * weights[None, :]) @ (U.T @ X)
    corr = torch.sum((U * U) * weights[None, :], dim=1)
    return diag[:, None] * X + low - corr[:, None] * X


def low_rank_offdiag_apply_ds(x_hi, x_lo, diag, factors, weights):
    """Double-single off-diagonal apply: ``sum_r w_r u_r u_rᵀ`` minus its
    own diagonal, on ``x = x_hi + x_lo``, returned as ``(y_hi, y_lo)``.

    A plain float32 apply floors any residual measured through it at its
    own output rounding, ~eps/2·|w|·‖u‖·|uᵀx| (~1.4e-8 at 10M rows, at the
    1e-8 contract). Here the skinny gram ``Uᵀx`` is a Dot2 pass per factor
    column and every product and add an error-free transform, which
    pushes the floor to ~eps². ``diag`` (the off-diagonal operator's zero
    diagonal) keeps the captured signature of the float32 apply. The
    pass count grows with the rank r (the surrogates' r <= 2).
    """
    U = factors
    g_rows = [dsm.dot_cols_ds(torch.broadcast_to(U[:, r:r + 1], x_hi.shape),
                              x_hi)
              for r in range(U.shape[1])]
    g = dsm.DS(torch.stack([gr.hi for gr in g_rows]),
               torch.stack([gr.lo for gr in g_rows]))
    g = dsm.ds_add(g, dsm.ds(U.T @ x_lo))
    p, e = dsm.two_prod(weights[:, None], g.hi)
    h_hi, h_lo = p, e + weights[:, None] * g.lo

    # y = U @ h as an exact r-term outer-product cascade.
    y_hi = None
    y_lo = torch.zeros_like(x_hi)
    for r in range(U.shape[1]):
        p, e = dsm.two_prod(U[:, r:r + 1], h_hi[r:r + 1, :])
        if y_hi is None:
            y_hi = p
        else:
            y_hi, es = dsm.two_sum(y_hi, p)
            y_lo = y_lo + es
        y_lo = y_lo + e + U[:, r:r + 1] * h_lo[r:r + 1, :]

    # Remove the low-rank part's own diagonal exactly.
    corr = torch.sum((U * U) * weights[None, :], dim=1)
    q, eq = dsm.two_prod(-corr[:, None], x_hi)
    y_hi, es = dsm.two_sum(y_hi, q)
    y_lo = y_lo + eq + es - corr[:, None] * x_lo
    return dsm.fast_two_sum(y_hi, y_lo)


def surrogate_hamiltonian(n: int, coupling: float = 1e-4, dtype=torch.float64,
                          device=None) -> MatrixFreeOperator:
    """Matrix-free CI-matrix surrogate: A_ii = i+1,
    A_ij = coupling * cos(t_i + t_j) for i != j."""
    dt = canonical_dtype(dtype)
    device = default_device(device)
    c, s = _rank2_trig_factors(n, dt, device)
    diag = torch.arange(1, n + 1, dtype=dt, device=device)
    U = torch.stack([c, s], dim=1)
    w = torch.tensor([coupling, -coupling], dtype=dt, device=device)

    def offdiag_apply(X, diag, U, w):
        return low_rank_plus_diag_apply(X, torch.zeros_like(diag), U, w)

    return MatrixFreeOperator(low_rank_plus_diag_apply, n, dtype=dt, diag=diag,
                              captured=(diag, U, w), offdiag_fn=offdiag_apply,
                              device=device,
                              offdiag_ds_fn=low_rank_offdiag_apply_ds)


def surrogate_overlap(n: int, coupling: float = 1e-5, dtype=torch.float64,
                      device=None) -> MatrixFreeOperator:
    """Matrix-free SPD overlap surrogate: B_ii = 1,
    B_ij = coupling * sin(t_i) sin(t_j) for i != j."""
    dt = canonical_dtype(dtype)
    device = default_device(device)
    _, s = _rank2_trig_factors(n, dt, device)
    diag = torch.ones((n,), dtype=dt, device=device)
    U = s[:, None]
    w = torch.tensor([coupling], dtype=dt, device=device)

    def offdiag_apply(X, diag, U, w):
        return low_rank_plus_diag_apply(X, torch.zeros_like(diag), U, w)

    return MatrixFreeOperator(low_rank_plus_diag_apply, n, dtype=dt, diag=diag,
                              captured=(diag, U, w), offdiag_fn=offdiag_apply,
                              device=device,
                              offdiag_ds_fn=low_rank_offdiag_apply_ds)
