"""Problem generators (counterpart of
``fortran_davidson_tpu/models/generators.py``).

``generate_diagonal_dominant`` draws from ``jax.random`` and has no
counterpart here: tests build that fixture with the JAX package and hand
it over as numpy. The generators below are numpy-seeded or deterministic,
and build on ``device``, by default the GPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops.operators import MatrixFreeOperator
from fortran_davidson_tpu_torch.utils.dtypes import (canonical_dtype,
                                                     default_device)


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
                              device=device)


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
                              device=device)
