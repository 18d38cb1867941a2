"""The matrix-free CI-matrix surrogate of BASELINE config 4, made on the
device, and its plain reference.

The operator is that of ``fortran_davidson_tpu_torch.models.generators``'s
``surrogate_hamiltonian``: A_ii = i + 1 and A_ij = coupling * cos(t_i +
t_j) for i != j, with t_i = 0.37 * 2 pi * i / n. Like the source's, it
takes nothing from a seed: a phase drawn from the seed and added to
every t_i, even one under 0.01 rad, changed the work, 4 to 6 iterations
a solve (PERF.md). Written with c = cos t and s = sin t, A = D +
rho (c cᵀ - s sᵀ), rho the coupling and D the diagonal less the rank-2
part's own, D_i = i + 1 - rho (c_i² - s_i²).

This module imports nothing of the program. Its reference apply and its
eigenvalues work from t, which :func:`phases` makes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Bisection steps of the reference eigenvalues: each halves a bracket of
# a few thousand, so 64 reach the spacing of float64 numbers near 1..20.
BISECTION_STEPS = 64
# Rows of one pass of the reference's sums.
CHUNK = 1 << 22


def phases(params: dict, device) -> torch.Tensor:
    """t_i = 0.37 * 2 pi * i / n, i < n, float64."""
    n = int(params["n"])
    return torch.arange(n, dtype=torch.float64, device=device) * (
        2.0 * math.pi / n * 0.37)


def reference_apply(t: torch.Tensor, coupling: float, x: torch.Tensor,
                    absolute: bool = False) -> torch.Tensor:
    """``A @ x`` from the definition: (i + 1) x_i plus coupling *
    sum_j cos(t_i + t_j) x_j over j != i, the cosine of a sum expanded as
    c_i c_j - s_i s_j, in float64. With ``absolute``, a bound of
    ``|A| @ x`` for x >= 0 (|cos(t_i + t_j)| <= |c_i c_j| + |s_i s_j|,
    the j = i term kept): the scale of an apply's rounding."""
    c, s = torch.cos(t), torch.sin(t)
    if absolute:
        c, s = torch.abs(c), torch.abs(s)
    x = x.to(torch.float64)
    gc, gs = c @ x, s @ x                                   # (m,) each
    d = torch.arange(1, t.shape[0] + 1, dtype=torch.float64,
                     device=t.device)
    if absolute:
        return d[:, None] * x + coupling * (c[:, None] * gc[None, :]
                                            + s[:, None] * gs[None, :])
    self_term = coupling * torch.cos(2.0 * t)               # the j = i term
    return ((d - self_term)[:, None] * x
            + coupling * (c[:, None] * gc[None, :] - s[:, None] * gs[None, :]))


def _counts(t: torch.Tensor, coupling: float, sigma: torch.Tensor):
    """The number of eigenvalues below each ``sigma`` (Sylvester's law of
    inertia through the Haynsworth additivity of the rank-2 update):
    #{D_i < sigma} + neg(S) - 1, where rho·S = diag(-1, 1) - rho Uᵀ (D -
    sigma)⁻¹ U with U = [c, s] is the Schur complement of the bordered
    matrix [[D - sigma, U], [Uᵀ, -W⁻¹]], W = diag(rho, -rho), and -W⁻¹ has
    one negative eigenvalue."""
    rho = coupling
    below = torch.zeros_like(sigma)
    scc = torch.zeros_like(sigma)
    scs = torch.zeros_like(sigma)
    sss = torch.zeros_like(sigma)
    n = t.shape[0]
    for lo in range(0, n, CHUNK):
        tt = t[lo:lo + CHUNK]
        c, s = torch.cos(tt), torch.sin(tt)
        d = (torch.arange(lo + 1, lo + 1 + tt.shape[0], dtype=torch.float64,
                          device=t.device) - rho * torch.cos(2.0 * tt))
        inv = 1.0 / (d[None, :] - sigma[:, None])           # (k, rows)
        below += torch.sum(d[None, :] < sigma[:, None], dim=1)
        scc += inv @ (c * c)
        scs += inv @ (c * s)
        sss += inv @ (s * s)
    a = -1.0 - rho * scc
    b = -rho * scs
    e = 1.0 - rho * sss
    det = a * e - b * b
    neg = torch.where(det < 0, 1.0, torch.where(a < 0, 2.0, 0.0))
    return below + neg - 1.0


def reference_eigenvalues(t: torch.Tensor, coupling: float,
                          k: int) -> np.ndarray:
    """The lowest ``k`` eigenvalues by bisection on the inertia count
    (:func:`_counts`), all ``k`` brackets at once, in float64: no
    eigensolver and no basis. Eigenvalue j lies above min D - rho ‖s‖²
    (the negative rank-one part moves none further) and below the
    (j+1)-th smallest D (interlacing past the positive rank-one part)."""
    rho = coupling
    c, s = torch.cos(t), torch.sin(t)
    d = (torch.arange(1, t.shape[0] + 1, dtype=torch.float64,
                      device=t.device) - rho * torch.cos(2.0 * t))
    smallest = torch.topk(d, min(k + 1, d.shape[0]), largest=False).values
    lo = torch.full((k,), float(smallest[0] - rho * torch.sum(s * s) - 1.0),
                    dtype=torch.float64, device=t.device)
    hi = torch.full((k,), float(smallest[-1]) + 0.5, dtype=torch.float64,
                    device=t.device)
    want = torch.arange(1, k + 1, dtype=torch.float64, device=t.device)
    del c, s
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        enough = _counts(t, rho, mid) >= want
        hi = torch.where(enough, mid, hi)
        lo = torch.where(enough, lo, mid)
    return (0.5 * (lo + hi)).cpu().numpy()


def apply_cost(params: dict, m: int, world: int) -> tuple:
    """``(bytes, flops)`` of one apply to ``m`` columns: x read once, y
    written once, the diagonal and the two factor columns read once; two
    products of rank 2 (Uᵀ x and U h, 2·n·2·m operations each) and one
    multiply-add an entry for the diagonal."""
    n = int(params["n"]) // world
    item = getattr(torch, params["dtype"]).itemsize
    moved = (2 * n * m + 3 * n) * item
    flops = 2 * n * m * (2 * 2 + 1)
    return moved, flops
