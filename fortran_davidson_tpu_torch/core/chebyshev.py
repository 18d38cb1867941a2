"""Chebyshev-filtered restarts (counterpart of
``fortran_davidson_tpu/core/chebyshev.py``).

At a collapse the reference keeps the first ``init_dim`` Ritz vectors
(``src/davidson.f90:218``). The filtered restart passes that block
through a degree-``d`` scaled Chebyshev polynomial of the operator that
is ~1 on the wanted (lowest) part of the spectrum and small on the
damping interval ``[a, b]`` covering the unwanted part (Saad; ChASE,
arXiv:2205.02491): ``d`` extra block applies per collapse.

The recurrence is plain PyTorch around the operator's ``matmat``, as the
JAX package's is XLA around ``A.matmat``: on a banded BSR matrix every
apply is a launch of kernel 1. The upper end ``b`` comes from
:func:`lanczos_upper_bound`, 12 single-column applies once per solve.

Sharded solves: the bound's dots and norms are sums over the rows
(``core/rows.py``), and every rank takes its rows of one global start
vector (:func:`start_vector`), so every rank computes the same bound and
the same degree and applies the operator the same number of times.
"""

from __future__ import annotations

import math

import torch

from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows


def start_vector(n: int, seed: int = 7) -> torch.Tensor:
    """The Lanczos start vector: ``n`` standard normal float64 values on
    the CPU from a ``torch.Generator`` seeded ``seed``.

    The JAX package draws ``jax.random.normal(PRNGKey(7), (n,))``, whose
    bits PyTorch cannot reproduce; a parity test replaces this function
    with the JAX package's vector. A sharded solve takes its rows of it.
    """
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((n,), generator=gen, dtype=torch.float64)


def lanczos_upper_bound(apply_a, n: int, dtype, iters: int = 12,
                        safety: float = 1.05, device=None,
                        rows: Rows = LOCAL, n_local: int = None):
    """Upper bound of spec(A) from ``iters`` Lanczos steps
    (``fortran_davidson_tpu/core/chebyshev.py:31``).

    Returns ``(λ_max(T_k) + ||r_k||) * safety`` as a 0-d tensor of
    ``dtype`` on ``device``. ``apply_a`` maps an (rows, 1) block of the
    local rows to one of ``dtype``; ``n`` is the global order and
    ``n_local`` the local row count (``n`` on one device).
    """
    n_local = n if n_local is None else n_local
    v = start_vector(n)[rows.offset:rows.offset + n_local]
    v = v.to(device=device, dtype=dtype)
    v = v / rows.norms(v[:, None])[0]
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=device)
    alphas, betas = [], []
    for _ in range(iters):
        w = apply_a(v[:, None])[:, 0] - beta * v_prev
        alpha = rows.sum(torch.dot(w, v))
        w = w - alpha * v
        # The raw recurrence suffices for a bound: loss of orthogonality
        # repeats Ritz values, it does not overshoot.
        beta_new = rows.norms(w[:, None])[0]
        ok = beta_new > 0
        v_new = torch.where(ok, w / torch.where(ok, beta_new, 1.0), v)
        v_prev, v, beta = v, v_new, beta_new
        alphas.append(alpha)
        betas.append(beta_new)
    alphas = torch.stack(alphas)
    betas = torch.stack(betas)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    # A 12 x 12 eigenproblem, taken in float64 (cuSOLVER's float32 eigh
    # is off by ~1e-4 of ||T||, see ``orthogonal.eigh``).
    theta = torch.linalg.eigvalsh(T.double())[-1].to(dtype)
    return (theta + betas[-1]) * safety


def chebyshev_filter(apply_a, X, degree: int, a, b, lower_est):
    """``p(A) @ X`` for the degree-``degree`` scaled Chebyshev polynomial
    damping ``[a, b]`` (``fortran_davidson_tpu/core/chebyshev.py:69``).

    The σ-scaled recurrence (ChASE eq. 2.4-2.6, Saad alg. 4.3) anchored
    at ``lower_est`` keeps the blocks O(1). ``degree`` applies of
    ``apply_a``; zero columns of X stay zero.
    """
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    sigma1 = e / (c - lower_est)
    Y = (apply_a(X) - c * X) * (sigma1 / e)
    sigma = sigma1
    for _ in range(degree - 1):
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        Yn = ((apply_a(Y) - c * Y) * (2.0 * sigma_new / e)
              - (sigma * sigma_new) * X)
        X, Y, sigma = Y, Yn, sigma_new
    return Y


def auto_degree(wanted_lo, a, b, dtype, target: float = 1e3,
                max_degree: int = 12) -> int:
    """The filter degree from this restart's geometry
    (``fortran_davidson_tpu/core/chebyshev.py:109``): the smallest ``d``
    with ``cosh(d * acosh(t)) >= target``, ``t = (c - λ_lo)/e``, clamped
    to [2, max_degree]. Returns a Python ``int`` (one host read)."""
    finfo = torch.finfo(dtype)
    wanted_lo, a, b = (torch.as_tensor(x, dtype=dtype)
                       for x in (wanted_lo, a, b))
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    # Degenerate geometry (a ~ b, or the wanted end inside the interval):
    # t <= 1 + eps, acosh(t) ~ 0, the capped degree.
    t = torch.clamp((c - wanted_lo) / torch.clamp(e, min=finfo.tiny),
                    min=1.0 + finfo.eps)
    d = (torch.arccosh(torch.as_tensor(2.0 * target, dtype=dtype))
         / torch.arccosh(t))
    return int(min(max(math.ceil(float(d)), 2), max_degree))
