"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

Inputs are built once (numpy-seeded, or by the JAX package's generators)
and handed to both packages as numpy arrays. The matching criteria are
ROADMAP's: eigenvalues within a stated tolerance, iteration counts within
±1 (or exactly where the regression pins them), the same ``converged``
flag, and the port's true residuals at or below the solve tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch import convert

# The suite runs in several xdist workers; keep each one's threads few.
torch.set_num_threads(2)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def true_residuals(A: np.ndarray, X, lam, B: np.ndarray = None) -> np.ndarray:
    """Column norms of A X - B X diag(lam), in numpy float64."""
    X = to_numpy(X).astype(np.float64)
    lam = to_numpy(lam).astype(np.float64)
    BX = X if B is None else B @ X
    return np.linalg.norm(A @ X - BX * lam[None, :], axis=0)


def solve_both(A, k, B=None, **opts):
    """Run the same problem through both packages.

    ``A``/``B``: numpy arrays (dense) or JAX operators with a torch
    counterpart in :mod:`fortran_davidson_tpu_torch.convert`.
    """
    res_jax = fdt.eigensolve(A, k, second_matrix=B, **opts)
    res_jax.block_until_ready()
    At = convert.dense(A) if isinstance(A, np.ndarray) else convert.operator(A)
    Bt = None if B is None else convert.dense(B)
    x0 = opts.pop("initial_vectors", None)
    res_torch = fdtt.eigensolve(At, k, second_matrix=Bt,
                                initial_vectors=None if x0 is None
                                else torch.from_numpy(np.array(x0)), **opts)
    return res_jax, res_torch


def assert_parity(res_jax, res_torch, A: np.ndarray, tol: float,
                  B: np.ndarray = None, exact_iterations: bool = False,
                  eig_atol: float = 1e-10):
    """The ROADMAP's matching criteria for one solve."""
    it_j, it_t = int(res_jax.iterations), int(res_torch.iterations)
    if exact_iterations:
        assert it_t == it_j, f"iterations {it_t} vs JAX {it_j}"
    else:
        assert abs(it_t - it_j) <= 1, f"iterations {it_t} vs JAX {it_j}"
    assert bool(res_torch.converged) == bool(res_jax.converged)
    np.testing.assert_allclose(to_numpy(res_torch.eigenvalues),
                               to_numpy(res_jax.eigenvalues), rtol=0,
                               atol=eig_atol)
    if res_torch.converged:
        res = true_residuals(A, res_torch.eigenvectors,
                             res_torch.eigenvalues, B)
        assert np.all(res <= tol), f"true residuals {res} above {tol}"
