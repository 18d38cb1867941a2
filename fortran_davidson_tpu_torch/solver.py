"""Public solver API (counterpart of ``fortran_davidson_tpu/solver.py``).

One function takes any ``LinearOperator`` of
:mod:`fortran_davidson_tpu_torch.ops.operators` (dense tensors, numpy
arrays and 1-D diagonals are coerced) and runs the solve on the
operator's device.
"""

from __future__ import annotations

import warnings
from typing import Optional

from fortran_davidson_tpu_torch.config import (DavidsonOptions, DavidsonResult,
                                               merge_options, resolve_options,
                                               validate_initial_vectors)
from fortran_davidson_tpu_torch.core.loop import _engine
from fortran_davidson_tpu_torch.ops.operators import as_operator
from fortran_davidson_tpu_torch.utils.dtypes import canonical_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


def eigensolve(matrix, lowest: int, second_matrix=None,
               options: Optional[DavidsonOptions] = None,
               initial_vectors=None,
               **overrides) -> DavidsonResult:
    """Compute the lowest-k eigenpairs of a (generalized) symmetric problem.

    Args:
      matrix: operator A — a LinearOperator, a dense (n, n) tensor or
        array, or a 1-D diagonal.
      lowest: number of lowest eigenpairs to compute.
      second_matrix: optional operator B for the pencil ``A x = lambda B x``
        (same accepted types, same device as A). ``None`` selects the
        standard problem.
      options: DavidsonOptions; keyword overrides are applied on top, e.g.
        ``eigensolve(A, 3, tolerance=1e-6)``.
      initial_vectors: optional (n, j) warm-start block, ``j <= init_dim``.

    Returns:
      DavidsonResult, with tensors on A's device.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)
    A = as_operator(matrix, dtype=dt)
    B = (None if second_matrix is None
         else as_operator(second_matrix, dtype=dt, device=A.device))
    require(A.shape[0] == A.shape[1], OperatorError, "A must be square")
    if B is not None:
        require(B.shape == A.shape, OperatorError,
                f"B shape {B.shape} does not match A shape {A.shape}")
        require(B.device == A.device, OperatorError,
                f"B lives on {B.device}, A on {A.device}")
    cfg = resolve_options(opts, lowest, A.shape[0], generalized=B is not None,
                          device=A.device)
    X0 = validate_initial_vectors(initial_vectors, A.shape[0], cfg.init_dim,
                                  dt, device=A.device)
    return _engine(cfg, A, B, X0=X0)


def generalized_eigensolver(matrix, lowest: int, method: str = "DPR",
                            max_iterations: int = 1000,
                            tolerance: float = 1e-8,
                            max_dim_sub: Optional[int] = None,
                            second_matrix=None,
                            **overrides) -> DavidsonResult:
    """Reference-flavored entry point (argument names follow
    ``src/davidson.f90:51-52``); warns like the reference
    (``src/davidson.f90:232-235``) when the solve does not converge."""
    res = eigensolve(matrix, lowest, second_matrix=second_matrix,
                     method=method, max_iterations=max_iterations,
                     tolerance=tolerance, max_dim_sub=max_dim_sub,
                     **overrides)
    if not res.converged:
        hint = ""
        if res.eigenvalues.dtype.itemsize == 4 and tolerance < 1e-5:
            hint = (" — float32 residuals floor at ~sqrt(n)*eps*||A||; "
                    "use relative_tolerance=True or float64")
        warnings.warn("Davidson algorithm did not converge "
                      f"within {max_iterations} iterations "
                      f"(residuals: {res.residual_norms}){hint}",
                      RuntimeWarning, stacklevel=2)
    return res
