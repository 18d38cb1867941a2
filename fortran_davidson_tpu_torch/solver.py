"""Public solver API (counterpart of ``fortran_davidson_tpu/solver.py``).

One function takes any ``LinearOperator`` of
:mod:`fortran_davidson_tpu_torch.ops.operators` (dense tensors, numpy
arrays and 1-D diagonals are coerced) and runs the solve on the
operator's device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import (DavidsonOptions, DavidsonResult,
                                               merge_options, resolve_options,
                                               validate_initial_vectors)
from fortran_davidson_tpu_torch.core.loop import _engine
from fortran_davidson_tpu_torch.core.refine import PolishResult, polish
from fortran_davidson_tpu_torch.core.rows import LOCAL
from fortran_davidson_tpu_torch.ops.operators import as_operator
from fortran_davidson_tpu_torch.utils.dtypes import canonical_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


def prepare(matrix, lowest: int, second_matrix, opts: DavidsonOptions,
            device=None):
    """The operators and the resolved configuration of a single-device
    solve: ``(A, B, cfg)``, on ``device`` for numpy input (tensors keep
    theirs). :func:`eigensolve` and ``eigensolve_checkpointed`` share it,
    so both resolve every option alike."""
    dt = canonical_dtype(opts.dtype)
    A = as_operator(matrix, dtype=dt, device=device)
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
    if (opts.fused_gram in ("auto", "on") and B is None and not cfg.refined
            and cfg.expansion == "lowest-k" and cfg.dtype == "float32"
            and hasattr(A, "matmat_with_gram")
            # "auto" also asks for wide blocks (the JAX package's gate,
            # ``fortran_davidson_tpu/solver.py:69-85``, kept as it is until
            # an H100 A/B decides it anew); "on" forces the engine. The
            # refined path never takes it: its float32 gram is far above
            # the compensated gram's precision.
            and (opts.fused_gram == "on"
                 or (lowest >= 128 and cfg.m_max % 128 == 0))):
        # Incremental-H engine: the expand block's projection columns come
        # from the operator's fused SpMM+Gram. Capability is an operator
        # property, so the flag resolves here, not in resolve_options.
        cfg = dataclasses.replace(cfg, fused_gram=True)
    return A, B, cfg


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
    A, B, cfg = prepare(matrix, lowest, second_matrix, opts)
    X0 = validate_initial_vectors(initial_vectors, A.shape[0], cfg.init_dim,
                                  canonical_dtype(opts.dtype),
                                  device=A.device)
    if cfg.refined:
        # The refined path also takes the off-diagonal splits, for its
        # compensated true residuals (structural for the sparse formats,
        # see ``LinearOperator.offdiag``).
        return _engine(cfg, A, B, X0=X0, A_off=A.offdiag(),
                       B_off=None if B is None else B.offdiag())
    return _engine(cfg, A, B, X0=X0)


def polish_eigenpairs(matrix, result: DavidsonResult, iterations: int = 3,
                      second_matrix=None, dtype=None,
                      update: str = "dpr", mesh=None) -> PolishResult:
    """Double-single post-refinement of a solve's eigenpairs
    (``fortran_davidson_tpu.solver.polish_eigenpairs``): the k returned
    pairs re-iterated with the vectors held as hi/lo pairs and every
    diagonal cancellation exact (:func:`core.refine.polish`, which pins
    TF32 off), on the operator's device.

    ``mesh`` (a ``parallel.RowMesh``): polish row-sharded, every rank of
    the mesh calling it. The operators are sharded by
    ``parallel.shard_operator``; ``result.eigenvectors`` may be the
    rank's rows (a sharded result's) or the global (n, k) block, which
    each rank cuts to its rows. ``evecs_hi`` and ``evecs_lo`` are then
    the rank's rows; everything else is global and the same on every
    rank.

    Returns a :class:`~fortran_davidson_tpu_torch.core.refine.PolishResult`;
    ``evecs_hi + evecs_lo`` is the float64-grade eigenvector.
    """
    dt = canonical_dtype(dtype or result.eigenvectors.dtype)
    X = result.eigenvectors.to(dt)
    rows = LOCAL
    if mesh is None:
        A = as_operator(matrix, dtype=dt)
        B = (None if second_matrix is None
             else as_operator(second_matrix, dtype=dt, device=A.device))
    else:
        from fortran_davidson_tpu_torch.parallel.sharded import (
            RowShardConstraint, shard_operator)
        A = shard_operator(as_operator(matrix, dtype=dt, device=mesh.device),
                           mesh)
        B = (None if second_matrix is None else shard_operator(
            as_operator(second_matrix, dtype=dt, device=mesh.device), mesh))
        n = A.shape[0]
        local = mesh.rows(n)
        require(X.shape[0] in (n, local.stop - local.start), OperatorError,
                f"eigenvectors have {X.shape[0]} rows: neither the "
                f"operator's {n} nor the rank's {local.stop - local.start}")
        if X.shape[0] != local.stop - local.start:
            X = X[local]
        X = X.to(mesh.device)
        rows = RowShardConstraint(mesh, n)
    with torch.no_grad():
        return polish(
            A.offdiag(), A.diagonal().to(dt),
            result.eigenvalues.to(X.device, dt), X,
            iterations=iterations,
            B_off=None if B is None else B.offdiag(),
            diag_b=None if B is None else B.diagonal().to(dt),
            update=update, rows=rows)


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
        # The hint follows the resolved options: ``refined`` may come in
        # through ``options=DavidsonOptions(refined=True)``.
        refined = merge_options(
            overrides.get("options"),
            {key: v for key, v in overrides.items()
             if key != "options"}).refined
        hint = ""
        if (res.eigenvalues.dtype.itemsize == 4 and not refined
                and tolerance < 1e-5):
            hint = (" — float32 residuals floor at ~sqrt(n)*eps*||A||; "
                    "for tighter tolerances use refined=True (+"
                    "final_polish) or relative_tolerance=True")
        warnings.warn("Davidson algorithm did not converge "
                      f"within {max_iterations} iterations "
                      f"(residuals: {res.residual_norms}){hint}",
                      RuntimeWarning, stacklevel=2)
    return res
