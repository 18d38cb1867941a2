"""Batched Davidson: many independent problems, one call (counterpart of
``fortran_davidson_tpu/batched.py``).

The JAX package ``vmap``s its padded while-loop engine over a leading
batch axis, so the whole batch is one compiled program whose per-problem
state updates are masked by each problem's own exit condition. This
first form runs the problems one after another through the
single-problem engine (``core.loop._engine``) on one device, with the
options resolved once for the batch: every problem keeps its own
schedule, iteration count, convergence flags and history, exactly as a
single solve of it would. The result carries a leading batch axis on
every leaf. Batched matmuls over the fleet, with per-problem masks, are
a speed item of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import (DavidsonOptions, DavidsonResult,
                                               merge_options, resolve_options)
from fortran_davidson_tpu_torch.core.loop import _engine
from fortran_davidson_tpu_torch.ops.operators import (DenseOperator,
                                                      DiagonalOperator)
from fortran_davidson_tpu_torch.utils.dtypes import (as_device_tensor,
                                                     canonical_dtype)
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError, require)


def _operator(arr):
    return DiagonalOperator(arr) if arr.ndim == 1 else DenseOperator(arr)


def _stack(results: list) -> DavidsonResult:
    """One result whose leaves carry a leading batch axis."""
    first = results[0]
    dev = first.eigenvalues.device

    def leaf(name):
        values = [getattr(r, name) for r in results]
        if values[0] is None:
            return None
        if isinstance(values[0], torch.Tensor):
            return torch.stack(values)
        return torch.tensor(values, device=dev)

    return DavidsonResult(**{f.name: leaf(f.name)
                             for f in dataclasses.fields(DavidsonResult)})


def eigensolve_batched(matrices, lowest: int, second_matrices=None,
                       options: Optional[DavidsonOptions] = None,
                       initial_vectors=None, device=None,
                       **overrides) -> DavidsonResult:
    """Solve a batch of independent symmetric (generalized) eigenproblems
    (``fortran_davidson_tpu.eigensolve_batched``).

    Args:
      matrices: stacked A — ``(b, n, n)`` dense matrices or ``(b, n)``
        diagonals, a tensor (which keeps its device) or an array (which
        goes to ``device``, by default the GPU).
      lowest: number of lowest eigenpairs per problem.
      second_matrices: optional stacked B of the pencils (either kind; may
        differ from A's, e.g. dense A with diagonal B).
      options / overrides: as :func:`~fortran_davidson_tpu_torch.eigensolve`.
        ``carry_layout="chunked"`` raises (a single-large-problem layout).
      initial_vectors: optional ``(b, n, j)`` per-problem warm starts.

    Returns:
      DavidsonResult whose leaves carry a leading batch axis: eigenvalues
      ``(b, k)``, eigenvectors ``(b, n, k)``, iterations, converged,
      operator_columns and stalled ``(b,)`` tensors, etc.
    """
    opts = merge_options(options, overrides)
    require(opts.carry_layout != "chunked", InvalidOptionsError,
            "eigensolve_batched: carry_layout='chunked' is a single-"
            "large-problem layout; use the default")
    dt = canonical_dtype(opts.dtype)

    A = as_device_tensor(matrices, device).to(dt)
    require(A.ndim in (2, 3), OperatorError,
            "matrices must be (b, n, n) dense or (b, n) diagonals, got "
            f"shape {tuple(A.shape)}")
    require(A.ndim == 2 or A.shape[1] == A.shape[2], OperatorError,
            f"batched matrices must be square, got {tuple(A.shape)}")
    b, n = A.shape[0], A.shape[1]
    Bm = None
    if second_matrices is not None:
        Bm = as_device_tensor(second_matrices, A.device).to(dt)
        require(Bm.ndim in (2, 3) and Bm.shape[0] == b and Bm.shape[1] == n
                and (Bm.ndim == 2 or Bm.shape[2] == n), OperatorError,
                f"second_matrices shape {tuple(Bm.shape)} does not match "
                f"matrices {tuple(A.shape)}")

    cfg = resolve_options(opts, lowest, n, generalized=Bm is not None,
                          device=A.device)

    X0 = None
    if initial_vectors is not None:
        X0 = as_device_tensor(initial_vectors, A.device).to(dt)
        require(X0.ndim == 3 and X0.shape[0] == b and X0.shape[1] == n
                and 1 <= X0.shape[2] <= cfg.init_dim, OperatorError,
                "initial_vectors must be (b, n, j) with j <= init_dim="
                f"{cfg.init_dim}; got {tuple(X0.shape)}")

    results = []
    for i in range(b):
        Ai = _operator(A[i])
        Bi = None if Bm is None else _operator(Bm[i])
        Xi = None if X0 is None else X0[i]
        if cfg.refined:
            results.append(_engine(cfg, Ai, Bi, X0=Xi, A_off=Ai.offdiag(),
                                   B_off=None if Bi is None
                                   else Bi.offdiag()))
        else:
            results.append(_engine(cfg, Ai, Bi, X0=Xi))
    return _stack(results)
