"""scipy.sparse.linalg-compatible entry point (counterpart of
``fortran_davidson_tpu/scipy_compat.py``).

    from fortran_davidson_tpu_torch.scipy_compat import eigsh
    w, v = eigsh(A, k=6, which="SA", tol=1e-8)

Supported, as in the JAX package: symmetric operators (dense arrays and
tensors, ``scipy.sparse`` matrices, which become padded-ELL operators,
any :class:`LinearOperator` of this package), generalized pencils via
``M``, ``which in ("SA", "LA", "LM", "SM", "BE")``, ``sigma`` interior
targets, ``v0`` warm starts, ``maxiter``/``tol``/``ncv``. Eigenvalues and
eigenvectors come back as numpy arrays, scipy's contract; the solves run
on the operator's device (numpy and scipy input go to ``device``, by
default the GPU).

Largest-algebraic ("LA") solves ride the spectral flip -A; "LM" and "BE"
solve both spectrum ends. Interior targets (``sigma``, and "SM" = sigma
0) use the spectral fold ``(A - σ)²`` instead of scipy's shift-invert:
two operator applies per block, no factorization. Eigenvalues are
recovered as Rayleigh quotients of the returned vectors and every pair is
re-checked against its true residual ``||A x - λ x||``, with warm-started
re-solves at tightened fold tolerances until the user's ``tol`` holds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fortran_davidson_tpu_torch.core.orthogonal import eigh
from fortran_davidson_tpu_torch.ops.operators import (LinearOperator,
                                                      as_operator)
from fortran_davidson_tpu_torch.solver import eigensolve
from fortran_davidson_tpu_torch.utils.dtypes import full_precision_matmuls
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     require)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Negated(LinearOperator):
    """-A as an operator (the spectral flip of which='LA')."""

    def __init__(self, op: LinearOperator):
        self._op = op

    @property
    def shape(self):
        return self._op.shape

    @property
    def dtype(self):
        return self._op.dtype

    @property
    def device(self):
        return self._op.device

    def matmat(self, block):
        return -self._op.matmat(block)

    def diagonal(self):
        return -self._op.diagonal()

    def offdiag(self):
        return _Negated(self._op.offdiag())


class _ShiftFolded(LinearOperator):
    """The spectral fold ``(A - σI)²``: eigenvalues ``(λ - σ)²``, the same
    eigenvectors; the smallest folded eigenvalues belong to the λ nearest
    σ. Two applies of A per block.

    ``diagonal()`` is the diagonal-dominant approximation ``(d - σ)²``;
    the solver uses it only as the preconditioner, and the generic
    ``offdiag`` (``matmat(x) - diagonal()·x``) is self-consistent, so
    residuals and Rayleigh quotients on the fold stay exact.
    """

    def __init__(self, op: LinearOperator, sigma: float):
        self._op = op
        self._sigma = sigma

    @property
    def shape(self):
        return self._op.shape

    @property
    def dtype(self):
        return self._op.dtype

    @property
    def device(self):
        return self._op.device

    def matmat(self, block):
        y = self._op.matmat(block) - self._sigma * block
        return self._op.matmat(y) - self._sigma * y

    def diagonal(self):
        return (self._op.diagonal() - self._sigma) ** 2


def _folded_solve(op, k, sigma, tol, kw):
    """Davidson on the fold, held to the unfolded residuals
    (``fortran_davidson_tpu/scipy_compat.py:119``): lowest-k of
    ``(A-σ)²`` at a fold tolerance, ``λ_j = x_jᵀ A x_j`` by a Rayleigh-Ritz
    of A on the folded subspace, and warm-started re-solves at tightened
    fold tolerances until the true residuals meet ``tol``."""
    fold = _ShiftFolded(op, float(sigma))
    kw = dict(kw)
    kw.pop("tolerance", None)
    x0 = kw.pop("initial_vectors", None)
    res = None
    fold_tol = float(tol)
    # Every folded eigenvalue is a (near-)double (λ = σ±δ fold to δ²), so
    # the k-th folded vector can hold half of a pair: one extra column
    # keeps the boundary pair whole; the k pairs nearest σ are picked
    # after the Rayleigh-Ritz.
    k_f = min(k + 1, op.shape[0])
    theta = X = r = near = None
    for _ in range(4):
        res = eigensolve(fold, k_f, tolerance=fold_tol, initial_vectors=x0,
                         **kw)
        # Rayleigh-Ritz of A (not the fold) on the folded subspace: inside
        # a near-degenerate folded pair the vectors mix the two
        # A-eigenvectors; the span is right, and Qᵀ A Q separates them.
        # In full float32 matmuls: TF32 would put ~1e-3-relative noise
        # under theta and r, and the check below could never pass.
        with full_precision_matmuls(), torch.no_grad():
            Q = torch.linalg.qr(res.eigenvectors)[0]
            AQ = op.matmat(Q).to(Q.dtype)
            theta, U = eigh(Q.T @ AQ)
            X, AX = Q @ U, AQ @ U
            r = torch.linalg.vector_norm(AX - X * theta[None, :], dim=0)
        near = torch.argsort(torch.abs(theta - sigma), stable=True)[:k]
        near = near[torch.argsort(theta[near], stable=True)]  # ascending
        if bool(torch.all(r[near] <= tol)):
            return _np(theta[near]), _np(X[:, near]), _np(r[near])
        x0, fold_tol = X, fold_tol * 1e-2
    # The honest failure: A's Rayleigh-Ritz pairs of the last round and
    # their true residuals, not the fold's (λ-σ)² internals.
    raise ArpackNoConvergence(
        _UnfoldedPartial(
            eigenvalues=_np(theta[near]),
            eigenvectors=_np(X[:, near]),
            converged_pairs=_np(r[near] <= tol),
            iterations=res.iterations,
            residual_norms=_np(r[near]),
            fold_result=res),
        k)


class _UnfoldedPartial:
    """Result-shaped view for :class:`ArpackNoConvergence` after a failed
    spectral-fold solve: eigenvalues, vectors and residuals in A's
    spectrum; the folded solve's result on ``.fold_result``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def eigsh(A, k: int = 6, M=None, sigma=None, which: Optional[str] = None,
          v0=None, ncv: Optional[int] = None, maxiter: Optional[int] = None,
          tol: float = 0.0, return_eigenvectors: bool = True,
          dtype=None, device=None, **overrides):
    """Lowest/largest-k symmetric eigenpairs, shaped like
    ``scipy.sparse.linalg.eigsh`` (``fortran_davidson_tpu.scipy_compat.eigsh``).

    Args:
      A, M: operator and optional pencil B (anything :func:`as_operator`
        takes; callables are not guessed, wrap them in
        :class:`MatrixFreeOperator`).
      k: number of eigenpairs.
      which: "SA" (the default without ``sigma``), "LA" (the smallest of
        -A; with a pencil the flip applies to A only), "LM" (both ends
        solved, the k largest |λ| kept), "BE" (k//2 from the low end, the
        rest from the high end), "SM" (the fold at σ=0, standard problems
        only).
      sigma: the k eigenpairs nearest ``sigma`` through the fold (standard
        problems only; ``which`` must be "LM", scipy's shift-invert
        default).
      v0: (n,) or (n, j) warm-start vector(s).
      ncv: ``max_dim_sub``. maxiter: ``max_iterations``.
      tol: convergence tolerance; scipy's 0 means 1e-8 here.
      return_eigenvectors: ``(w, v)`` or ``w`` alone.
      dtype, device: where numpy or scipy input is built (default: the
        operator's own dtype, and the GPU).
      **overrides: any :class:`DavidsonOptions` field.

    Returns eigenvalues ascending (scipy's order) and, when asked, the
    eigenvectors, as numpy arrays. Raises :class:`ArpackNoConvergence`
    when a solve does not converge.
    """
    if which is None:
        # scipy's default is "LM"; without sigma this package's is the
        # Davidson-native smallest algebraic.
        which = "LM" if sigma is not None else "SA"
    require(which in ("SA", "LA", "LM", "SM", "BE"), InvalidOptionsError,
            f"which={which!r} not supported (use 'SA', 'LA', 'LM', 'SM' "
            "or 'BE')")
    op = as_operator(A, dtype=dtype, device=device)
    B = (None if M is None
         else as_operator(M, dtype=dtype, device=op.device))

    kw = dict(overrides)
    if ncv is not None:
        kw.setdefault("max_dim_sub", int(ncv))
    if maxiter is not None:
        kw.setdefault("max_iterations", int(maxiter))
    kw.setdefault("tolerance", float(tol) if tol else 1e-8)
    if v0 is not None:
        v0 = torch.as_tensor(v0)
        if v0.ndim == 1:
            v0 = v0[:, None]
        kw.setdefault("initial_vectors", v0)

    if sigma is not None or which == "SM":
        require(B is None, InvalidOptionsError,
                "sigma/'SM' (spectral fold) supports standard problems "
                "only: fold a pencil by pre-transforming it, or use "
                "eigensolve directly")
        require(sigma is None or which == "LM", InvalidOptionsError,
                "with sigma, which must be 'LM' (scipy's shift-invert "
                "default: eigenvalues nearest sigma)")
        tol_eff = float(kw.pop("tolerance"))
        w, v, _ = _folded_solve(op, k, 0.0 if sigma is None else sigma,
                                tol_eff, kw)
        return (w, v) if return_eigenvectors else w

    if which in ("LM", "BE"):
        # Both ends: lowest of (A, B) and of (-A, B) (the flip negates the
        # pencil's eigenvalues and keeps its eigenvectors). "LM" keeps the
        # k largest |λ| of the merged set; "BE" half from each end, an odd
        # k giving the extra pair to the high end (scipy's convention).
        k_lo = k if which == "LM" else k // 2
        k_hi = k if which == "LM" else -(-k // 2)
        require(k_lo + k_hi <= op.shape[0], InvalidOptionsError,
                f"which={which!r} solves both spectrum ends and needs "
                "their pair counts to fit n")
        lo = eigensolve(op, max(k_lo, 1), second_matrix=B, **kw)
        hi = eigensolve(_Negated(op), max(k_hi, 1), second_matrix=B, **kw)
        if not (lo.converged and hi.converged):
            raise ArpackNoConvergence(lo if not lo.converged else hi, k)
        w = np.concatenate([_np(lo.eigenvalues)[:k_lo],
                            -_np(hi.eigenvalues)[:k_hi]])
        v = np.concatenate([_np(lo.eigenvectors)[:, :k_lo],
                            _np(hi.eigenvectors)[:, :k_hi]], axis=1)
        if which == "LM":
            keep = np.argsort(-np.abs(w), kind="stable")[:k]
        else:
            keep = np.arange(w.size)
        keep = keep[np.argsort(w[keep], kind="stable")]  # ascending
        return (w[keep], v[:, keep]) if return_eigenvectors else w[keep]

    flip = which == "LA"
    if flip:
        op = _Negated(op)
    res = eigensolve(op, k, second_matrix=B, **kw)
    if not res.converged:
        raise ArpackNoConvergence(res, k)
    w = _np(res.eigenvalues)
    v = _np(res.eigenvectors)
    if flip:
        w = -w[::-1]
        v = v[:, ::-1]
    return (w, v) if return_eigenvectors else w


class ArpackNoConvergence(RuntimeError):
    """Raised when the solve does not converge (scipy's eigsh raises its
    ARPACK equivalent). The partial result rides on ``.result``; the
    converged subset on ``.eigenvalues``/``.eigenvectors`` (numpy, scipy's
    contract)."""

    def __init__(self, result, k: int):
        conv = _np(result.converged_pairs)
        self.result = result
        self.eigenvalues = _np(result.eigenvalues)[conv]
        self.eigenvectors = _np(result.eigenvectors)[:, conv]
        super().__init__(
            f"Davidson did not converge all {k} pairs in "
            f"{int(result.iterations)} iterations "
            f"({int(conv.sum())} converged); inspect .result, or retry "
            "with refined=True / a larger maxiter")
