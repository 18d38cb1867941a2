"""Linear-operator layer (counterpart of
``fortran_davidson_tpu/ops/operators.py``).

An operator is a plain object holding tensors that knows how to apply
itself to a block of vectors (``matmat``: (n, m) -> (n, m)), and gives
its diagonal (``diagonal``, for the DPR preconditioner and the initial
subspace), its off-diagonal split (``offdiag``), ``shape``, ``dtype`` and
``device``. The solver runs on the operator's device.

Constructors follow ``utils.dtypes.as_device_tensor``: a tensor stays on
its device, numpy and Python values go to ``device`` (default: the GPU).
"""

from __future__ import annotations

import abc
from typing import Callable, Optional

import torch

from fortran_davidson_tpu_torch.utils.dtypes import (as_device_tensor,
                                                     as_torch_dtype,
                                                     default_device)
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


class LinearOperator(abc.ABC):
    """A symmetric linear operator on R^n, applied to blocks of vectors."""

    @property
    @abc.abstractmethod
    def shape(self) -> tuple:
        """(n, n)."""

    @property
    @abc.abstractmethod
    def dtype(self) -> torch.dtype:
        ...

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        ...

    @abc.abstractmethod
    def matmat(self, block):
        """Apply to a block: (n, m) -> (n, m)."""

    @abc.abstractmethod
    def diagonal(self):
        """Return the n-vector of diagonal entries."""

    def offdiag(self) -> "LinearOperator":
        """The operator minus its diagonal (generic ``matmat - d∘x``)."""
        return SubtractDiagOperator(self)

    def matmat_ds(self, x_hi, x_lo):
        """Optional double-single block apply: ``(y_hi, y_lo)`` with
        ``y_hi + y_lo ≈ A @ (x_hi + x_lo)`` to ~eps². A plain float32
        apply floors any residual measured through it at its own output
        rounding (~eps/2·‖A_off x‖); operators whose structure admits a
        compensated apply override this. ``None`` (the default, and the
        dense and diagonal operators') means unsupported: callers apply
        each word with ``matmat``."""
        return None

    def matvec(self, vec):
        return self.matmat(vec[:, None])[:, 0]

    def __matmul__(self, other):
        if getattr(other, "ndim", None) == 1:
            return self.matvec(other)
        return self.matmat(other)

    @property
    def n(self) -> int:
        return self.shape[0]


class SubtractDiagOperator(LinearOperator):
    """Generic off-diagonal wrapper: ``A_off @ x = A @ x - d ∘ x``."""

    def __init__(self, base: LinearOperator):
        self.base = base
        self._diag = base.diagonal()

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def matmat(self, block):
        return self.base.matmat(block) - self._diag[:, None] * block

    def diagonal(self):
        return torch.zeros_like(self._diag)


class DenseOperator(LinearOperator):
    """Operator backed by a dense symmetric matrix (one GEMM per apply)."""

    def __init__(self, matrix, device=None):
        matrix = as_device_tensor(matrix, device)
        require(matrix.ndim == 2 and matrix.shape[0] == matrix.shape[1],
                OperatorError,
                "DenseOperator needs a square matrix, got "
                f"{tuple(matrix.shape)}")
        self.matrix = matrix

    @property
    def shape(self):
        return tuple(self.matrix.shape)

    @property
    def dtype(self):
        return self.matrix.dtype

    @property
    def device(self):
        return self.matrix.device

    def matmat(self, block):
        return self.matrix @ block.to(self.dtype)

    def diagonal(self):
        return torch.diagonal(self.matrix)

    def offdiag(self):
        diag = torch.diag(torch.diagonal(self.matrix))
        return DenseOperator(self.matrix - diag)

    def to_dense(self):
        return self.matrix


class DiagonalOperator(LinearOperator):
    """Operator backed by a diagonal (the cheapest useful B for pencils)."""

    def __init__(self, diag, device=None):
        diag = as_device_tensor(diag, device)
        require(diag.ndim == 1, OperatorError,
                "DiagonalOperator needs a 1-D diagonal")
        self.diag = diag

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def matmat(self, block):
        return self.diag[:, None] * block

    def diagonal(self):
        return self.diag

    def offdiag(self):
        return DiagonalOperator(torch.zeros_like(self.diag))

    def to_dense(self):
        return torch.diag(self.diag)


class MatrixFreeOperator(LinearOperator):
    """Operator defined by a block callable ``fn(X: (n, m), *captured)``.

    Mirrors the reference matrix-free engine input
    (``src/davidson.f90:277-337``). Supply the diagonal up front
    (``diag=``); without it, it is probed in blocks
    (:func:`probe_diagonal`), ``ceil(n / 128)`` block applications.
    ``offdiag_fn`` is an optional exact off-diagonal apply with the same
    signature as ``fn``. ``ds_fn(x_hi, x_lo, *captured) -> (y_hi, y_lo)``
    is an optional double-single apply of this operator
    (:meth:`LinearOperator.matmat_ds`); ``offdiag_ds_fn`` becomes the
    ``ds_fn`` of the :meth:`offdiag` operator.
    """

    def __init__(self, fn: Callable, n: int, dtype=torch.float64,
                 diag=None, captured=(), offdiag_fn: Optional[Callable] = None,
                 device=None, ds_fn: Optional[Callable] = None,
                 offdiag_ds_fn: Optional[Callable] = None):
        self.fn = fn
        self._n = int(n)
        self._dtype = as_torch_dtype(dtype)
        if device is None:
            # Follow the tensors it was given; with none, the GPU.
            device = next((t.device for t in (diag, *captured)
                           if isinstance(t, torch.Tensor)), None)
        self._device = default_device(device)
        self.diag = (None if diag is None
                     else torch.as_tensor(diag, device=self._device))
        self.captured = tuple(captured)
        self.offdiag_fn = offdiag_fn
        self.ds_fn = ds_fn
        self.offdiag_ds_fn = offdiag_ds_fn

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def matmat(self, block):
        return self.fn(block, *self.captured)

    def diagonal(self):
        if self.diag is not None:
            return self.diag
        return probe_diagonal(self.matmat, self._n, self._dtype, self._device)

    def matmat_ds(self, x_hi, x_lo):
        if self.ds_fn is None:
            return None
        return self.ds_fn(x_hi, x_lo, *self.captured)

    def offdiag(self):
        if self.offdiag_fn is None:
            return super().offdiag()
        return MatrixFreeOperator(self.offdiag_fn, self._n, dtype=self._dtype,
                                  diag=torch.zeros((self._n,), dtype=self._dtype,
                                                   device=self._device),
                                  captured=self.captured,
                                  device=self._device,
                                  ds_fn=self.offdiag_ds_fn)


def probe_diagonal(matmat: Callable, n: int, dtype, device=None,
                   block: int = 128):
    """Diagonal of an implicit operator from blocks of canonical unit
    vectors: ``ceil(n / block)`` block applications (the reference takes
    n single-vector applications, ``src/davidson.f90:516-521``). The last
    block is shifted to end at row n, as in the JAX package."""
    dtype = as_torch_dtype(dtype)
    device = default_device(device)
    block = min(block, n)
    nblocks = -(-n // block)
    eye = torch.eye(block, dtype=dtype, device=device)
    diag = torch.zeros((n,), dtype=dtype, device=device)
    for i in range(nblocks):
        start = min(i * block, n - block)
        probes = torch.zeros((n, block), dtype=dtype, device=device)
        probes[start:start + block] = eye
        out = matmat(probes)
        diag[start:start + block] = torch.diagonal(out[start:start + block])
    return diag


def from_element_fn(fn: Callable, n: int, dtype=torch.float64,
                    diag=None, row_block: int = 256, device=None
                    ) -> MatrixFreeOperator:
    """Operator defined by an element function ``fn(i, j) -> A_ij``.

    Counterpart of the reference's ``free_matmul``
    (``src/davidson.f90:526-569``): rows are generated ``row_block`` at a
    time and contracted against the input block. ``fn`` takes broadcasting
    int64 tensors ``i`` (rows, 1) and ``j`` (1, n) and returns the
    (rows, n) entries (compute them in the operator's dtype: torch
    promotes ``1.0 + i`` to float32).
    """
    dt = as_torch_dtype(dtype)
    device = default_device(device)
    cols = torch.arange(n, device=device)
    if diag is None:
        diag = fn(cols, cols).to(dt)

    def apply(X, diag):
        out = torch.empty((n, X.shape[1]), dtype=X.dtype, device=X.device)
        for start in range(0, n, row_block):
            rows = torch.arange(start, min(start + row_block, n),
                                device=X.device)[:, None]
            block = fn(rows, cols[None, :]).to(X.dtype)
            out[start:start + rows.shape[0]] = block @ X
        return out

    return MatrixFreeOperator(apply, n, dtype=dt, diag=diag, captured=(diag,),
                              device=device)


def as_operator(obj, dtype=None, device=None) -> LinearOperator:
    """Coerce user input (operator / dense array / diagonal / scipy
    sparse matrix) to a LinearOperator. Tensors stay on their device
    unless ``device`` is given; numpy and scipy input go to ``device``, by
    default the GPU."""
    if isinstance(obj, LinearOperator):
        return obj
    # scipy.sparse input (duck-typed, so scipy stays optional): CSR, CSC
    # and COO matrices become padded-ELL operators, assembled on the host
    # (``fortran_davidson_tpu/ops/operators.py:397-403``).
    if hasattr(obj, "tocsr") and hasattr(obj, "shape"):
        from fortran_davidson_tpu_torch.ops.sparse import ELLOperator
        csr = obj.tocsr()
        return ELLOperator.from_csr(csr.indptr, csr.indices, csr.data,
                                    dtype=dtype or csr.dtype, device=device)
    arr = as_device_tensor(obj, device)
    if dtype is not None:
        arr = arr.to(as_torch_dtype(dtype))
    if arr.ndim == 2:
        return DenseOperator(arr)
    if arr.ndim == 1:
        return DiagonalOperator(arr)
    raise OperatorError(
        f"Cannot interpret object of type {type(obj)} with ndim "
        f"{arr.ndim} as a linear operator")
