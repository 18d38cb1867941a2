"""Build the port's operators from the JAX package's, handed over as numpy.

The JAX operators keep their data in a few arrays: ``DenseOperator.matrix``,
``DiagonalOperator.diag`` and ``BSROperator.block_cols`` / ``.blocks`` /
``.bandwidth``. These functions take those arrays (anything
``numpy.asarray`` accepts) and return the matching operator of this
package on ``device``. The JAX operator's ``backend`` field is not carried
across: here the kernel follows the tensors' device. Nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops.operators import (DenseOperator,
                                                      DiagonalOperator,
                                                      LinearOperator)
from fortran_davidson_tpu_torch.ops.sparse import BSROperator
from fortran_davidson_tpu_torch.utils.dtypes import as_torch_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError


def _tensor(arr, dtype=None, device=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return t.to(device) if device is not None else t


def dense(matrix, dtype=None, device=None) -> DenseOperator:
    """A :class:`DenseOperator` from an (n, n) array."""
    return DenseOperator(_tensor(matrix, dtype, device))


def diagonal(diag, dtype=None, device=None) -> DiagonalOperator:
    """A :class:`DiagonalOperator` from an (n,) array."""
    return DiagonalOperator(_tensor(diag, dtype, device))


def bsr(block_cols, blocks, bandwidth: Optional[int] = None, dtype=None,
        device=None) -> BSROperator:
    """A :class:`BSROperator` from the (nbr, K) column table, the
    (nbr, bs, K*bs) block slabs and the declared bandwidth (or None)."""
    return BSROperator(_tensor(block_cols).to(torch.int32),
                       _tensor(blocks, dtype), bandwidth=bandwidth,
                       device=device)


def operator(op, dtype=None, device=None) -> LinearOperator:
    """The port's counterpart of a JAX operator, read through its array
    attributes: a BSR (``blocks``, ``block_cols``, ``bandwidth``), a dense
    (``matrix``) or a diagonal (``diag``) operator."""
    if hasattr(op, "blocks") and hasattr(op, "block_cols"):
        return bsr(op.block_cols, op.blocks, getattr(op, "bandwidth", None),
                   dtype=dtype, device=device)
    if hasattr(op, "matrix"):
        return dense(op.matrix, dtype=dtype, device=device)
    if hasattr(op, "diag") and getattr(op, "diag") is not None \
            and not hasattr(op, "fn"):
        return diagonal(op.diag, dtype=dtype, device=device)
    raise OperatorError(
        f"no torch counterpart for {type(op).__name__}: convert dense, "
        "diagonal and BSR operators; build matrix-free ones with "
        "MatrixFreeOperator")
