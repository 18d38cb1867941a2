"""Build the port's operators from the JAX package's, handed over as numpy.

The JAX operators keep their data in a few arrays: ``DenseOperator.matrix``,
``DiagonalOperator.diag``, ``BSROperator.block_cols`` / ``.blocks`` /
``.bandwidth`` and ``QuantizedBandedOperator.qblocks`` / ``.scale_rows`` /
``.diag`` / ``.bandwidth``. These functions take those arrays (anything
``numpy.asarray`` accepts) and return the matching operator of this
package on ``device`` (by default the GPU; pass ``device="cpu"`` for the
CPU). A single-device operator's ``backend`` field is not carried across:
here its kernel follows the tensors' device. :func:`halo` carries the halo
operators' ``backend`` (``"xla"``, ``"pallas"`` or ``"pallas-remote"``),
which picks the exchange and the kernel. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fortran_davidson_tpu_torch.ops.operators import (DenseOperator,
                                                      DiagonalOperator,
                                                      LinearOperator)
from fortran_davidson_tpu_torch.ops.sparse import (BSROperator,
                                                  QuantizedBandedOperator)
from fortran_davidson_tpu_torch.parallel.halo import (HaloBSROperator,
                                                     HaloQuantizedOperator)
from fortran_davidson_tpu_torch.parallel.mesh import RowMesh
from fortran_davidson_tpu_torch.utils.dtypes import (as_torch_dtype,
                                                     default_device)
from fortran_davidson_tpu_torch.utils.errors import OperatorError


def _tensor(arr, dtype=None, device=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return t.to(default_device(device))


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
    return BSROperator(_tensor(block_cols, device=device).to(torch.int32),
                       _tensor(blocks, dtype, device), bandwidth=bandwidth)


def quantized(qblocks, scale_rows, diag, bandwidth: int,
              device=None) -> QuantizedBandedOperator:
    """A :class:`QuantizedBandedOperator` from the (nbr, bs, K*bs) int8
    blocks, the (nbr, K*bs) scales, the (nbr, bs) diagonal and the
    bandwidth."""
    return QuantizedBandedOperator(_tensor(qblocks, device=device),
                                   _tensor(scale_rows, device=device),
                                   _tensor(diag, device=device),
                                   bandwidth=bandwidth)


def operator(op, dtype=None, device=None) -> LinearOperator:
    """The port's counterpart of a JAX operator, read through its array
    attributes: an int8 banded (``qblocks``, ``scale_rows``, ``diag``,
    ``bandwidth``; ``dtype`` does not apply), a BSR (``blocks``,
    ``block_cols``, ``bandwidth``), a dense (``matrix``) or a diagonal
    (``diag``) operator. The int8 operator is recognised first: it too
    has a ``diag``, of shape (nbr, bs)."""
    if all(hasattr(op, a) for a in ("qblocks", "scale_rows", "diag",
                                    "bandwidth")):
        return quantized(op.qblocks, op.scale_rows, op.diag, op.bandwidth,
                         device=device)
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
        "diagonal, BSR and int8 banded operators; build matrix-free ones with "
        "MatrixFreeOperator")


def halo(op, mesh: RowMesh, backend: Optional[str] = None):
    """The port's counterpart of a JAX ``HaloBSROperator`` or
    ``HaloQuantizedOperator`` for ``mesh``: their global tables, read with
    ``numpy.asarray``, distributed over the mesh's ranks (each rank keeps
    its rows). ``backend`` defaults to the JAX operator's."""
    backend = op.backend if backend is None else backend
    if hasattr(op, "qblocks"):
        return HaloQuantizedOperator(
            np.asarray(op.qblocks), np.asarray(op.scale_rows),
            np.asarray(op.diag), op.bandwidth, mesh, backend=backend)
    return HaloBSROperator(np.asarray(op.block_cols), np.asarray(op.blocks),
                           op.bandwidth, mesh, backend=backend)
