"""Build the port's operators from the JAX package's, handed over as numpy.

The JAX operators keep their data in a few arrays: ``DenseOperator.matrix``,
``DiagonalOperator.diag``, ``BSROperator.block_cols`` / ``.blocks`` /
``.bandwidth``, ``QuantizedBandedOperator.qblocks`` / ``.scale_rows`` /
``.diag`` / ``.bandwidth``, ``ELLOperator.indices`` / ``.values`` /
``.chunk``, ``SlicedELLOperator.bucket_rows`` / ``.bucket_indices`` /
``.bucket_values`` / ``.gather_map`` / ``.chunk``, and
``HybridBandedOperator.band`` / ``.remainder`` / ``.perm`` (operators
themselves). These functions take those arrays (anything
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
from fortran_davidson_tpu_torch.ops.sparse import (BSROperator, ELLOperator,
                                                  HybridBandedOperator,
                                                  QuantizedBandedOperator,
                                                  SlicedELLOperator)
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


def ell(indices, values, chunk: int = 8, dtype=None,
        device=None) -> ELLOperator:
    """An :class:`ELLOperator` from the (n, L) column and value tables."""
    return ELLOperator(_tensor(indices, device=device).to(torch.int32),
                       _tensor(values, dtype, device), chunk=chunk)


def sliced_ell(bucket_rows, bucket_indices, bucket_values, gather_map,
               chunk: int = 8, dtype=None, device=None) -> SlicedELLOperator:
    """A :class:`SlicedELLOperator` from its bucket tables (one entry a
    bucket) and its (n,) unsort map."""
    return SlicedELLOperator(
        [_tensor(r, device=device) for r in bucket_rows],
        [_tensor(i, device=device) for i in bucket_indices],
        [_tensor(v, dtype, device) for v in bucket_values],
        _tensor(gather_map, device=device), chunk=chunk)


def operator(op, dtype=None, device=None) -> LinearOperator:
    """The port's counterpart of a JAX operator, read through its array
    attributes, in this order:

    - a hybrid band + remainder (``band``, ``remainder``, ``perm``: its
      parts converted in turn). It has neither ``blocks`` nor ``matrix``,
      and its band has ``blocks``: it is recognised first;
    - an int8 banded (``qblocks``, ``scale_rows``, ``diag``,
      ``bandwidth``; ``dtype`` does not apply): it too has a ``diag``, of
      shape (nbr, bs), so it comes before the diagonal;
    - a sliced ELL (``bucket_rows``, ``bucket_indices``,
      ``bucket_values``, ``gather_map``, ``chunk``), before the ELL,
      whose ``chunk`` it shares;
    - an ELL (``indices``, ``values``, ``chunk``);
    - a BSR (``blocks``, ``block_cols``, ``bandwidth``), a dense
      (``matrix``) or a diagonal (``diag``) operator.
    """
    if hasattr(op, "band") and hasattr(op, "remainder"):
        rem = (None if op.remainder is None
               else operator(op.remainder, dtype=dtype, device=device))
        perm = (None if op.perm is None
                else _tensor(op.perm, device=device))
        return HybridBandedOperator(operator(op.band, dtype=dtype,
                                             device=device), rem, perm=perm)
    if all(hasattr(op, a) for a in ("qblocks", "scale_rows", "diag",
                                    "bandwidth")):
        return quantized(op.qblocks, op.scale_rows, op.diag, op.bandwidth,
                         device=device)
    if hasattr(op, "bucket_rows") and hasattr(op, "gather_map"):
        return sliced_ell(op.bucket_rows, op.bucket_indices, op.bucket_values,
                          op.gather_map, chunk=op.chunk, dtype=dtype,
                          device=device)
    if all(hasattr(op, a) for a in ("indices", "values", "chunk")):
        return ell(op.indices, op.values, chunk=op.chunk, dtype=dtype,
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
        "diagonal, BSR, int8 banded, ELL, sliced-ELL and hybrid operators; "
        "build matrix-free ones with MatrixFreeOperator")


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
