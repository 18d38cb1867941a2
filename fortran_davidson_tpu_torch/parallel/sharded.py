"""Row-sharded Davidson solves (counterpart of
``fortran_davidson_tpu/parallel/sharded.py``).

SPMD over ``torch.distributed``: every rank of the mesh runs the same
solve on its contiguous slice of the rows.

- The operator's rows and the tall arrays V, AV, BV (n, m_max) are
  partitioned over the ranks (:func:`shard_operator`).
- Every product that contracts over rows (VᵀAV, VᵀBV, CGS2's Vᵀblock,
  the CholQR and SVQB Grams, column norms, Olsen's sums, the pick of the
  initial subspace) is a local product followed by ``all_reduce(SUM)``:
  the :class:`RowShardConstraint` hook that the engine
  (``core/loop.py``) routes them through. GSPMD inserts those ``psum``s
  on its own in the JAX package; here they are explicit.
- The small projected eigenproblem is solved on every rank from the
  same all-reduced bits, so every convergence, collapse and stall
  decision, and every live count, is the same on every rank: no rank
  branches apart and hangs the next collective.
- DPR corrections, residuals and basis updates are row-local.

One host read per iteration, as in the single-device loop.
"""

from __future__ import annotations

from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import (DavidsonOptions, DavidsonResult,
                                               merge_options, resolve_options,
                                               validate_initial_vectors)
from fortran_davidson_tpu_torch.core.loop import _engine
from fortran_davidson_tpu_torch.core.rows import Rows
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.ops.operators import (DenseOperator,
                                                      DiagonalOperator,
                                                      LinearOperator,
                                                      as_operator)
from fortran_davidson_tpu_torch.ops.sparse import (BSROperator, ELLOperator,
                                                  HybridBandedOperator,
                                                  QuantizedBandedOperator,
                                                  SlicedELLOperator,
                                                  _ell_chunked_apply)
from fortran_davidson_tpu_torch.parallel.halo import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     block_diagonal,
                                                     local_rows)
from fortran_davidson_tpu_torch.parallel.mesh import ROWS_AXIS, RowMesh
from fortran_davidson_tpu_torch.utils.dtypes import canonical_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


class RowShardConstraint(Rows):
    """The sharded engine's row-reduction hook (the counterpart of the
    JAX package's ``RowShardConstraint``, which pins the tall state
    row-sharded so that GSPMD inserts the sums): sums over rows are
    ``all_reduce(SUM)`` over the mesh's group, for a problem of ``n``
    rows."""

    def __init__(self, mesh: RowMesh, n: int):
        self.mesh = mesh
        self.n = n
        self.offset = mesh.rows(n).start

    def sum(self, t):
        return self.mesh.all_reduce(t)

    def norms(self, X):
        return torch.sqrt(self.sum(torch.sum(X * X, dim=0)))

    def col_mean(self, X):
        return self.sum(torch.sum(X, dim=0)) / self.n

    def smallest(self, values, count: int):
        # Each rank's own smallest, gathered in rank order and stably
        # sorted: ties keep ascending global index, the single-device
        # order, and the global smallest are among the candidates.
        local = torch.argsort(values, stable=True)[:min(count,
                                                        values.shape[0])]
        vals = self.mesh.all_gather_rows(values[local])
        idx = self.mesh.all_gather_rows(local + self.offset)
        return idx[torch.argsort(vals, stable=True)[:count]]


class _RowSharded(LinearOperator):
    """A rank's rows of an n x n operator; ``shape`` is global."""

    def __init__(self, mesh: RowMesh, n: int):
        self.mesh = mesh
        self._n = n

    @property
    def shape(self):
        return (self._n, self._n)

    @property
    def device(self):
        return self.mesh.device


class ShardedDenseOperator(_RowSharded):
    """The rank's rows of a dense matrix; the skinny X is all-gathered."""

    def __init__(self, matrix, mesh: RowMesh):
        n = matrix.shape[1]
        super().__init__(mesh, n)
        self.rows = mesh.rows(n)
        self.matrix = local_rows(matrix, self.rows, mesh.device)

    @property
    def dtype(self):
        return self.matrix.dtype

    def matmat(self, block):
        return self.matrix @ self.mesh.all_gather_rows(block).to(self.dtype)

    def diagonal(self):
        return torch.diagonal(self.matrix, offset=self.rows.start)


class ShardedDiagonalOperator(_RowSharded):
    """The rank's entries of a diagonal operator (row-local apply)."""

    def __init__(self, diag, mesh: RowMesh):
        super().__init__(mesh, diag.shape[0])
        self.diag = local_rows(diag, mesh.rows(diag.shape[0]), mesh.device)

    @property
    def dtype(self):
        return self.diag.dtype

    def matmat(self, block):
        return self.diag[:, None] * block

    def diagonal(self):
        return self.diag


class ShardedBSROperator(_RowSharded):
    """The rank's block rows of a BSR operator, with global block columns.
    The skinny X is all-gathered and the general kernel
    (:func:`~fortran_davidson_tpu_torch.ops.kernels.bsr_spmm`) contracts
    the rank's rows, as GSPMD does around a call it cannot partition."""

    def __init__(self, op: BSROperator, mesh: RowMesh):
        super().__init__(mesh, op.shape[0])
        nbr = op.n_block_rows
        require(nbr % mesh.size == 0, OperatorError,
                f"{nbr} block rows not divisible by the {mesh.size}-device "
                "mesh; pad the block rows")
        self.block_rows = mesh.rows(nbr)
        self.block_cols = local_rows(op.block_cols, self.block_rows,
                                     mesh.device)
        self.blocks = local_rows(op.blocks, self.block_rows, mesh.device)

    @property
    def dtype(self):
        return self.blocks.dtype

    def _compute(self, target):
        # Mixed precision as BSROperator.matmat: the narrower type.
        return self.dtype if self.dtype.itemsize < target.itemsize else target

    def matmat(self, block):
        x = self.mesh.all_gather_rows(block.to(self._compute(block.dtype)))
        return self.apply_gathered(x, out_dtype=block.dtype)

    def apply_gathered(self, x, out_dtype=None):
        """The rank's rows of A X from the all-gathered X (kernel 2)."""
        out_dtype = x.dtype if out_dtype is None else out_dtype
        compute = self._compute(x.dtype)
        return kernels.bsr_spmm(self.block_cols, self.blocks.to(compute),
                                x.to(compute), out_dtype=out_dtype)

    def diagonal(self):
        return block_diagonal(self.blocks, self.block_cols,
                              self.block_rows.start)


class ShardedELLOperator(_RowSharded):
    """The rank's rows of an ELL slot table, with global column indices
    (the row split of ``fortran_davidson_tpu/parallel/sharded.py:131-132``):
    the skinny X is all-gathered and the rank's rows gather from it, the
    pattern of :class:`ShardedBSROperator`."""

    def __init__(self, op: ELLOperator, mesh: RowMesh):
        super().__init__(mesh, op.shape[0])
        self.rows = mesh.rows(op.shape[0])
        self.indices = local_rows(op.indices, self.rows, mesh.device)
        self.values = local_rows(op.values, self.rows, mesh.device)
        self.chunk = op.chunk

    @property
    def dtype(self):
        return self.values.dtype

    def matmat(self, block):
        return self.apply_gathered(self.mesh.all_gather_rows(block))

    def apply_gathered(self, x):
        """The rank's rows of A X from the all-gathered X."""
        return _ell_chunked_apply(self.indices, self.values, x, self.chunk)

    def diagonal(self):
        own = self.indices == (self.rows.start + torch.arange(
            self.indices.shape[0], dtype=torch.int32,
            device=self.indices.device))[:, None]
        return torch.sum(torch.where(own, self.values, 0), dim=1)


class ShardedHybridOperator(_RowSharded):
    """The rank's rows of a band + remainder operator: the band through
    :class:`ShardedBSROperator` (kernel 2) and the remainder through
    :class:`ShardedELLOperator`, both from one all-gather of X."""

    def __init__(self, op: HybridBandedOperator, mesh: RowMesh):
        super().__init__(mesh, op.shape[0])
        self.band = ShardedBSROperator(op.band, mesh)
        rem = op.remainder
        if isinstance(rem, SlicedELLOperator):
            rem = rem.to_ell()
        self.remainder = None if rem is None else ShardedELLOperator(rem,
                                                                     mesh)

    @property
    def dtype(self):
        return self.band.dtype

    def matmat(self, block):
        if self.remainder is None:
            return self.band.matmat(block)
        x = self.mesh.all_gather_rows(block)
        return (self.band.apply_gathered(x)
                + self.remainder.apply_gathered(x))

    def diagonal(self):
        d = self.band.diagonal()
        if self.remainder is not None:
            d = d + self.remainder.diagonal()
        return d


def shard_operator(op: LinearOperator, mesh: RowMesh,
                   axis: str = ROWS_AXIS) -> LinearOperator:
    """The mesh rank's rows of a (global) operator.

    - dense: the matrix rows; diagonal: the diagonal entries;
    - BSR: the block rows, with global ``block_cols`` (all-gathered X,
      kernel 2);
    - ELL: the rows of the slot table, with global column indices
      (all-gathered X); sliced ELL: ``to_ell()`` first, then the ELL rule
      (its unsort gather would cross ranks);
    - hybrid band + remainder: the band by the BSR rule (kernel 2) and the
      remainder by the ELL rule, from one all-gather of X;
    - int8 quantized banded: a :class:`HaloQuantizedOperator` (ring halo
      exchange, kernel 7);
    - operators that are sharded already (the halo operators and the
      results of this function) pass through.

    Any other kind raises ``OperatorError``: a ``MatrixFreeOperator``'s
    callable sees the global rows, so it has no per-rank counterpart yet
    (ROADMAP Queue 1 item 19). Running with an unsharded operator would
    defeat the point of :func:`eigensolve_sharded` without a visible
    signal.
    """
    require(axis == mesh.axis, OperatorError,
            f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    if isinstance(op, (HaloBSROperator, HaloQuantizedOperator, _RowSharded)):
        require(op.mesh == mesh, OperatorError,
                f"{type(op).__name__} lives on another mesh")
        return op
    if isinstance(op, QuantizedBandedOperator):
        return HaloQuantizedOperator.from_quantized(op, mesh, axis)
    if isinstance(op, BSROperator):
        return ShardedBSROperator(op, mesh)
    if isinstance(op, SlicedELLOperator):
        return ShardedELLOperator(op.to_ell(), mesh)
    if isinstance(op, ELLOperator):
        return ShardedELLOperator(op, mesh)
    if isinstance(op, HybridBandedOperator):
        return ShardedHybridOperator(op, mesh)
    if isinstance(op, DenseOperator):
        return ShardedDenseOperator(op.matrix, mesh)
    if isinstance(op, DiagonalOperator):
        return ShardedDiagonalOperator(op.diag, mesh)
    raise OperatorError(
        f"shard_operator: no sharding rule for {type(op).__name__}; "
        "refusing to run eigensolve_sharded with an unsharded operator")


def eigensolve_sharded(matrix, lowest: int, mesh: RowMesh,
                       second_matrix=None, axis: str = ROWS_AXIS,
                       options: Optional[DavidsonOptions] = None,
                       initial_vectors=None,
                       **overrides) -> DavidsonResult:
    """Row-sharded Davidson solve; every rank of ``mesh`` calls it.

    Same contract as :func:`fortran_davidson_tpu_torch.eigensolve`. Every
    rank passes the same global operator (or an operator sharded already,
    such as a :class:`HaloBSROperator` on ``mesh``) and, for a warm start,
    the same global (n, j) ``initial_vectors``; each rank takes its rows.

    Returns the result on every rank: ``eigenvectors`` holds the rank's
    rows (``mesh.rows(n)``); everything else is global and the same on
    every rank. GJD's MINRES sums its column norms and dots over the
    ranks. ``refined=True`` raises ``InvalidOptionsError``: the sharded
    refined path waits for ROADMAP item 19.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)
    A = shard_operator(as_operator(matrix, dtype=dt, device=mesh.device),
                       mesh, axis)
    B = (None if second_matrix is None
         else shard_operator(as_operator(second_matrix, dtype=dt,
                                         device=mesh.device), mesh, axis))
    require(A.shape[0] == A.shape[1], OperatorError, "A must be square")
    if B is not None:
        require(B.shape == A.shape, OperatorError,
                f"B shape {B.shape} does not match A shape {A.shape}")
    n = A.shape[0]
    cfg = resolve_options(opts, lowest, n, generalized=B is not None,
                          device=mesh.device, sharded=True,
                          shard_row_divisor=mesh.size)
    X0 = validate_initial_vectors(initial_vectors, n, cfg.init_dim, dt,
                                  device=mesh.device)
    if X0 is not None:
        X0 = X0[mesh.rows(n)]
    return _engine(cfg, A, B, X0=X0, rows=RowShardConstraint(mesh, n))
