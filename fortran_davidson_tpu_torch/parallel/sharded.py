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
- The refined path's compensated reductions fold each rank's rows by the
  tree and the ranks' (width) double-single partials in rank order by an
  exact cascade (:meth:`RowShardConstraint.sum_ds`), the JAX package's
  shard-local order (``fortran_davidson_tpu/utils/ds.py:286-330``).
- ``orthonormalization="qr"`` is a TSQR (``core.orthogonal.tsqr``): each
  rank's Householder QR, then one QR of the ranks' gathered R factors.
- The matrix-free rule (:class:`ShardedMatrixFreeOperator`): where GSPMD
  splits a global-view callable in the JAX package, the port takes
  per-rank callables, which declare themselves by a ``rows`` keyword and
  sum over rows through it; a callable without it raises.

One host read per iteration, as in the single-device loop.

What crosses between ranks in an iteration (``parallel/scaling.py``
records it): width-scale all-reduces and all-gathers of partials, and
per operator apply either the halo rows (row-local: the halo operators,
kernels 6-8, and the per-rank matrix-free rule) or the whole skinny X.
The rules that all-gather X are n-scale by design: dense, general BSR
(kernel 2), ELL, sliced ELL (through ``to_ell``) and the hybrid (one
gather for its band and its remainder), ``n * w * itemsize`` bytes an
apply per rank (160 B a row at w = 20 in float64).
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
                                                      MatrixFreeOperator,
                                                      as_operator,
                                                      probe_diagonal,
                                                      takes_rows)
from fortran_davidson_tpu_torch.ops.sparse import (BSROperator, ELLOperator,
                                                  HybridBandedOperator,
                                                  QuantizedBandedOperator,
                                                  SlicedELLOperator,
                                                  _ell_chunked_apply)
from fortran_davidson_tpu_torch.parallel.halo import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     block_diagonal,
                                                     local_rows, own_rows)
from fortran_davidson_tpu_torch.parallel.mesh import (ROWS_AXIS, RowMesh,
                                                      _record)
from fortran_davidson_tpu_torch.utils.ds import cascade_partials
from fortran_davidson_tpu_torch.utils.dtypes import canonical_dtype
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require

# The row-sharded keys of the loop state (``core/loop.init_state``): each
# rank holds its rows of them; every other key is the same on every rank
# (``fortran_davidson_tpu/parallel/sharded.py:48``).
SHARDED_STATE_KEYS = ("V", "AV", "BV", "evecs", "corr_prev")


class RowShardConstraint(Rows):
    """The sharded engine's row-reduction hook (the counterpart of the
    JAX package's ``RowShardConstraint``, which pins the tall state
    row-sharded so that GSPMD inserts the sums): sums over rows are
    ``all_reduce(SUM)`` over the mesh's group, for a problem of ``n``
    rows."""

    cascade = False

    def __init__(self, mesh: RowMesh, n: int):
        self.mesh = mesh
        self.n = n
        self.offset = mesh.rows(n).start
        self.size = mesh.size
        self.rank = mesh.rank

    def sum(self, t):
        return self.mesh.all_reduce(t)

    def sum_ds(self, hi, lo):
        # One all-gather of the stacked (hi, lo) partials, in rank order,
        # folded exactly by every rank: the same bits everywhere.
        parts = self.mesh.all_gather_rows(torch.stack([hi, lo])[None])
        return cascade_partials(parts[:, 0], parts[:, 1])

    def gather(self, t):
        return self.mesh.all_gather_rows(t)

    def barrier(self) -> None:
        self.mesh.barrier()

    def skipped(self, kind: str, t) -> None:
        # Recorded as not moved: a one-rank mesh's inventory is then an
        # N-rank solve's.
        _record(kind, t.dtype, t.shape, False)

    def norms(self, X):
        # One rank holds every row: the single-device norm, so that a
        # world-size-1 solve keeps the single-device bits. The inventory
        # still counts the all-reduce of the (w,) partials N ranks make.
        if self.size == 1:
            self.skipped("all-reduce", X[0])
            return super().norms(X)
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

    def offdiag(self) -> "ShardedDenseOperator":
        """Exact off-diagonal split: the rank's diagonal entries zeroed."""
        out = object.__new__(ShardedDenseOperator)
        out.__dict__.update(self.__dict__, matrix=self.matrix.clone())
        torch.diagonal(out.matrix, offset=self.rows.start).zero_()
        return out


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

    def offdiag(self) -> "ShardedDiagonalOperator":
        out = object.__new__(ShardedDiagonalOperator)
        out.__dict__.update(self.__dict__, diag=torch.zeros_like(self.diag))
        return out


class ShardedBSROperator(_RowSharded):
    """The rank's block rows of a BSR operator, with global block columns.
    The skinny X is all-gathered and the general kernel
    (:func:`~fortran_davidson_tpu_torch.ops.kernels.bsr_spmm`) contracts
    the rank's rows, as GSPMD does around a call it cannot partition.
    With ``n_block_rows`` (the global count), ``op`` holds only the
    rank's block rows already (``ops.sparse.banded_bsr_rows``)."""

    def __init__(self, op: BSROperator, mesh: RowMesh, *,
                 n_block_rows: Optional[int] = None):
        held = op.n_block_rows
        nbr = held if n_block_rows is None else int(n_block_rows)
        super().__init__(mesh, nbr * op.block_size)
        require(nbr % mesh.size == 0, OperatorError,
                f"{nbr} block rows not divisible by the {mesh.size}-device "
                "mesh; pad the block rows")
        self.block_rows = mesh.rows(nbr)
        mine = own_rows(held, n_block_rows, mesh, nbr // mesh.size)
        self.block_cols = local_rows(op.block_cols, mine, mesh.device)
        self.blocks = local_rows(op.blocks, mine, mesh.device)

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

    def offdiag(self) -> "ShardedBSROperator":
        """Exact off-diagonal split: the diagonal entries of the rank's
        on-diagonal blocks zeroed."""
        nbr_l, bs, kbs = self.blocks.shape
        own = self.block_cols == (self.block_rows.start + torch.arange(
            nbr_l, dtype=self.block_cols.dtype,
            device=self.block_cols.device))[:, None]
        j = torch.arange(kbs, device=self.blocks.device)
        in_block_diag = (torch.arange(bs, device=self.blocks.device)[:, None]
                         == (j % bs)[None, :])
        mask = own[:, None, j // bs] & in_block_diag[None]
        out = object.__new__(ShardedBSROperator)
        out.__dict__.update(self.__dict__,
                            blocks=torch.where(mask, 0, self.blocks))
        return out


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

    def _own(self):
        return self.indices == (self.rows.start + torch.arange(
            self.indices.shape[0], dtype=torch.int32,
            device=self.indices.device))[:, None]

    def diagonal(self):
        return torch.sum(torch.where(self._own(), self.values, 0), dim=1)

    def offdiag(self) -> "ShardedELLOperator":
        """Exact off-diagonal split: the stored diagonal slots zeroed."""
        out = object.__new__(ShardedELLOperator)
        out.__dict__.update(self.__dict__, values=torch.where(
            self._own(), 0, self.values))
        return out


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

    def offdiag(self) -> "ShardedHybridOperator":
        out = object.__new__(ShardedHybridOperator)
        out.__dict__.update(
            self.__dict__, band=self.band.offdiag(),
            remainder=(None if self.remainder is None
                       else self.remainder.offdiag()))
        return out


class ShardedMatrixFreeOperator(_RowSharded):
    """The rank's rows of a matrix-free operator whose callables are
    per-rank (they take a ``rows`` keyword, see
    :class:`~fortran_davidson_tpu_torch.ops.operators.MatrixFreeOperator`).

    The JAX package shards every captured array whose leading dimension
    is n and lets GSPMD split the global-view callable and insert the row
    sums (``fortran_davidson_tpu/parallel/sharded.py:145-151``). PyTorch
    has no GSPMD, so here each callable runs on the rank's rows: this
    operator keeps the rank's rows of every captured tensor whose leading
    dimension is n, and of ``diag``, and calls ``fn(X_local,
    *captured_local, rows=hook)``, the hook a :class:`RowShardConstraint`
    through which the callable sums (and gathers) over the ranks.
    ``offdiag_fn``, ``ds_fn`` and ``offdiag_ds_fn`` are called alike.
    """

    def __init__(self, op: MatrixFreeOperator, mesh: RowMesh):
        n = op.shape[0]
        super().__init__(mesh, n)
        self.rows = mesh.rows(n)

        def local(t):
            if isinstance(t, torch.Tensor):
                return local_rows(t, self.rows, mesh.device) if (
                    t.ndim >= 1 and t.shape[0] == n) else t.to(mesh.device)
            return t

        self.fn, self.offdiag_fn = op.fn, op.offdiag_fn
        self.ds_fn, self.offdiag_ds_fn = op.ds_fn, op.offdiag_ds_fn
        self.captured = tuple(local(c) for c in op.captured)
        self.diag = None if op.diag is None else local(op.diag)
        self._dtype = op.dtype
        self.hook = RowShardConstraint(mesh, n)

    @property
    def dtype(self):
        return self._dtype

    def matmat(self, block):
        return self.fn(block, *self.captured, rows=self.hook)

    def diagonal(self):
        if self.diag is not None:
            return self.diag
        # Probed through the per-rank apply: every rank issues the same
        # probes, so the callable's collectives stay in lockstep.
        return probe_diagonal(self.matmat, self._n, self._dtype,
                              self.mesh.device, rows=self.rows)

    def matmat_ds(self, x_hi, x_lo):
        if self.ds_fn is None:
            return None
        return self.ds_fn(x_hi, x_lo, *self.captured, rows=self.hook)

    def offdiag(self) -> LinearOperator:
        if self.offdiag_fn is None:
            return super().offdiag()
        out = object.__new__(ShardedMatrixFreeOperator)
        out.__dict__.update(
            self.__dict__, fn=self.offdiag_fn, offdiag_fn=None,
            ds_fn=self.offdiag_ds_fn, offdiag_ds_fn=None,
            diag=torch.zeros((self.rows.stop - self.rows.start,),
                             dtype=self._dtype, device=self.mesh.device))
        return out


def _shard_matrix_free(op: MatrixFreeOperator,
                       mesh: RowMesh) -> ShardedMatrixFreeOperator:
    """The per-rank rule, or ``OperatorError`` naming the callable that
    does not take ``rows``."""
    for name in ("fn", "offdiag_fn", "ds_fn", "offdiag_ds_fn"):
        fn = getattr(op, name)
        require(fn is None or takes_rows(fn), OperatorError,
                f"shard_operator: no sharding rule for MatrixFreeOperator "
                f"whose {name} takes no 'rows' keyword: a callable handed "
                "only its rank's rows must declare that it is per-rank "
                "(sum over rows through rows.sum, see MatrixFreeOperator); "
                "refusing to run eigensolve_sharded with it")
    return ShardedMatrixFreeOperator(op, mesh)


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
    - matrix-free: a :class:`ShardedMatrixFreeOperator`, the rank's rows
      of ``diag`` and of every captured tensor whose leading dimension is
      n, each callable run on the rank's rows with the mesh's
      ``rows`` hook. Every callable (``fn``, ``offdiag_fn``, ``ds_fn``,
      ``offdiag_ds_fn``) must take the ``rows`` keyword; one that does
      not is a global-view callable, which would contract over the
      rank's rows only and give a wrong answer with no signal: it raises
      ``OperatorError``, and never runs on gathered global rows;
    - operators that are sharded already (the halo operators and the
      results of this function) pass through.

    Any other kind raises ``OperatorError``: running with an unsharded
    operator would defeat the point of :func:`eigensolve_sharded` without
    a visible signal.
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
    if isinstance(op, MatrixFreeOperator):
        return _shard_matrix_free(op, mesh)
    raise OperatorError(
        f"shard_operator: no sharding rule for {type(op).__name__}; "
        "refusing to run eigensolve_sharded with an unsharded operator")


def prepare_sharded(matrix, lowest: int, mesh: RowMesh, second_matrix,
                    axis: str, opts: DavidsonOptions):
    """The rank's operators, the resolved configuration and the row hook
    of a sharded solve: ``(A, B, cfg, rows)``. :func:`eigensolve_sharded`
    and ``eigensolve_checkpointed(mesh=...)`` share it."""
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
    return A, B, cfg, RowShardConstraint(mesh, n)


def local_initial_vectors(initial_vectors, n: int, cfg, mesh: RowMesh,
                          dtype):
    """The rank's rows of a warm-start block: the global (n, j) block, or
    already the rank's rows of it (a sharded result's ``eigenvectors``),
    validated. ``None`` for ``None``."""
    n_local = n // mesh.size
    local = (initial_vectors is not None and mesh.size > 1
             and initial_vectors.shape[0] == n_local)
    X0 = validate_initial_vectors(initial_vectors, n_local if local else n,
                                  cfg.init_dim, dtype, device=mesh.device)
    return X0 if X0 is None or local else X0[mesh.rows(n)]


def eigensolve_sharded(matrix, lowest: int, mesh: RowMesh,
                       second_matrix=None, axis: str = ROWS_AXIS,
                       options: Optional[DavidsonOptions] = None,
                       initial_vectors=None,
                       **overrides) -> DavidsonResult:
    """Row-sharded Davidson solve; every rank of ``mesh`` calls it.

    Same contract as :func:`fortran_davidson_tpu_torch.eigensolve`. Every
    rank passes the same global operator (or an operator sharded already,
    such as a :class:`HaloBSROperator` on ``mesh``) and, for a warm start,
    the same global (n, j) ``initial_vectors``, each rank taking its rows,
    or its own rows of them (a sharded result's ``eigenvectors``).

    Returns the result on every rank: ``eigenvectors`` holds the rank's
    rows (``mesh.rows(n)``); everything else is global and the same on
    every rank. GJD's MINRES sums its column norms and dots over the
    ranks; the refined path (``refined=True``, ``final_polish``) folds its
    compensated sums shard-locally (:meth:`RowShardConstraint.sum_ds`) and
    takes the operators' exact off-diagonal splits (``offdiag()``).
    """
    opts = merge_options(options, overrides)
    A, B, cfg, rows = prepare_sharded(matrix, lowest, mesh, second_matrix,
                                      axis, opts)
    X0 = local_initial_vectors(initial_vectors, A.shape[0], cfg, mesh,
                               canonical_dtype(opts.dtype))
    if cfg.refined:
        return _engine(cfg, A, B, X0=X0, rows=rows, A_off=A.offdiag(),
                       B_off=None if B is None else B.offdiag())
    return _engine(cfg, A, B, X0=X0, rows=rows)
