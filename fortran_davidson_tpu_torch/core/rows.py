"""Reductions over the rows of the solver's tall arrays.

The loop's tall arrays (V, AV, BV, the residual and correction blocks)
are (n, w). On one device a process holds all n rows; in a row-sharded
solve (``parallel.sharded``) each rank holds a contiguous slice of them,
and every product that contracts over rows (Gram matrices, column norms
and sums, the pick of the initial subspace) needs the sum over ranks.
The JAX package leaves those sums to GSPMD, which inserts a ``psum``
after each such product (``fortran_davidson_tpu/parallel/sharded.py:9-15``);
here they are explicit: the core modules route each one through a
:class:`Rows` hook. :data:`LOCAL` is the single-device hook, whose sums
are the identity and whose norms are the single-device code's own, so the
single-device solve is unchanged. ``parallel.sharded.RowShardConstraint``
sums with ``all_reduce(SUM)`` over the mesh's process group, folds
the double-single partials of the refined path (:meth:`Rows.sum_ds`) in
rank order, and gathers the ranks' rows (:meth:`Rows.gather`) for the
TSQR's second stage and for per-rank matrix-free callables that read
rows other than their own.
"""

from __future__ import annotations

import torch


class Rows:
    """The single-device hook: every row is local."""

    #: Global index of the first local row.
    offset = 0
    #: Ranks the rows are split over in equal contiguous slices, and this
    #: process's rank.
    size = 1
    rank = 0
    #: The double-single reductions may take the streaming slab cascade
    #: from ``utils.ds._CASCADE_MIN_ROWS`` rows (the JAX package's
    #: single-device strategy); a sharded solve folds by the tree.
    cascade = True

    def sum(self, t):
        """The sum over all rows of a partial sum over the local rows."""
        return t

    def sum_ds(self, hi, lo):
        """The double-single sum over all rows of a ``(hi, lo)`` partial
        over the local rows (no final renormalisation)."""
        return hi, lo

    def gather(self, t):
        """Every rank's ``t`` (same shape on each) stacked along the
        leading axis, in rank order: on one device, ``t`` itself."""
        return t

    def barrier(self) -> None:
        """Wait for every rank (nothing to wait for on one device)."""

    def skipped(self, kind: str, t) -> None:
        """Note the collective of ``kind`` on ``t`` that N ranks make and
        that this hook skips (``parallel.scaling``'s inventory); nothing
        on one device."""

    def norms(self, X):
        """Column 2-norms of the tall (rows, w) block."""
        return torch.linalg.vector_norm(X, dim=0)

    def col_mean(self, X):
        """Column means of the tall (rows, w) block."""
        return torch.mean(X, dim=0)

    def smallest(self, values, count: int):
        """Global indices of the ``count`` smallest entries of the tall
        vector, ascending, ties by index."""
        return torch.argsort(values, stable=True)[:count]


LOCAL = Rows()
