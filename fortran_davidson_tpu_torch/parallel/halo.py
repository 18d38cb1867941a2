"""Banded operators applied with a ring halo exchange (counterpart of
``fortran_davidson_tpu/parallel/halo.py``).

Each rank owns a contiguous slab of block rows of a banded operator (the
tables and the basis rows are partitioned alike). A block row reads x
rows at most ``bandwidth`` block rows away, so an apply needs, beyond
the rank's own rows, only the last ``bandwidth * bs`` rows of its ring
predecessor and the first of its successor. JAX moves them with two
``ppermute``s. At the ring's two ends the wrapped rows meet the zero
blocks of out-of-range slots. Every backend but ``"pallas-remote"`` on
its push route moves them here with :meth:`RowMesh.ring_exchange`:
ring-neighbour point-to-point, O(bw · bs · m) per rank at any world
size, waited on before the rows that read them; at world size 1, where a
send to oneself is refused, the halos are views of the rank's own rows.

Backends, as in JAX:

- ``"pallas"``: the shard-local contraction in the kernel, over the
  halo-extended rows ``x_ext = [from_prev; x; from_next]`` (one copy of x
  per apply):
  :func:`~fortran_davidson_tpu_torch.ops.kernels.banded_ext_bsr_spmm`
  (kernel 6) and
  :func:`~fortran_davidson_tpu_torch.ops.kernels.banded_q_ext_bsr_spmm`
  (kernel 7), which take their plain versions on the CPU.
- ``"pallas-remote"``: kernel 8, which reads the shard's rows and the
  two halos through their own pointers (no x_ext), by one of two routes,
  the operator's ``route``, decided once at construction from the mesh's
  topology (:func:`~fortran_davidson_tpu_torch.parallel.mesh.halo_route`):

  - ``"push"`` (every ring neighbour's GPU on this host and
    peer-accessible; world size 1 on the card):
    :meth:`RowMesh.ring_push`, the TPU kernel's own form
    (:func:`~fortran_davidson_tpu_torch.ops.kernels.banded_remote_push_spmm`):
    one launch writes the shard's edge rows into the neighbours' halo
    windows over NVLink and computes over the halos pushed into its own,
    no NCCL call. At world size 1 it pushes into the rank's own window.
  - ``"exchange"`` (meshes that span hosts, CPU ranks):
    :func:`~fortran_davidson_tpu_torch.ops.kernels.banded_remote_halo_spmm`
    after :meth:`RowMesh.ring_exchange`: the exchange starts, the interior
    block rows (which read no halo) launch while it runs, the stream waits
    on its works, and the 2·bw edge block rows launch.

  No route falls back to the other. BSR operator only, as in JAX.
- ``"xla"``: JAX's non-kernel path as plain torch: for the BSR operator
  the interior contraction over the columns the rank owns plus the halo
  contraction over the 2·bw received blocks (any banded column table);
  for the int8 operator the dequantized windowed product.

JAX runs its Mosaic kernels only for ``nbr_local % 8 == 0`` (and the
remote one for ``nbr_local >= 16``), Mosaic's tiles, and takes ``"xla"``
otherwise; the CUDA kernels have no tile constraint, so the port runs
them for every DIA-aligned operator (K == 2·bw + 1). ``HaloBSROperator``
with ``"pallas"`` or ``"pallas-remote"`` requires that storage and raises
otherwise: on a GPU it launches its kernel or raises, never falls back.

The operators keep only their rank's rows; at world size 1 those are
views of the global tables handed in (no copy when they are already on
the mesh's device). ``shape`` is global; ``diagonal()`` and ``matmat``
work on the rank's rows. With ``n_block_rows=`` (the global block-row
count) the tables handed in hold only the rank's rows already, as
``ops.sparse.banded_bsr_rows`` and ``banded_bsr_quantized_rows`` build
them: a rank then never holds another rank's rows, on the host or on its
device. (The JAX package shards one global array and has no such entry.)
"""

from __future__ import annotations

from typing import Optional

import torch

from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.ops.operators import LinearOperator
from fortran_davidson_tpu_torch.parallel.mesh import ROWS_AXIS, RowMesh
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require


def local_rows(t, rows: slice, device) -> torch.Tensor:
    """Rows ``rows`` of ``t`` (a tensor or array) on ``device``: a view
    when ``t`` already lives there, else a copy of those rows only."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    return t[rows].to(device)


def block_diagonal(blocks, block_cols, row0: int):
    """The matrix diagonal of a rank's (nbr_l, bs, K*bs) block rows, whose
    first global block row is ``row0``: the diagonal entries of every
    slot's block, summed over the row's own slots (those stored at its own
    block column). It reads nbr_l*K*bs entries and copies no block: a
    solve takes the diagonal every iteration."""
    nbr_l, bs, kbs = blocks.shape
    own = block_cols == (row0 + torch.arange(
        nbr_l, dtype=block_cols.dtype, device=blocks.device))[:, None]
    entries = torch.diagonal(blocks.reshape(nbr_l, bs, kbs // bs, bs),
                             dim1=1, dim2=3)                 # (nbr_l, K, bs)
    return torch.sum(torch.where(own[:, :, None], entries, 0),
                     dim=1).reshape(-1)


def _exchange(mesh: RowMesh, x, halo: int):
    """``(from_prev, from_next)``: the last ``halo`` rows of the ring
    predecessor's ``x`` and the first ``halo`` rows of its successor's,
    by :meth:`RowMesh.ring_exchange`, its works waited on (on NCCL the
    stream waits, not the host)."""
    from_prev, from_next, works = mesh.ring_exchange(x, halo)
    for work in works:
        work.wait()
    return from_prev, from_next


def _extended(mesh: RowMesh, x, halo: int):
    """The halo-extended rows ``[from_prev; x; from_next]``."""
    from_prev, from_next = _exchange(mesh, x, halo)
    return torch.cat([from_prev, x, from_next])


def _check_slab(nbr: int, bandwidth: int, mesh: RowMesh, axis: str) -> int:
    require(axis == mesh.axis, OperatorError,
            f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    require(nbr % mesh.size == 0, OperatorError,
            f"{nbr} block rows not divisible by {mesh.size} devices")
    nbr_local = nbr // mesh.size
    require(bandwidth <= nbr_local, OperatorError,
            f"bandwidth {bandwidth} exceeds local slab {nbr_local} — "
            "halo exchange only reaches ring neighbors")
    return nbr_local


def own_rows(held: int, n_block_rows, mesh: RowMesh,
             nbr_local: int) -> slice:
    """The rank's block rows in tables that hold ``held`` of them: its
    slab of global tables (``n_block_rows`` None), or all of them when
    the tables hold only the rank's rows of ``n_block_rows``."""
    if n_block_rows is None:
        return slice(mesh.rank * nbr_local, (mesh.rank + 1) * nbr_local)
    require(held == nbr_local, OperatorError,
            f"tables of a rank's rows hold {held} block rows; rank "
            f"{mesh.rank} of {mesh.size} owns {nbr_local} of {n_block_rows}")
    return slice(0, held)


class HaloBSROperator(LinearOperator):
    """Banded block-ELL operator applied with ring halo exchange.

    ``block_cols``/``blocks`` are the global (nbr, K) and (nbr, bs, K*bs)
    tables of :class:`~fortran_davidson_tpu_torch.ops.sparse.BSROperator`,
    restricted to a band: every stored block's column lies within
    ``bandwidth`` block rows of its own block row. The operator keeps the
    mesh rank's block rows, on the mesh's device. With ``n_block_rows``
    (the global count) the tables are the rank's (nbr / size) rows
    already, with global block columns
    (``ops.sparse.banded_bsr_rows(nbr, bs, mesh.rows(nbr), ...)``).

    ``route`` says how an apply moves the halos: ``"push"``, kernel 8's
    one launch that pushes them into the ring neighbours' windows (backend
    ``"pallas-remote"`` where every neighbour's GPU is on this host and
    peer-accessible, :func:`~fortran_davidson_tpu_torch.parallel.mesh.
    halo_route`), or ``"exchange"``, ring point-to-point before the kernel
    (every other case). It is decided at construction, from the topology
    alone (a collective for ``"pallas-remote"`` on a mesh of GPUs). The
    push route's window (:meth:`RowMesh.open_window`) is opened at the
    first apply and regrown, collectively, when a wider block arrives:
    to twice its slots at least, so a solve regrows it a handful of
    times. An operator and its :meth:`offdiag` share it.
    """

    def __init__(self, block_cols, blocks, bandwidth: int, mesh: RowMesh,
                 axis: str = ROWS_AXIS, backend: str = "xla", *,
                 n_block_rows: Optional[int] = None):
        require(backend in ("xla", "pallas", "pallas-remote"), OperatorError,
                f"unknown halo backend {backend!r}")
        held, K = block_cols.shape[:2]
        nbr = held if n_block_rows is None else int(n_block_rows)
        nbr_local = _check_slab(nbr, bandwidth, mesh, axis)
        require(backend == "xla" or K == 2 * bandwidth + 1, OperatorError,
                f"backend={backend!r} runs a DIA-banded kernel and needs "
                f"K == 2*bandwidth+1 window-aligned slots, got K={K}, "
                f"bw={bandwidth}; use backend='xla'")
        rows = own_rows(held, n_block_rows, mesh, nbr_local)
        self.block_cols = local_rows(block_cols, rows, mesh.device).to(
            torch.int32)
        self.blocks = local_rows(blocks, rows, mesh.device)
        self.bandwidth = int(bandwidth)
        self.mesh = mesh
        self.axis = axis
        self.backend = backend
        self._nbr = nbr
        self.route = (mesh.halo_route() if backend == "pallas-remote"
                      else "exchange")
        self._push = {"window": None}

    @classmethod
    def from_bsr(cls, op, bandwidth: int, mesh: RowMesh,
                 axis: str = ROWS_AXIS,
                 backend: str = "xla") -> "HaloBSROperator":
        return cls(op.block_cols, op.blocks, bandwidth, mesh, axis,
                   backend=backend)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def shape(self):
        n = self._nbr * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.mesh.device

    def _window(self, rows: int, m: int, dtype):
        """The push route's window, opened or regrown (collectively) to
        hold (rows, m) of ``dtype`` a slot."""
        need = kernels.window_slot_bytes(rows, m, dtype)
        window = self._push["window"]
        if window is None or window.slot_bytes < need:
            cap = need
            if window is not None:
                cap = max(need, 2 * window.slot_bytes)
                self.mesh.close_window(window)
            self._push["window"] = window = self.mesh.open_window(cap)
        return window

    def _apply_push(self, x, blocks):
        """The ``"push"`` route's apply of ``x`` (the compute type): one
        launch that pushes the halos and computes (Y in the accumulation
        type), a push fault of its window raised by name where its CUDA
        error surfaces."""
        window = self._push["window"]
        with kernels.halo_push_faults(() if window is None else (window,)):
            window = self._window(self.bandwidth * self.block_size,
                                  x.shape[1], x.dtype)
            return self.mesh.ring_push(blocks, x, window, self.bandwidth)

    def _apply_exchange(self, x, blocks):
        """The ``"exchange"`` route's apply of ``x`` (the compute type):
        start the ring exchange, launch the interior block rows while it
        runs, make the stream wait on it, launch the edge rows into the
        same output (Y in the accumulation type). No host sync."""
        bw = self.bandwidth
        from_prev, from_next, works = self.mesh.ring_exchange(
            x, bw * self.block_size)
        args = (blocks, x, from_prev, from_next)
        y = torch.empty(x.shape, dtype=kernels.acc_dtype(x.dtype),
                        device=x.device)
        kernels.banded_remote_halo_spmm(*args, bandwidth=bw, rows="interior",
                                        out=y)
        for work in works:
            work.wait()
        return kernels.banded_remote_halo_spmm(*args, bandwidth=bw,
                                               rows="edge", out=y)

    def _matmat_remote(self, block, compute):
        """Kernel 8 (``"pallas-remote"``) on the operator's ``route``."""
        # Cast before the send, so the halos travel in the compute type.
        x = block.to(compute).contiguous()
        blocks = self.blocks.to(compute)
        apply = (self._apply_push if self.route == "push"
                 else self._apply_exchange)
        return apply(x, blocks).to(block.dtype)

    def matmat(self, block):
        nbr_l, bs, kbs = self.blocks.shape
        K = kbs // bs
        bw = self.bandwidth
        m = block.shape[1]
        # Mixed precision as BSROperator.matmat: the narrower type.
        compute = (self.dtype if self.dtype.itemsize < block.dtype.itemsize
                   else block.dtype)
        if self.backend == "pallas-remote":
            return self._matmat_remote(block, compute)
        if self.backend == "pallas":
            # Cast before the send, so the halos travel in the compute type.
            x_ext = _extended(self.mesh, block.to(compute), bw * bs)
            return kernels.banded_ext_bsr_spmm(
                self.blocks.to(compute), x_ext, bandwidth=bw,
                out_dtype=block.dtype)
        from_prev, from_next = _exchange(self.mesh, block, bw * bs)
        # Interior contraction over the block columns this rank owns,
        # then the halo contraction over the 2*bw received blocks
        # (fortran_davidson_tpu/parallel/halo.py:139-172).
        blks = self.blocks.to(block.dtype)
        local = self.block_cols.long() - self.mesh.rank * nbr_l
        is_local = (local >= 0) & (local < nbr_l)
        xb = block.reshape(nbr_l, bs, m)
        gi = xb[local.clamp(0, nbr_l - 1)] * is_local[:, :, None, None].to(
            block.dtype)
        out = torch.bmm(blks, gi.reshape(nbr_l, K * bs, m))
        xh = torch.cat([from_prev, from_next]).reshape(2 * bw, bs, m)
        halo_idx = torch.where(local < 0, local + bw, local - nbr_l + bw)
        gh = xh[halo_idx.clamp(0, 2 * bw - 1)] * (~is_local)[
            :, :, None, None].to(block.dtype)
        out = out + torch.bmm(blks, gh.reshape(nbr_l, K * bs, m))
        return out.reshape(nbr_l * bs, m)

    def diagonal(self):
        return block_diagonal(self.blocks, self.block_cols,
                              self.mesh.rank * self.blocks.shape[0])

    def offdiag(self) -> "HaloBSROperator":
        """Exact off-diagonal split of the rank's rows."""
        nbr_l, bs, kbs = self.blocks.shape
        own = self.block_cols == (self.mesh.rank * nbr_l + torch.arange(
            nbr_l, dtype=torch.int32, device=self.device))[:, None]
        j = torch.arange(kbs, device=self.device)
        in_block_diag = (torch.arange(bs, device=self.device)[:, None]
                         == (j % bs)[None, :])
        mask = own[:, None, j // bs] & in_block_diag[None]
        out = object.__new__(HaloBSROperator)
        out.__dict__.update(self.__dict__,
                            blocks=torch.where(mask, 0, self.blocks))
        return out


class HaloQuantizedOperator(LinearOperator):
    """Row-sharded int8-quantized banded operator (halo exchange).

    The distributed face of
    :class:`~fortran_davidson_tpu_torch.ops.sparse.QuantizedBandedOperator`:
    the rank's int8 off-diagonal blocks, per-slot float32 scales and exact
    float32 diagonal; the apply exchanges only the ``bandwidth * bs``
    boundary rows and contracts the halo-extended slab, through kernel 7
    (``"pallas"``, the default) or the dequantized product (``"xla"``).
    Same accuracy contract as the single-device operator (bf16-class;
    diagonal and ``offdiag`` exact). With ``n_block_rows`` (the global
    count) the tables are the rank's rows already
    (``ops.sparse.banded_bsr_quantized_rows``).
    """

    def __init__(self, qblocks, scale_rows, diag, bandwidth: int,
                 mesh: RowMesh, axis: str = ROWS_AXIS,
                 backend: str = "pallas", *,
                 n_block_rows: Optional[int] = None):
        held, bs, kbs = qblocks.shape
        nbr = held if n_block_rows is None else int(n_block_rows)
        nbr_local = _check_slab(nbr, bandwidth, mesh, axis)
        require(kbs == (2 * bandwidth + 1) * bs, OperatorError,
                "quantized halo needs DIA-aligned K == 2*bw+1 slots")
        require(backend in ("xla", "pallas"), OperatorError,
                f"unknown backend {backend!r}")
        rows = own_rows(held, n_block_rows, mesh, nbr_local)
        self.qblocks = local_rows(qblocks, rows, mesh.device).to(torch.int8)
        self.scale_rows = local_rows(scale_rows, rows, mesh.device).to(
            torch.float32)
        self.diag = local_rows(diag, rows, mesh.device).to(torch.float32)
        self.bandwidth = int(bandwidth)
        self.mesh = mesh
        self.axis = axis
        self.backend = backend
        self._nbr = nbr

    @classmethod
    def from_quantized(cls, op, mesh: RowMesh, axis: str = ROWS_AXIS,
                       backend: str = "pallas") -> "HaloQuantizedOperator":
        """Distribute a single-device ``QuantizedBandedOperator``."""
        return cls(op.qblocks, op.scale_rows, op.diag, op.bandwidth, mesh,
                   axis, backend=backend)

    # -- LinearOperator -------------------------------------------------
    @property
    def block_size(self) -> int:
        return self.qblocks.shape[1]

    @property
    def shape(self):
        n = self._nbr * self.block_size
        return (n, n)

    @property
    def dtype(self):
        return self.scale_rows.dtype

    @property
    def device(self):
        return self.mesh.device

    def matmat(self, block):
        bw, bs = self.bandwidth, self.block_size
        x_ext = _extended(self.mesh, block, bw * bs)
        apply = (kernels.banded_q_ext_bsr_spmm if self.backend == "pallas"
                 else kernels.banded_q_ext_bsr_spmm_plain)
        return apply(self.qblocks, self.scale_rows, self.diag, x_ext,
                     bandwidth=bw, out_dtype=block.dtype)

    def diagonal(self):
        return self.diag.reshape(-1)

    def offdiag(self) -> "HaloQuantizedOperator":
        """Exact: the diagonal is stored separately; zero it."""
        out = object.__new__(HaloQuantizedOperator)
        out.__dict__.update(self.__dict__, diag=torch.zeros_like(self.diag))
        return out
