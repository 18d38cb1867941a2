"""The process group of a row-sharded solve (counterpart of
``fortran_davidson_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and lets
GSPMD place rows and insert collectives. PyTorch's idiom is SPMD over
``torch.distributed``: one process per device, every process runs the
same program on its own contiguous slice of the rows, and the reductions
over rows are explicit collectives (NCCL on GPUs, gloo on the CPU). A
:class:`RowMesh` names that group, this process's rank in it and its
device. Conventions, as in the JAX package:

- the distribution axis is named ``"rows"``; rank ``r`` of ``size`` holds
  rows ``[r * n / size, (r + 1) * n / size)`` of every tall array;
- the subspace axis is never sharded: the small Gram matrices and the
  projected eigenproblem are all-reduced and solved on every rank.

``replicated`` has no counterpart to place: every rank computes the small
matrices from all-reduced sums and holds all of them. It is kept, as the
whole-range slice, for code written against the JAX API.

Every collective of the port is one of :class:`RowMesh`'s three methods
(``all_reduce``, ``all_gather_rows``, ``ring_exchange``), so each of them
also appends a :class:`Collective` to the inventories that
``parallel.scaling.record_collectives`` holds open.
"""

from __future__ import annotations

import contextvars
import dataclasses
import math
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from fortran_davidson_tpu_torch.utils.dtypes import default_device
from fortran_davidson_tpu_torch.utils.errors import OperatorError, require

ROWS_AXIS = "rows"


class Collective(NamedTuple):
    """One collective call, as an inventory records it.

    ``kind`` is the JAX HLO op's name (``"all-reduce"``, ``"all-gather"``,
    ``"collective-permute"``); ``bytes`` the payload one rank moves: an
    all-reduce's tensor, an all-gather's result, a permute's sent rows
    (``fortran_davidson_tpu/parallel/scaling.py:75-80``); ``moved`` is
    False where one rank makes no transfer (at world size 1, or a call
    that one rank skips) but N >= 2 ranks would.
    """

    kind: str
    bytes: int
    dtype: torch.dtype
    shape: tuple
    moved: bool


# The inventories open in this context (``parallel.scaling``).
_INVENTORIES: contextvars.ContextVar = contextvars.ContextVar(
    "collective_inventories", default=())


def _record(kind: str, dtype, shape, moved: bool) -> None:
    inventories = _INVENTORIES.get()
    if inventories:
        shape = tuple(int(d) for d in shape)
        rec = Collective(kind, math.prod(shape) * dtype.itemsize, dtype,
                         shape, moved)
        for records in inventories:
            records.append(rec)


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One process group over which the rows are partitioned (hashable)."""

    group: object        # torch.distributed ProcessGroup
    size: int
    rank: int
    device: torch.device
    axis: str = ROWS_AXIS

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows."""
        require(n % self.size == 0, OperatorError,
                f"{n} rows not divisible by the {self.size}-rank mesh")
        n_local = n // self.size
        return slice(self.rank * n_local, (self.rank + 1) * n_local)

    def all_reduce(self, t):
        """Sum ``t`` over the ranks, in place where ``t`` is contiguous;
        every rank gets the same bits."""
        t = t.contiguous()
        _record("all-reduce", t.dtype, t.shape, self.size > 1)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_gather_rows(self, t):
        """The ranks' ``t`` (same shape on each) stacked along rows, in
        rank order."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _record("all-gather", t.dtype, out.shape, self.size > 1)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(out, t, group=self.group)
        return out

    def barrier(self) -> None:
        """Wait for every rank of the group (nothing to wait for alone)."""
        if self.size == 1:
            return
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def ring_exchange(self, x, halo: int):
        """``(from_prev, from_next, works)``: the last ``halo`` rows of the
        ring predecessor's ``x`` and the first ``halo`` rows of its
        successor's, by ring-neighbour point-to-point: O(halo · m) per rank
        at any world size.

        At world size 1 the ring's neighbour is the rank itself (JAX's
        ``ppermute`` with the pair (0, 0)) and ``torch.distributed`` refuses
        a send to oneself: the halos are the views ``x[-halo:]`` and
        ``x[:halo]``, and ``works`` is empty. Above, they are fresh buffers
        that are valid once every work of ``works`` is waited on (on NCCL,
        ``wait()`` makes the current stream wait, not the host). Every rank
        issues the four operations in one order with the default tag: send
        its bottom rows right, its top rows left, receive ``from_prev`` from
        the left, ``from_next`` from the right. At world size 2 the
        predecessor is the successor, and NCCL pairs the messages between
        two ranks by issue order, so the one order keeps the halos from
        coming back swapped. Peers are ranks of the default group, which
        is the mesh's group (:func:`default_mesh`).
        """
        x = x.contiguous()
        # The two sends of every rank (JAX's two ``ppermute``s), recorded
        # at world size 1 too, where they are views.
        for _ in range(2):
            _record("collective-permute", x.dtype, (halo, *x.shape[1:]),
                    self.size > 1)
        if self.size == 1:
            return x[-halo:], x[:halo], []
        left = (self.rank - 1) % self.size
        right = (self.rank + 1) % self.size
        from_prev = torch.empty((halo, *x.shape[1:]), dtype=x.dtype,
                                device=x.device)
        from_next = torch.empty_like(from_prev)
        ops = [dist.P2POp(dist.isend, x[-halo:], right, self.group),
               dist.P2POp(dist.isend, x[:halo], left, self.group),
               dist.P2POp(dist.irecv, from_prev, left, self.group),
               dist.P2POp(dist.irecv, from_next, right, self.group)]
        return from_prev, from_next, dist.batch_isend_irecv(ops)


def mesh_device(device=None, rank: int = 0) -> torch.device:
    """The device of ``rank``: ``device`` when it names one, else the GPU
    of the launcher's ``LOCAL_RANK`` (by default ``rank`` modulo the
    visible GPUs). Without a GPU and without ``device`` it raises
    ``DeviceUnavailableError``."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = int(local) if local is not None else (
            rank % torch.cuda.device_count())
        dev = torch.device("cuda", index)
    return dev


def default_mesh(n_devices: Optional[int] = None, axis: str = ROWS_AXIS,
                 device=None) -> RowMesh:
    """The mesh over the default process group, one device per rank.

    The group must be up (:func:`~.multihost.initialize`, or
    ``torch.distributed.init_process_group``). ``n_devices``, when given,
    must equal its size: a rank cannot lend its device to a smaller mesh.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "default_mesh needs a torch.distributed process group: call "
            "parallel.multihost.initialize() first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices; the process group "
                         f"has {size} ranks of one device each")
    return RowMesh(group=dist.group.WORLD, size=size, rank=rank,
                   device=mesh_device(device, rank), axis=axis)


def row_sharding(mesh: RowMesh, n: int) -> slice:
    """The rows of an ``n``-row tall array that this rank holds."""
    return mesh.rows(n)


def replicated(mesh: RowMesh) -> slice:
    """The rows of a replicated array that a rank holds: all of them."""
    return slice(None)
