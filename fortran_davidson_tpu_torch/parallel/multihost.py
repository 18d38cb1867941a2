"""Process-group start-up and the global mesh (counterpart of
``fortran_davidson_tpu/parallel/multihost.py``).

Every process of a job runs the same program:

    from fortran_davidson_tpu_torch.parallel import multihost
    mesh = multihost.initialize()            # torch.distributed + mesh
    res = eigensolve_sharded(A, k, mesh)     # collectives over NCCL

launched for instance with ``torchrun --nproc_per_node=N script.py``,
which sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK``. :func:`initialize` is idempotent, and in a single process
with none of that environment it starts a one-rank group on an
in-process store, so library code can call it unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fortran_davidson_tpu_torch.parallel.mesh import (ROWS_AXIS, RowMesh,
                                                      default_mesh,
                                                      mesh_device)


def _multiprocess_env_hints() -> list:
    """Environment evidence that this process is one of several (so a
    group that does not come up is a misconfiguration, not a single
    process)."""
    hints = []
    for name in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE",
                 "PMI_SIZE"):
        val = os.environ.get(name)
        if val and val.isdigit() and int(val) > 1:
            hints.append(name)
    return hints


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None,
               axis: str = ROWS_AXIS) -> RowMesh:
    """Start the default process group (once) and return the global mesh.

    Args:
      init_method: a ``torch.distributed`` init URL (``"env://"``,
        ``"file://..."``, ``"tcp://host:port"``); by default the
        launcher's environment (``env://``).
      world_size, rank: by default ``WORLD_SIZE`` and ``RANK`` (1 and 0).
      device: the mesh's device; by default this rank's GPU
        (``LOCAL_RANK``). The backend is NCCL for a GPU, gloo otherwise.

    Raises ``RuntimeError`` when the environment says this is one process
    of several and the group does not come up: it never falls back to a
    local group, whose collectives would silently disagree with the
    other processes'.
    """
    if not dist.is_initialized():
        world = (int(os.environ.get("WORLD_SIZE", "1")) if world_size is None
                 else int(world_size))
        rk = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
        dev = mesh_device(device, rk)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if (init_method is None and world == 1
                and "MASTER_ADDR" not in os.environ):
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            try:
                dist.init_process_group(backend,
                                        init_method=init_method or "env://",
                                        world_size=world, rank=rk)
            except (ValueError, RuntimeError) as exc:
                hints = _multiprocess_env_hints()
                if world > 1 or hints:
                    raise RuntimeError(
                        "torch.distributed.init_process_group failed in what "
                        f"looks like a multi-process launch (world size "
                        f"{world}{'; ' + '/'.join(hints) if hints else ''} "
                        "set); refusing to fall back to a local group") from exc
                raise
    return default_mesh(axis=axis, device=device)


def is_coordinator() -> bool:
    """True on the process that should write checkpoints and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(axis: str = ROWS_AXIS, device=None) -> RowMesh:
    """The mesh over every rank of the job (all hosts)."""
    return default_mesh(axis=axis, device=device)
