"""The rank processes of the port's row-sharded tests
(``tests/test_torch_parallel.py``).

:func:`spawn` starts ``world`` CPU processes joined in one gloo group
(a ``file://`` rendezvous in the run's directory, never a fixed port),
and each runs every check of the run on its rows: the halo operators'
applies, diagonals and off-diagonal splits, and the sharded solves. The
inputs come from the parent as ``inputs.npz``; each rank writes what it
computed to ``rank<r>.npz``, and the parent compares with the JAX package.

A spawned process imports the module of its target, and the test
modules and ``tests/conftest.py`` import JAX: this module imports only
numpy, torch and the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.multiprocessing as mp

# Bandwidths of the banded (f64) and int8 tables of the halo checks.
HALO_BANDS = (1, 2)
INT8_BANDS = (1, 2)
# The sharded solves: name -> (lowest, options).
F64 = dict(tolerance=1e-8)
INT8 = dict(tolerance=1e-3, dtype="float32", relative_tolerance=True)
SOLVES = {
    "dense": (3, F64),
    "pencil": (2, F64),
    "halo_pallas": (3, F64),
    "bsr": (3, F64),
    "int8": (3, INT8),
    "warm": (3, F64),
}


def spawn(world: int, run_dir: str) -> list:
    """Run every check at ``world`` ranks; returns each rank's results."""
    mp.spawn(_rank_main, args=(world, run_dir), nprocs=world, join=True)
    out = []
    for rank in range(world):
        with np.load(os.path.join(run_dir, f"rank{rank}.npz")) as f:
            out.append(dict(f))
    return out


def banded(inputs, tag: str):
    """The global CPU ``BSROperator`` of the tables ``tag``."""
    from fortran_davidson_tpu_torch import convert
    return convert.bsr(inputs[f"{tag}_cols"], inputs[f"{tag}_blocks"],
                       bandwidth=int(inputs[f"{tag}_bw"]), device="cpu")


def quantized(inputs, tag: str):
    """The global CPU ``QuantizedBandedOperator`` of the tables ``tag``."""
    from fortran_davidson_tpu_torch import convert
    return convert.quantized(inputs[f"{tag}_q"], inputs[f"{tag}_scale"],
                             inputs[f"{tag}_diag"], int(inputs[f"{tag}_bw"]),
                             device="cpu")


def solve_cases(inputs, mesh=None) -> dict:
    """name -> (A, B, X0) of every solve case. With ``mesh``, the halo case
    is the ``HaloBSROperator`` on it; without, the global operator."""
    from fortran_davidson_tpu_torch import convert
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator

    A = convert.dense(inputs["A"], device="cpu")
    halo = banded(inputs, "solve_halo")
    if mesh is not None:
        halo = HaloBSROperator.from_bsr(halo, halo.bandwidth, mesh,
                                        backend="pallas")
    return {
        "dense": (A, None, None),
        "pencil": (A, convert.dense(inputs["B"], device="cpu"), None),
        "halo_pallas": (halo, None, None),
        "bsr": (banded(inputs, "solve_bsr"), None, None),
        "int8": (quantized(inputs, "solve_int8"), None, None),
        "warm": (A, None, torch.from_numpy(inputs["X0"])),
    }


def _rank_main(rank: int, world: int, run_dir: str) -> None:
    torch.set_num_threads(1)
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     eigensolve_sharded,
                                                     multihost, shard_operator)

    init = "file://" + os.path.join(run_dir, "rendezvous")
    mesh = multihost.initialize(init_method=init, world_size=world, rank=rank,
                                device="cpu")
    # Idempotent: a second call returns the same mesh, no second group.
    assert multihost.initialize(device="cpu") == mesh
    with np.load(os.path.join(run_dir, "inputs.npz")) as f:
        inputs = dict(f)
    out = {}
    X = torch.from_numpy(inputs["X"][mesh.rows(inputs["X"].shape[0])])
    for bw in HALO_BANDS:
        op = banded(inputs, f"halo{bw}")
        for backend in ("xla", "pallas"):
            h = HaloBSROperator.from_bsr(op, bw, mesh, backend=backend)
            out[f"halo{bw}_{backend}_y"] = h.matmat(X).numpy()
            out[f"halo{bw}_{backend}_diag"] = h.diagonal().numpy()
            out[f"halo{bw}_{backend}_offdiag_y"] = \
                h.offdiag().matmat(X).numpy()
    Xq = torch.from_numpy(inputs["Xq"][mesh.rows(inputs["Xq"].shape[0])])
    for bw in INT8_BANDS:
        q = quantized(inputs, f"int8_{bw}")
        hq = shard_operator(q, mesh)
        assert isinstance(hq, HaloQuantizedOperator) and hq.backend == "pallas"
        for backend in ("xla", "pallas"):
            h = HaloQuantizedOperator.from_quantized(q, mesh, backend=backend)
            out[f"int8_{bw}_{backend}_y"] = h.matmat(Xq).numpy()
        out[f"int8_{bw}_diag"] = hq.diagonal().numpy()
        # The split is exact: A x = offdiag(A) x + diag(A) ∘ x.
        out[f"int8_{bw}_split_y"] = (hq.offdiag().matmat(Xq)
                                     + hq.diagonal()[:, None] * Xq).numpy()

    for name, (A, B, X0) in solve_cases(inputs, mesh).items():
        lowest, opts = SOLVES[name]
        res = eigensolve_sharded(A, lowest, mesh, second_matrix=B,
                                 initial_vectors=X0, **opts)
        out[f"{name}_evals"] = res.eigenvalues.numpy()
        out[f"{name}_evecs"] = res.eigenvectors.numpy()
        out[f"{name}_iterations"] = np.array(res.iterations)
        out[f"{name}_converged"] = np.array(res.converged)
    np.savez(os.path.join(run_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
