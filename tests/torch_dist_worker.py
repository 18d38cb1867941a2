"""The rank processes of the port's row-sharded tests
(``tests/test_torch_parallel.py``).

:func:`spawn` starts ``world`` CPU processes joined in one gloo group
(a ``file://`` rendezvous in the run's directory, never a fixed port),
and each runs every check of the run on its rows: the halo operators'
applies, diagonals and off-diagonal splits, and the sharded solves. The
inputs come from the parent as ``inputs.npz``; each rank writes what it
computed to ``rank<r>.npz``, and the parent compares with the JAX package.
At world sizes 1 and 2 (``SPARSE_WORLDS``) the ranks also apply and solve
the ELL family's sharded operators.

A spawned process imports the module of its target, and the test
modules and ``tests/conftest.py`` import JAX: this module imports only
numpy, torch and the port.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Bandwidths of the banded (f64) and int8 tables of the halo checks.
HALO_BANDS = (1, 2)
INT8_BANDS = (1, 2)
HALO_BACKENDS = ("xla", "pallas", "pallas-remote")
# Halo heights (rows) of the exchange checks on the small table's X: at
# world size 4 a rank holds 16 rows, so 16 is the whole neighbour slab.
RING_HALOS = (8, 16)
# The collectives counted around one apply (those that this build of
# torch.distributed has); the point-to-point operations are counted inside
# batch_isend_irecv by kind.
GATHERS = ("all_gather_single", "all_gather_into_tensor", "all_gather")
COUNTED = (*GATHERS, "all_reduce", "reduce_scatter_tensor", "broadcast",
           "send", "recv", "isend", "irecv")
# The sharded solves: name -> (lowest, options).
F64 = dict(tolerance=1e-8)
INT8 = dict(tolerance=1e-3, dtype="float32", relative_tolerance=True)
# int8 storage in the default float64: the apply's sums round to float32,
# so the solve runs at 1e-6, not 1e-8.
INT8_F64 = dict(tolerance=1e-6, relative_tolerance=True)
SOLVES = {
    "dense": (3, F64),
    "pencil": (2, F64),
    "halo_pallas": (3, F64),
    "bsr": (3, F64),
    "int8": (3, INT8),
    "int8_f64": (3, INT8_F64),
    "warm": (3, F64),
    "halo_remote": (3, F64),
    "remote_f32": (3, dict(tolerance=1e-5, dtype="float32")),
    # GJD: MINRES's column norms and dots summed over the ranks.
    "gjd": (3, dict(method="GJD", tolerance=1e-8)),
    "gjd_warm": (3, dict(method="GJD", tolerance=1e-8, gjd_warm_start=True)),
    "gjd_halo": (3, dict(method="GJD", tolerance=1e-8,
                         gjd_preconditioner="dpr")),
}


# The ELL family's sharding rules (ELL, sliced ELL through to_ell, the
# hybrid's band through kernel 2 and its remainder through the ELL rule),
# checked at world sizes 1 and 2: name -> (lowest, options).
SPARSE_WORLDS = (1, 2)
SPARSE_SOLVES = {"ell": (3, F64), "sell": (3, F64), "hybrid": (3, F64)}
# The sharded operator each rule gives.
SPARSE_KINDS = {"ell": "ShardedELLOperator", "sell": "ShardedELLOperator",
                "hybrid": "ShardedHybridOperator"}


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
    """name -> (A, B, X0) of every solve case. With ``mesh``, the halo cases
    are ``HaloBSROperator``s on it; without, the global operators."""
    from fortran_davidson_tpu_torch import convert
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator

    def halo(tag, backend):
        op = banded(inputs, tag)
        return op if mesh is None else HaloBSROperator.from_bsr(
            op, op.bandwidth, mesh, backend=backend)

    A = convert.dense(inputs["A"], device="cpu")
    return {
        "dense": (A, None, None),
        "pencil": (A, convert.dense(inputs["B"], device="cpu"), None),
        "halo_pallas": (halo("solve_halo", "pallas"), None, None),
        "bsr": (banded(inputs, "solve_bsr"), None, None),
        "int8": (quantized(inputs, "solve_int8"), None, None),
        "int8_f64": (quantized(inputs, "solve_int8"), None, None),
        "warm": (A, None, torch.from_numpy(inputs["X0"])),
        "halo_remote": (halo("solve_halo", "pallas-remote"), None, None),
        "remote_f32": (halo("solve_remote", "pallas-remote"), None, None),
        "gjd": (A, None, None),
        "gjd_warm": (A, None, None),
        "gjd_halo": (halo("solve_halo", "pallas"), None, None),
    }


def sparse_cases(inputs) -> dict:
    """name -> the global CPU operator of each SPARSE_SOLVES case, built
    from the COO triplets ``coo_*`` (the hybrid padded to an even number
    of block rows, for two ranks)."""
    import fortran_davidson_tpu_torch as fdtt
    coo = (inputs["coo_rows"], inputs["coo_cols"], inputs["coo_vals"],
           int(inputs["coo_n"]))
    return {
        "ell": fdtt.ELLOperator.from_coo(*coo, device="cpu"),
        "sell": fdtt.SlicedELLOperator.from_coo(*coo, device="cpu"),
        "hybrid": fdtt.split_band_remainder(*coo, block_size=16, bandwidth=1,
                                            block_rows_multiple=2,
                                            device="cpu"),
    }


@contextlib.contextmanager
def counting_collectives():
    """Count the calls of ``torch.distributed``'s collectives (COUNTED) in
    the ``with`` block, and the operations that go through
    ``batch_isend_irecv`` by kind (``isend``, ``irecv``)."""
    counts = dict.fromkeys(COUNTED, 0)
    names = [n for n in COUNTED
             if n not in ("isend", "irecv") and hasattr(dist, n)]
    saved = {n: getattr(dist, n) for n in names + ["batch_isend_irecv"]}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    def batch(ops):
        for op in ops:
            counts[op.op.__name__] += 1
        return saved["batch_isend_irecv"](ops)

    for n in names:
        setattr(dist, n, counted(n, saved[n]))
    dist.batch_isend_irecv = batch
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _rank_main(rank: int, world: int, run_dir: str) -> None:
    torch.set_num_threads(1)
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     eigensolve_sharded,
                                                     multihost, shard_operator)
    from fortran_davidson_tpu_torch.parallel.halo import halo_slabs

    init = "file://" + os.path.join(run_dir, "rendezvous")
    mesh = multihost.initialize(init_method=init, world_size=world, rank=rank,
                                device="cpu")
    # Idempotent: a second call returns the same mesh, no second group.
    assert multihost.initialize(device="cpu") == mesh
    with np.load(os.path.join(run_dir, "inputs.npz")) as f:
        inputs = dict(f)
    out = {}
    def local(name):
        return torch.from_numpy(inputs[name][mesh.rows(inputs[name].shape[0])])

    X = local("X")
    for bw in HALO_BANDS:
        op = banded(inputs, f"halo{bw}")
        for backend in HALO_BACKENDS:
            h = HaloBSROperator.from_bsr(op, bw, mesh, backend=backend)
            with counting_collectives() as calls:
                out[f"halo{bw}_{backend}_y"] = h.matmat(X).numpy()
            out[f"halo{bw}_{backend}_calls"] = np.array(
                [calls[n] for n in COUNTED])
            out[f"halo{bw}_{backend}_diag"] = h.diagonal().numpy()
            out[f"halo{bw}_{backend}_offdiag_y"] = \
                h.offdiag().matmat(X).numpy()
    # Kernel 8 in float32, and on slabs of 2·bw block rows or fewer (every
    # row an edge row; at world size 4 the halo is the whole neighbour
    # slab).
    for tag, name in (("remote32", "X32"), ("tiny2", "Xs")):
        h = HaloBSROperator.from_bsr(banded(inputs, tag),
                                     int(inputs[f"{tag}_bw"]), mesh,
                                     backend="pallas-remote")
        out[f"{tag}_y"] = h.matmat(local(name)).numpy()
    Xs = local("Xs")
    for halo in RING_HALOS:
        from_prev, from_next, works = mesh.ring_exchange(Xs, halo)
        for work in works:
            work.wait()
        slabs = halo_slabs(mesh, Xs, halo)
        out[f"ring{halo}"] = torch.cat([from_prev, from_next]).numpy()
        out[f"slabs{halo}"] = torch.cat(slabs).numpy()
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

    if world in SPARSE_WORLDS:
        for name, op in sparse_cases(inputs).items():
            sharded = shard_operator(op, mesh)
            assert type(sharded).__name__ == SPARSE_KINDS[name]
            X = inputs["Xsp"][:op.shape[0]]
            with counting_collectives() as calls:
                out[f"sparse_{name}_y"] = sharded.matmat(torch.from_numpy(
                    X[mesh.rows(X.shape[0])])).numpy()
            out[f"sparse_{name}_gathers"] = np.array(
                sum(calls[n] for n in GATHERS))
            out[f"sparse_{name}_diag"] = sharded.diagonal().numpy()
            lowest, opts = SPARSE_SOLVES[name]
            res = eigensolve_sharded(op, lowest, mesh, **opts)
            out[f"sparse_{name}_evals"] = res.eigenvalues.numpy()
            out[f"sparse_{name}_evecs"] = res.eigenvectors.numpy()
            out[f"sparse_{name}_iterations"] = np.array(res.iterations)
            out[f"sparse_{name}_converged"] = np.array(res.converged)

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
