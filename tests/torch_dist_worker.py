"""The rank processes of the port's row-sharded tests
(``tests/test_torch_parallel.py``).

:func:`spawn` starts ``world`` CPU processes joined in one gloo group
(a ``file://`` rendezvous in the run's directory, never a fixed port),
and each runs every check of the run on its rows: the halo operators'
applies, diagonals and off-diagonal splits, and the sharded solves. The
inputs come from the parent as ``inputs.npz``; each rank writes what it
computed to ``rank<r>.npz``, and the parent compares with the JAX package.
At world sizes 1 and 2 (``SPARSE_WORLDS``) the ranks also apply and solve
the ELL family's sharded operators, run the sharded refined path
(``REFINED_SOLVES``) and checkpoint and resume sharded solves
(``CKPT_WORLDS``); at world size 2 a checkpoint also moves between world
sizes (a one-rank group of rank 0 and the two ranks). At world sizes 1
and 2 (``FREE_WORLDS``) they apply and solve the matrix-free operators
through their per-rank callables, polish a sharded result
(``polish_eigenpairs(mesh=...)``) and orthonormalize a block with zero
columns by the TSQR; every halo apply is also repeated with the halos
moved by :func:`all_gather_halos`, the all-gather form the ring exchange
replaced. At every world size they also take the collective inventory of
one iteration of the scaling probe (``parallel.scaling``) at two row
counts, and fold the double-single reductions of a tall block over their
rows; at world size 2 they take the inventory of the ELL rule, which
gathers x, and at world size 1 they solve the float32 surrogate past the
cascade's threshold (``scaling_cases``). At world sizes 2 and 4
(``ROWS_WORLDS``) they solve on operators built from each rank's own
rows beside the same operators cut from the global tables
(``rows_cases``).

A spawned process imports the module of its target, and the test
modules and ``tests/conftest.py`` import JAX: this module imports only
numpy, torch and the port.
"""

from __future__ import annotations

import contextlib
import json
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
    # orthonormalization="qr": the TSQR of row-sharded blocks.
    "qr": (3, dict(tolerance=1e-8, orthonormalization="qr")),
    "qr_halo": (3, dict(tolerance=1e-8, orthonormalization="qr")),
}

# The matrix-free operators, row-sharded through their per-rank
# callables (``tests/test_parallel.py:100``), at world sizes 1 and 2:
# name -> (lowest, options) of the solves of the n = FREE_N operators
# (``free_cases``).
FREE_WORLDS = (1, 2)
FREE_N = 512
FREE_SOLVES = {"free": (3, F64), "free_pencil": (3, F64),
               "free_elem": (3, F64)}
# The polish of the sharded matrix-free refined solve.
POLISH_ITERATIONS = 2


# The ELL family's sharding rules (ELL, sliced ELL through to_ell, the
# hybrid's band through kernel 2 and its remainder through the ELL rule),
# checked at world sizes 1 and 2: name -> (lowest, options).
SPARSE_WORLDS = (1, 2)
SPARSE_SOLVES = {"ell": (3, F64), "sell": (3, F64), "hybrid": (3, F64)}
# The sharded operator each rule gives.
SPARSE_KINDS = {"ell": "ShardedELLOperator", "sell": "ShardedELLOperator",
                "hybrid": "ShardedHybridOperator"}

# Chebyshev-filtered restarts ("auto" degree) with locking on the dense
# ``Ac``, at world size 2: every rank must take the same bound, degrees
# and operator applies as the single-device solve.
CHEB_WORLDS = (2,)
CHEB = (3, dict(cheb_degree="auto", locking=True, expansion="lowest-k",
                max_dim_sub=12, tolerance=1e-8))

# The sharded refined path (``tests/test_parallel.py:247-277``, cut to a
# few thousand rows): name -> (lowest, options). The float32 surrogate
# runs as its dense matrix and as the matrix-free operator itself (its
# per-rank callables); the banded BSR runs through kernel 2's sharded rule
# with an in-solve polish.
REFINED_WORLDS = (1, 2)
REFINED_SURROGATE = dict(method="DPR", tolerance=1e-6,
                         relative_tolerance=True, max_iterations=40,
                         dtype="float32", expansion="lowest-k", refined=True)
REFINED_SOLVES = {
    "refined_surrogate": (4, REFINED_SURROGATE),
    "refined_free": (4, REFINED_SURROGATE),
    "refined_bsr": (3, dict(method="DPR", tolerance=1e-6, dtype="float32",
                            refined=True, final_polish=2,
                            max_iterations=200)),
}
# Sharded checkpoints (``tests/test_checkpoint.py:104-142, 214-247``):
# the dense ``A`` every 2 iterations, and the n=512 float32 refined solve
# every 4; name -> (input, lowest, every, options).
CKPT_WORLDS = (1, 2)
CKPT_SOLVES = {
    "ckpt": ("A", 3, 2, dict(tolerance=1e-8)),
    "ckpt_refined": ("A512", 3, 4, dict(dtype="float32", refined=True,
                                         tolerance=1e-6, max_iterations=80)),
}

# Sharded solves whose operators each rank builds from its own block
# rows (``ops.sparse.banded_bsr_rows``, ``banded_bsr_quantized_rows``,
# ``n_block_rows=``), beside the same solves on operators cut from the
# global tables, at world sizes 2 and 4 (``rows_cases``): name -> (lowest,
# options). "pallas-remote" takes the exchange route on CPU ranks.
ROWS_WORLDS = (2, 4)
ROWS_NBR = 64
ROWS_SEED = 9
ROWS_SOLVES = {"rows_remote": (3, F64), "rows_int8": (3, INT8)}

# The scaling audit (``tests/test_scaling_model.py``'s probe shape): one
# refined float32 iteration of the int8 halo probe at these block rows of
# SCALING_BS, at every world size.
SCALING_NBR = (64, 128)
SCALING_BS = 32
# The ELL rule's inventory at world size 2, at these row counts. Its
# options make m_max = 2k, so the gathered k-column block (2 * n_local * k
# rows) is one full local panel, the tall audit's cap, and n_local is past
# the cap's 32 m_max² floor.
GATHER_WORLDS = (2,)
GATHER_N = (4096, 8192)
GATHER = dict(lowest=20, init_dim=20, max_dim_sub=20, expansion="lowest-k",
              tolerance=1e-8)
# The double-single folds of a sharded rank on DS_N rows (past the
# cascade's threshold, with a ragged tail of its slab), at every world
# size; at TALL_WORLDS the refined surrogate solve of that order.
DS_N = 303_104
TALL_WORLDS = (1,)


class Interrupt(RuntimeError):
    """Raised by a callback after the first save: the process dying."""


def interrupt_once():
    """A chunk callback that raises at its first call only."""
    calls = []

    def callback(state):
        calls.append(state["it"])
        if len(calls) == 1:
            raise Interrupt
    return callback


def checkpoint_cases(inputs, mesh, run_dir: str, out: dict) -> None:
    """Each CKPT_SOLVES case on ``mesh``: uninterrupted, resumed from its
    complete directory, and interrupted after its first save then
    resumed. At world size 2, the ``ckpt`` case also moves a checkpoint
    from the two ranks to a one-rank mesh of rank 0, and from it to the
    two ranks."""
    from fortran_davidson_tpu_torch import convert, eigensolve_checkpointed
    from fortran_davidson_tpu_torch.parallel import RowMesh

    def solve(name, tag, callbacks=(), on=mesh):
        key, lowest, every, opts = CKPT_SOLVES[name]
        A = convert.dense(inputs[key], device="cpu")
        return eigensolve_checkpointed(
            A, lowest, os.path.join(run_dir, f"{name}_{tag}"), every=every,
            mesh=on, callbacks=callbacks, **opts)

    def record(prefix, res):
        out[f"{prefix}_evals"] = res.eigenvalues.numpy()
        out[f"{prefix}_iterations"] = np.array(res.iterations)
        out[f"{prefix}_converged"] = np.array(res.converged)
        out[f"{prefix}_operator_columns"] = np.array(res.operator_columns)

    for name in CKPT_SOLVES:
        record(name, solve(name, "full"))
        record(f"{name}_again", solve(name, "full"))
        try:
            solve(name, "cut", (interrupt_once(),))
        except Interrupt:
            out[f"{name}_cut_saved"] = np.array(sorted(os.listdir(
                os.path.join(run_dir, f"{name}_cut"))))
        record(f"{name}_resumed", solve(name, "cut"))
    if mesh.size != 2:
        return
    # Checkpoints across world sizes: a one-rank group of rank 0 (every
    # rank creates it; rank 1 is no member).
    group = dist.new_group([0])
    one = (RowMesh(group=group, size=1, rank=0, device=mesh.device)
           if mesh.rank == 0 else None)
    try:
        solve("ckpt", "2to1", (interrupt_once(),))
    except Interrupt:
        pass
    if one is not None:
        record("ckpt_2to1", solve("ckpt", "2to1", on=one))
        try:
            solve("ckpt", "1to2", (interrupt_once(),), on=one)
        except Interrupt:
            pass
    mesh.barrier()
    record("ckpt_1to2", solve("ckpt", "1to2"))


def all_gather_halos(mesh, x, halo: int):
    """``(from_prev, from_next)`` by one ``all_gather`` of every rank's
    ``2 * halo`` boundary rows: the exchange of the ``"xla"``,
    ``"pallas"`` and int8 halo operators before the ring exchange, kept
    as the reference the ring exchange must equal bit for bit."""
    edges = mesh.all_gather_rows(torch.cat([x[:halo], x[-halo:]]))
    edges = edges.reshape(mesh.size, 2 * halo, *x.shape[1:])
    return (edges[(mesh.rank - 1) % mesh.size, halo:],
            edges[(mesh.rank + 1) % mesh.size, :halo])


@contextlib.contextmanager
def all_gather_exchange():
    """The halo operators of the ``with`` block move their halos by
    :func:`all_gather_halos`."""
    from fortran_davidson_tpu_torch.parallel import halo
    saved = halo._exchange
    halo._exchange = all_gather_halos
    try:
        yield
    finally:
        halo._exchange = saved


def element(i, j):
    """The element function of the ``free_elem`` case (torch tensors):
    i + 1 on the diagonal, 1e-3 cos(0.01 (i + j)) off it."""
    return torch.where(i == j, 1.0 + i.double(),
                       1e-3 * torch.cos(0.01 * (i + j).double()))


def free_cases(n: int = FREE_N) -> dict:
    """name -> (A, B) of the matrix-free cases, global CPU operators."""
    from fortran_davidson_tpu_torch.models import generators as gen
    from fortran_davidson_tpu_torch.ops.operators import from_element_fn
    A = gen.surrogate_hamiltonian(n, device="cpu")
    return {"free": (A, None),
            "free_pencil": (A, gen.surrogate_overlap(n, device="cpu")),
            "free_elem": (from_element_fn(element, n, device="cpu"), None)}


def free_apply_ops(n: int = FREE_N) -> dict:
    """name -> a global CPU matrix-free operator whose applies are checked
    sharded: the surrogates, the element operator, the float32 surrogate
    (its double-single applies) and the surrogate without its diagonal
    (probed through the apply)."""
    from fortran_davidson_tpu_torch.models import generators as gen
    from fortran_davidson_tpu_torch.ops.operators import MatrixFreeOperator
    ops = {name: A for name, (A, _) in free_cases(n).items()
           if name != "free_pencil"}
    ops["overlap"] = free_cases(n)["free_pencil"][1]
    ops["free32"] = gen.surrogate_hamiltonian(n, dtype=torch.float32,
                                              device="cpu")
    A = ops["free"]
    ops["probed"] = MatrixFreeOperator(A.fn, n, dtype=A.dtype,
                                       captured=A.captured, device="cpu")
    return ops


def free_checks(inputs, mesh, refined, out: dict) -> None:
    """The sharded matrix-free applies and solves, the per-rank polish of
    the sharded refined result ``refined`` (REFINED_SOLVES'
    ``refined_free``) and the TSQR of a block with zero columns, on
    ``mesh``."""
    import dataclasses
    from fortran_davidson_tpu_torch import polish_eigenpairs
    from fortran_davidson_tpu_torch.core.orthogonal import orthonormalize_block
    from fortran_davidson_tpu_torch.parallel import (RowShardConstraint,
                                                     eigensolve_sharded,
                                                     shard_operator)
    X = torch.from_numpy(inputs["Xf"][mesh.rows(FREE_N)])
    for name, op in free_apply_ops().items():
        sharded = shard_operator(op, mesh)
        assert type(sharded).__name__ == "ShardedMatrixFreeOperator"
        x = X.to(op.dtype)
        out[f"fapply_{name}_y"] = sharded.matmat(x).numpy()
        out[f"fapply_{name}_diag"] = sharded.diagonal().numpy()
        out[f"fapply_{name}_offdiag_y"] = sharded.offdiag().matmat(x).numpy()
        if op.dtype == torch.float32:
            for tag, o in (("ds", sharded), ("offdiag_ds", sharded.offdiag())):
                ds = o.matmat_ds(x, x * 1e-8)
                if ds is not None:
                    out[f"fapply_{name}_{tag}"] = (ds[0].double()
                                                   + ds[1].double()).numpy()
    for name, (A, B) in free_cases().items():
        lowest, opts = FREE_SOLVES[name]
        res = eigensolve_sharded(A, lowest, mesh, second_matrix=B, **opts)
        out[f"{name}_evals"] = res.eigenvalues.numpy()
        out[f"{name}_evecs"] = res.eigenvectors.numpy()
        out[f"{name}_iterations"] = np.array(res.iterations)
        out[f"{name}_converged"] = np.array(res.converged)

    # The polish of the sharded matrix-free refined solve, from its rank
    # rows and from the gathered global vectors.
    op32, res = refined
    pol = polish_eigenpairs(op32, res, iterations=POLISH_ITERATIONS,
                            mesh=mesh)
    out.update(polish_evals=pol.evals.numpy(),
               polish_evals_lo=pol.evals_lo.numpy(),
               polish_errors=pol.errors.numpy(),
               polish_x=(pol.evecs_hi.double()
                         + pol.evecs_lo.double()).numpy(),
               polish_input=res.eigenvectors.numpy(),
               polish_input_evals=res.eigenvalues.numpy())
    whole = dataclasses.replace(
        res, eigenvectors=mesh.all_gather_rows(res.eigenvectors))
    pol_g = polish_eigenpairs(op32, whole, iterations=POLISH_ITERATIONS,
                              mesh=mesh)
    out["polish_global_same"] = np.array(
        torch.equal(pol_g.evecs_hi, pol.evecs_hi)
        and torch.equal(pol_g.evecs_lo, pol.evecs_lo)
        and torch.equal(pol_g.evals, pol.evals))

    # orthonormalize_block's "qr" branch on a block with zero columns.
    rows = mesh.rows(inputs["qr_block"].shape[0])
    q, alive = orthonormalize_block(
        torch.from_numpy(inputs["qr_V"][rows]),
        torch.from_numpy(inputs["qr_block"][rows]),
        torch.from_numpy(inputs["qr_mask"]), method="qr",
        rows=RowShardConstraint(mesh, inputs["qr_block"].shape[0]))
    out.update(qr_q=q.numpy(), qr_alive=alive.numpy())


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
        "qr": (A, None, None),
        "qr_halo": (halo("solve_halo", "pallas"), None, None),
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
def recording_degrees():
    """The filter degrees that ``chebyshev.auto_degree`` picks in the
    ``with`` block, in order."""
    from fortran_davidson_tpu_torch.core import chebyshev
    degrees, auto = [], chebyshev.auto_degree

    def record(*args, **kwargs):
        degrees.append(auto(*args, **kwargs))
        return degrees[-1]

    chebyshev.auto_degree = record
    try:
        yield degrees
    finally:
        chebyshev.auto_degree = auto


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


@contextlib.contextmanager
def counting_recorded_applies(cls):
    """Count the calls of ``cls.matmat`` made while a collective inventory
    is open (``parallel.scaling.record_collectives``): ``calls[0]``."""
    from fortran_davidson_tpu_torch.parallel import mesh as mesh_module
    calls = [0]
    matmat = cls.matmat

    def counted(self, block):
        calls[0] += bool(mesh_module._INVENTORIES.get())
        return matmat(self, block)

    cls.matmat = counted
    try:
        yield calls
    finally:
        cls.matmat = matmat


def _inventory(stats: dict, prefix: str, out: dict) -> None:
    """``stats`` (``parallel.scaling``) as JSON strings: the stats and
    the records as (kind, bytes, shape, moved)."""
    records = stats.pop("records")
    out[f"{prefix}_stats"] = np.array(json.dumps(stats))
    out[f"{prefix}_records"] = np.array(json.dumps(
        [(r.kind, r.bytes, list(r.shape), r.moved) for r in records]))


def scaling_cases(inputs, mesh, out: dict) -> None:
    """The scaling probe's inventories and the applies in each, the
    double-single folds of the rank's rows of ``ds_x``/``ds_y``, the ELL
    rule's inventories (GATHER_WORLDS) and the refined surrogate solve
    of order DS_N (TALL_WORLDS), on ``mesh``."""
    from fortran_davidson_tpu_torch.models.generators import \
        surrogate_hamiltonian
    from fortran_davidson_tpu_torch.ops.sparse import (ELLOperator,
                                                      generate_local_sparse)
    from fortran_davidson_tpu_torch.parallel import (HaloQuantizedOperator,
                                                     RowShardConstraint,
                                                     eigensolve_sharded,
                                                     scaling)
    from fortran_davidson_tpu_torch.utils import ds
    for nbr in SCALING_NBR:
        with counting_recorded_applies(HaloQuantizedOperator) as applies:
            stats = scaling.probe_collectives(mesh, nbr=nbr, bs=SCALING_BS)
        _inventory(stats, f"scaling{nbr}", out)
        out[f"scaling{nbr}_applies"] = np.array(applies[0])

    rows = RowShardConstraint(mesh, DS_N)
    x, y = (torch.from_numpy(inputs[name][mesh.rows(DS_N)])
            for name in ("ds_x", "ds_y"))
    for name, fold in (("dot", lambda: ds.dot_cols_ds(x, y, rows=rows)),
                       ("gram", lambda: ds.gram_ds(x, y, rows=rows)),
                       ("sumsq", lambda: ds.col_sumsq_ds(x, rows=rows))):
        out[f"ds_{name}"] = torch.stack(fold()).numpy()

    if mesh.size in GATHER_WORLDS:
        opts = dict(GATHER)
        lowest = opts.pop("lowest")
        for n in GATHER_N:
            coo = generate_local_sparse(n, 6, locality=20.0, seed=41)
            op = ELLOperator.from_coo(*coo, n, device="cpu")
            _inventory(scaling.iteration_inventory(op, mesh, lowest, **opts),
                       f"gather{n}", out)
    if mesh.size in TALL_WORLDS:
        lowest, opts = REFINED_SOLVES["refined_free"]
        res = eigensolve_sharded(
            surrogate_hamiltonian(DS_N, dtype=torch.float32, device="cpu"),
            lowest, mesh, **opts)
        out.update(tall_evals=res.eigenvalues.numpy(),
                   tall_iterations=np.array(res.iterations))


def rows_cases(mesh, out: dict) -> None:
    """Each ROWS_SOLVES case solved twice: on the operator the rank built
    from its own rows (``own``) and on the one cut from the global tables
    (``cut``)."""
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import sparse
    from fortran_davidson_tpu_torch.parallel import (HaloBSROperator,
                                                     HaloQuantizedOperator,
                                                     eigensolve_sharded)
    nbr, rows = ROWS_NBR, mesh.rows(ROWS_NBR)
    gen = dict(bandwidth=1, seed=ROWS_SEED, device="cpu")
    A = fdtt.generate_banded_bsr(nbr, 8, **gen)
    q = fdtt.generate_banded_bsr_quantized(nbr, 8, **gen)
    pairs = {
        "rows_remote": (
            HaloBSROperator(*sparse.banded_bsr_rows(nbr, 8, rows, **gen), 1,
                            mesh, backend="pallas-remote", n_block_rows=nbr),
            HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")),
        "rows_int8": (
            HaloQuantizedOperator(
                *sparse.banded_bsr_quantized_rows(nbr, 8, rows, **gen), 1,
                mesh, n_block_rows=nbr),
            HaloQuantizedOperator.from_quantized(q, mesh)),
    }
    for name, ops in pairs.items():
        lowest, opts = ROWS_SOLVES[name]
        for tag, op in zip(("own", "cut"), ops):
            res = eigensolve_sharded(op, lowest, mesh, **opts)
            out[f"{name}_{tag}_evals"] = res.eigenvalues.numpy()
            out[f"{name}_{tag}_evecs"] = res.eigenvectors.numpy()
            out[f"{name}_{tag}_iterations"] = np.array(res.iterations)
            out[f"{name}_{tag}_converged"] = np.array(res.converged)


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
            if backend != "pallas-remote":
                with all_gather_exchange():
                    out[f"halo{bw}_{backend}_y_gathered"] = \
                        h.matmat(X).numpy()
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
        slabs = all_gather_halos(mesh, Xs, halo)
        out[f"ring{halo}"] = torch.cat([from_prev, from_next]).numpy()
        out[f"slabs{halo}"] = torch.cat(slabs).numpy()
    Xq = torch.from_numpy(inputs["Xq"][mesh.rows(inputs["Xq"].shape[0])])
    for bw in INT8_BANDS:
        q = quantized(inputs, f"int8_{bw}")
        hq = shard_operator(q, mesh)
        assert isinstance(hq, HaloQuantizedOperator) and hq.backend == "pallas"
        for backend in ("xla", "pallas"):
            h = HaloQuantizedOperator.from_quantized(q, mesh, backend=backend)
            with counting_collectives() as calls:
                out[f"int8_{bw}_{backend}_y"] = h.matmat(Xq).numpy()
            out[f"int8_{bw}_{backend}_calls"] = np.array(
                [calls[n] for n in COUNTED])
            with all_gather_exchange():
                out[f"int8_{bw}_{backend}_y_gathered"] = h.matmat(Xq).numpy()
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
            out[f"sparse_{name}_offdiag_y"] = sharded.offdiag().matmat(
                torch.from_numpy(X[mesh.rows(X.shape[0])])).numpy()
            lowest, opts = SPARSE_SOLVES[name]
            res = eigensolve_sharded(op, lowest, mesh, **opts)
            out[f"sparse_{name}_evals"] = res.eigenvalues.numpy()
            out[f"sparse_{name}_evecs"] = res.eigenvectors.numpy()
            out[f"sparse_{name}_iterations"] = np.array(res.iterations)
            out[f"sparse_{name}_converged"] = np.array(res.converged)

    if world in CHEB_WORLDS:
        from fortran_davidson_tpu_torch import convert
        lowest, opts = CHEB
        with recording_degrees() as degrees:
            res = eigensolve_sharded(convert.dense(inputs["Ac"], device="cpu"),
                                     lowest, mesh, **opts)
        out.update(cheb_evals=res.eigenvalues.numpy(),
                   cheb_evecs=res.eigenvectors.numpy(),
                   cheb_iterations=np.array(res.iterations),
                   cheb_converged=np.array(res.converged),
                   cheb_operator_columns=np.array(res.operator_columns),
                   cheb_degrees=np.array(degrees))

    refined = {}
    if world in REFINED_WORLDS:
        from fortran_davidson_tpu_torch import convert
        from fortran_davidson_tpu_torch.models.generators import \
            surrogate_hamiltonian
        for name, (lowest, opts) in REFINED_SOLVES.items():
            A = {"refined_surrogate": lambda: convert.dense(
                     inputs["surrogate32"], device="cpu"),
                 "refined_free": lambda: surrogate_hamiltonian(
                     inputs["surrogate32"].shape[0], dtype=torch.float32,
                     device="cpu"),
                 "refined_bsr": lambda: banded(inputs, "refined_bsr")}[name]()
            res = eigensolve_sharded(A, lowest, mesh, **opts)
            refined[name] = (A, res)
            out[f"{name}_evals"] = res.eigenvalues.numpy()
            out[f"{name}_evals_lo"] = (np.zeros(lowest, np.float32)
                                       if res.eigenvalues_lo is None
                                       else res.eigenvalues_lo.numpy())
            out[f"{name}_evecs"] = res.eigenvectors.numpy()
            out[f"{name}_residuals"] = res.residual_norms.numpy()
            out[f"{name}_iterations"] = np.array(res.iterations)
            out[f"{name}_converged"] = np.array(res.converged)
    if world in CKPT_WORLDS:
        checkpoint_cases(inputs, mesh, run_dir, out)
    if world in FREE_WORLDS:
        free_checks(inputs, mesh, refined["refined_free"], out)
    scaling_cases(inputs, mesh, out)
    if world in ROWS_WORLDS:
        rows_cases(mesh, out)

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
