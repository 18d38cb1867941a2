"""The port's row-sharded solve (``fortran_davidson_tpu_torch.parallel``)
against the JAX package, on the CPU.

World sizes 1, 2 and 4 run as gloo process groups: one spawn per world
size (``tests/torch_dist_worker.py``) runs every check on its ranks, and
the tests here compare the ranks' rows, put back together, with:

- the JAX halo operators on ``default_mesh(world)`` with the same
  backend (kernels 6-8's Pallas kernels in interpret mode; kernel 8's
  remote copies go to the ring neighbours of the CPU mesh, at world size
  1 to the device itself): the applies within 1e-12 of max|Y| in
  float64, rtol = atol = 2e-5 in float32 (as JAX's
  ``TestRemoteHaloPallas``) and for int8 storage (bf16-class, as
  ``tests/test_quantized.py`` holds the JAX halo operator); diagonals
  exactly; the off-diagonal splits through A x = offdiag(A) x + d ∘ x;
- the JAX package's single-device solve and the port's own, on the cases
  of ``tests/test_parallel.py``: equal iteration counts and converged
  flags, eigenvalues within atol 1e-10 in float64 and rtol 1e-5 in
  float32, true residuals of the gathered eigenvectors within the
  solve's tolerance; the ``"pallas-remote"`` solves also against the JAX
  package's sharded solve through its remote kernel at the same world
  size;
- the ring exchange of every halo backend (``"xla"``, ``"pallas"``,
  ``"pallas-remote"`` and the int8 operator's two): the halos equal the
  all-gather's bit for bit, so do the applies of ``"xla"``, ``"pallas"``
  and the int8 operator with the halos moved either way, and an apply
  makes two sends and two receives at world sizes 2 and 4 (none at 1)
  and no collective;
- at world sizes 1 and 2, the ELL family's sharded operators (ELL, sliced
  ELL, hybrid band + remainder) against the global operator, and their
  sharded solves against the port's and the JAX package's
  single-device solves;
- at world size 2, a solve with Chebyshev-filtered restarts of degree
  ``"auto"`` and locking: every rank takes the single-device solve's
  degrees, iterations and operator columns;
- at world sizes 1 and 2, the sharded refined path (the float32
  surrogate's dense matrix, and a banded BSR with an in-solve polish)
  against the JAX package's sharded refined solve on
  ``default_mesh(world)``: iterations within ±1, the same converged flag,
  eigenvalues within the JAX test's 1e-5; and sharded checkpoints: the
  checkpointed solve, its resume, an interrupted and resumed solve (bit
  for bit the uninterrupted one), and at world size 2 a checkpoint moved
  from two ranks to one and from one to two (the uninterrupted
  iterations);
- ``orthonormalization="qr"`` (the TSQR): at world size 1 the
  single-device solve's bits, at 1 and 2 the JAX package's sharded
  ``"qr"`` solve (iterations within ±1, eigenvalues within 1e-10), and a
  block with zero columns keeps them zero, its survivors orthonormal;
- at world sizes 1 and 2, the matrix-free operators through their
  per-rank callables (the surrogate, the surrogate pencil,
  ``from_element_fn``, the float32 surrogate's double-single applies and
  a probed diagonal): the applies equal the single-device ones (bit for
  bit at world size 1), the solves match the JAX package's
  ``eigensolve_sharded`` (``tests/test_parallel.py:100``), and the
  per-rank ``polish_eigenpairs(mesh=...)`` of a sharded refined result
  matches the JAX package's polish of its sharded result;
- the scaling audit (``parallel.scaling``): at world sizes 1, 2 and 4 the
  probe's inventories at two row counts are byte-identical and pass the
  tall audit, agree across world sizes, and the JAX package's compiled
  probe at 4 devices gets the same verdicts; at world size 2 the ELL
  rule (it gathers x) fails both audits with the JAX texts; the ranks'
  double-single folds are the one-device folds under
  ``sum_strategy("tree", row_divisor=world)`` bit for bit, and at world
  size 1 the refined surrogate past the cascade's threshold gives the
  one-device ``"tree"`` solve's eigenvalue bits;
- at world sizes 2 and 4, solves on operators each rank built from its
  own rows (``n_block_rows=``) give the bits of the same solves on
  operators cut from the global tables (f64 ``"pallas-remote"``, int8).

The argument checks and ``convert.halo`` need no process group: they use
a :class:`RowMesh` whose group is never called.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu import config as jconfig
from fortran_davidson_tpu import parallel as jpar
from fortran_davidson_tpu.parallel import scaling as jscaling
from fortran_davidson_tpu.models import generators as jgen
from fortran_davidson_tpu.models.generators import surrogate_hamiltonian
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import config as tconfig
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch import parallel as tpar
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.parallel import multihost
from fortran_davidson_tpu_torch.parallel import scaling
from fortran_davidson_tpu_torch.utils import ds as tds
from fortran_davidson_tpu_torch.utils.errors import OperatorError
from tests import torch_dist_worker as worker
from tests.torch_parity import to_numpy

WORLDS = (1, 2, 4)
CPU = torch.device("cpu")


def _fake_mesh(size: int, rank: int = 0) -> tpar.RowMesh:
    """A mesh for checks that run before any collective."""
    return tpar.RowMesh(group=None, size=size, rank=rank, device=CPU)


@contextlib.contextmanager
def _one_thread():
    """Torch on one thread inside, as in the ranks
    (``torch_dist_worker._rank_main``): the bit-for-bit comparisons with
    the ranks need the products' reduction order that one thread takes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _tables(op) -> dict:
    return dict(cols=np.asarray(op.block_cols), blocks=np.asarray(op.blocks),
                bw=np.array(op.bandwidth))


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX operators of every check, built once."""
    f32 = jnp.float32
    ops = {f"halo{bw}": jsparse.generate_banded_bsr(
        64, 8, bandwidth=bw, coupling=1e-3, seed=20 + bw)
        for bw in worker.HALO_BANDS}
    ops.update({f"int8_{bw}": jsparse.quantize_banded_int8(
        jsparse.generate_banded_bsr(32, 8, bandwidth=bw, coupling=1e-3,
                                    seed=bw, dtype=f32))
        for bw in worker.INT8_BANDS})
    # The cases of tests/test_parallel.py and tests/test_quantized.py.
    ops["solve_halo"] = jsparse.generate_banded_bsr(64, 8, bandwidth=1,
                                                    coupling=1e-3, seed=22)
    ops["solve_bsr"] = jsparse.generate_banded_bsr(16, 8, bandwidth=1,
                                                   coupling=1e-3, seed=6)
    ops["solve_int8"] = jsparse.quantize_banded_int8(
        jsparse.generate_banded_bsr(32, 8, bandwidth=1, coupling=1e-3,
                                    dtype=f32))
    # The cases of TestRemoteHaloPallas, and 8 block rows at bw=2: at world
    # sizes 2 and 4 every row is an edge row, at 4 the halo is the whole
    # neighbour slab (JAX takes its "xla" path below 16 block rows).
    ops["remote32"] = jsparse.generate_banded_bsr(128, 8, bandwidth=2,
                                                  coupling=1e-3, seed=31,
                                                  dtype=f32)
    ops["solve_remote"] = jsparse.generate_banded_bsr(128, 8, bandwidth=1,
                                                      coupling=1e-3, seed=32,
                                                      dtype=f32)
    ops["tiny2"] = jsparse.generate_banded_bsr(8, 8, bandwidth=2,
                                               coupling=1e-3, seed=23)
    # The sharded refined path's banded case (tests/test_parallel.py:268).
    ops["refined_bsr"] = jsparse.generate_banded_bsr(64, 16, bandwidth=1,
                                                     coupling=1e-3, dtype=f32)
    return ops


@pytest.fixture(scope="module")
def inputs(jax_ops, tmp_path_factory):
    rng = np.random.default_rng(7)
    d = dict(A=np.asarray(jgen.generate_diagonal_dominant(64, 1e-3)),
             Ac=np.array(jgen.generate_diagonal_dominant(
                 64, 0.3, key=jax.random.PRNGKey(3))),
             B=np.asarray(jgen.generate_diagonal_dominant(64, 1e-3,
                                                          diag_val=1.0)),
             X0=rng.standard_normal((64, 2)),
             X=rng.standard_normal((512, 6)),
             Xq=rng.standard_normal((256, 4)).astype(np.float32))
    d.update(X32=rng.standard_normal((1024, 5)).astype(np.float32),
             Xs=rng.standard_normal((64, 3)))
    # The refined and checkpoint cases: the float32 surrogate's matrix
    # (n = 2048) and the n=512 matrix of tests/test_checkpoint.py:129.
    n_sur = 2048
    d.update(surrogate32=np.asarray(surrogate_hamiltonian(
        n_sur, dtype=jnp.float32).matmat(jnp.eye(n_sur, dtype=jnp.float32))),
        A512=np.asarray(jgen.generate_diagonal_dominant(512, 1e-3),
                        np.float32))
    # The ELL family's cases: a 500-row locality-bearing COO (the hybrid
    # pads it to 512 rows, 32 block rows of 16).
    rows, cols, vals = jsparse.generate_local_sparse(500, 6, locality=20.0,
                                                     seed=41)
    d.update(coo_rows=rows, coo_cols=cols, coo_vals=vals,
             coo_n=np.array(500),
             Xsp=np.random.default_rng(41).standard_normal((512, 4)))
    # The matrix-free applies' X, and orthonormalize_block's "qr" case: a
    # 3-column orthonormal V and a 7-column block whose columns 1 and 5
    # are zero, column 3 lies in span(V) and column 6 is inactive.
    qr_rng = np.random.default_rng(18)
    V, _ = np.linalg.qr(qr_rng.standard_normal((64, 3)))
    block = qr_rng.standard_normal((64, 7))
    block[:, [1, 5]] = 0.0
    block[:, 3] = V @ qr_rng.standard_normal(3)
    d.update(Xf=qr_rng.standard_normal((worker.FREE_N, 5)), qr_V=V,
             qr_block=block, qr_mask=np.array([1.0] * 6 + [0.0]))
    # The tall block of the double-single folds.
    ds_rng = np.random.default_rng(19)
    d.update(ds_x=ds_rng.standard_normal((worker.DS_N, 3)).astype(np.float32),
             ds_y=ds_rng.standard_normal((worker.DS_N, 3)).astype(np.float32))
    for tag, op in jax_ops.items():
        if hasattr(op, "qblocks"):
            d.update({f"{tag}_q": np.asarray(op.qblocks),
                      f"{tag}_scale": np.asarray(op.scale_rows),
                      f"{tag}_diag": np.asarray(op.diag),
                      f"{tag}_bw": np.array(op.bandwidth)})
        else:
            d.update({f"{tag}_{k}": v for k, v in _tables(op).items()})
    path = tmp_path_factory.mktemp("inputs") / "inputs.npz"
    np.savez(path, **d)
    return d, path


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """world -> the ranks' results, one spawn per world size."""
    d, path = inputs

    @functools.cache
    def run(world: int) -> list:
        run_dir = tmp_path_factory.mktemp(f"world{world}")
        (run_dir / "inputs.npz").symlink_to(path)
        return worker.spawn(world, str(run_dir))

    return run


def _gathered(results: list, key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in results])


@pytest.fixture(scope="module")
def jax_halo(inputs, jax_ops):
    """(tag, world, backend, X) -> the JAX halo operator's apply of
    inputs[X] and its diagonal on default_mesh(world), through its Pallas
    kernel (interpret mode)."""
    d, _ = inputs

    @functools.cache
    def run(tag: str, world: int, backend: str = "pallas", x: str = "X"):
        mesh, op = jpar.default_mesh(world), jax_ops[tag]
        if hasattr(op, "qblocks"):
            h = jpar.HaloQuantizedOperator.from_quantized(op, mesh,
                                                          backend=backend)
        else:
            h = jpar.HaloBSROperator.from_bsr(op, op.bandwidth, mesh,
                                              backend=backend)
        return (np.asarray(h.matmat(jnp.asarray(d[x]))),
                np.asarray(h.diagonal()))

    return run


@pytest.mark.parametrize("backend", list(worker.HALO_BACKENDS))
@pytest.mark.parametrize("bw", worker.HALO_BANDS)
@pytest.mark.parametrize("world", WORLDS)
def test_halo_bsr_matches_jax(ranks, inputs, jax_halo, world, bw, backend):
    # The port's "xla" and "pallas" against JAX's "pallas", and
    # "pallas-remote" against JAX's "pallas-remote".
    d, _ = inputs
    res = ranks(world)
    y_j, diag_j = jax_halo(f"halo{bw}", world,
                           "pallas-remote" if backend == "pallas-remote"
                           else "pallas")
    y = _gathered(res, f"halo{bw}_{backend}_y")
    scale = np.max(np.abs(y_j))
    assert np.max(np.abs(y - y_j)) <= 1e-12 * scale
    np.testing.assert_array_equal(_gathered(res, f"halo{bw}_{backend}_diag"),
                                  diag_j)
    off = _gathered(res, f"halo{bw}_{backend}_offdiag_y")
    assert np.max(np.abs(off - (y_j - diag_j[:, None] * d["X"]))) \
        <= 1e-12 * scale


@pytest.mark.parametrize("world", WORLDS)
def test_remote_halo_float32_matches_jax(ranks, jax_halo, world):
    y_j, _ = jax_halo("remote32", world, "pallas-remote", "X32")
    y = _gathered(ranks(world), "remote32_y")
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, y_j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_remote_halo_on_edge_only_slabs_matches_jax(ranks, jax_halo, world):
    # 8 block rows at bw=2: 2 per rank at world size 4, fewer than 2·bw,
    # and the halo is the whole neighbour slab.
    y_j, _ = jax_halo("tiny2", world, "pallas-remote", "Xs")
    y = _gathered(ranks(world), "tiny2_y")
    assert np.max(np.abs(y - y_j)) <= 1e-12 * np.max(np.abs(y_j))


@pytest.mark.parametrize("world", WORLDS)
def test_ring_exchange_equals_the_all_gather(ranks, world):
    for r in ranks(world):
        for halo in worker.RING_HALOS:
            np.testing.assert_array_equal(r[f"ring{halo}"], r[f"slabs{halo}"])


@pytest.mark.parametrize("world", WORLDS)
def test_remote_apply_is_ring_point_to_point_only(ranks, world):
    # Per rank and apply, of every halo backend and of the int8 operator:
    # two sends and two receives to the ring neighbours (none at world
    # size 1, where the halos are the rank's own rows) and no collective.
    p2p = 2 if world > 1 else 0
    want = {**dict.fromkeys(worker.COUNTED, 0), "isend": p2p, "irecv": p2p}
    keys = [f"halo{bw}_{b}_calls" for bw in worker.HALO_BANDS
            for b in worker.HALO_BACKENDS]
    keys += [f"int8_{bw}_{b}_calls" for bw in worker.INT8_BANDS
             for b in ("xla", "pallas")]
    for r in ranks(world):
        for key in keys:
            calls = dict(zip(worker.COUNTED, r[key].tolist()))
            assert calls == want, (key, calls)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_exchange_apply_equals_the_all_gather_apply(ranks, world):
    # "xla", "pallas" and the int8 operator's two backends with the halos
    # moved by the ring exchange and by the all-gather it replaced: the
    # same bits.
    keys = [f"halo{bw}_{b}_y" for bw in worker.HALO_BANDS
            for b in ("xla", "pallas")]
    keys += [f"int8_{bw}_{b}_y" for bw in worker.INT8_BANDS
             for b in ("xla", "pallas")]
    for r in ranks(world):
        for key in keys:
            np.testing.assert_array_equal(r[key], r[f"{key}_gathered"])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bw", worker.INT8_BANDS)
@pytest.mark.parametrize("world", WORLDS)
def test_halo_int8_matches_jax(ranks, jax_halo, world, bw, backend):
    res = ranks(world)
    y_j, diag_j = jax_halo(f"int8_{bw}", world, x="Xq")
    np.testing.assert_allclose(_gathered(res, f"int8_{bw}_{backend}_y"), y_j,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_gathered(res, f"int8_{bw}_diag"), diag_j)
    np.testing.assert_allclose(_gathered(res, f"int8_{bw}_split_y"), y_j,
                               rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def single_device(inputs, jax_ops):
    """name -> the JAX package's and the port's single-device solves of a
    case, and its dense matrix."""
    d, _ = inputs

    @functools.cache
    def run(name: str):
        lowest, opts = worker.SOLVES[name]
        jA = {"halo_pallas": jax_ops["solve_halo"],
              "halo_remote": jax_ops["solve_halo"],
              "gjd_halo": jax_ops["solve_halo"],
              "qr_halo": jax_ops["solve_halo"],
              "remote_f32": jax_ops["solve_remote"],
              "bsr": jax_ops["solve_bsr"],
              "int8": jax_ops["solve_int8"],
              "int8_f64": jax_ops["solve_int8"]}.get(name, d["A"])
        rj = fdt.eigensolve(jA, lowest,
                            second_matrix=d["B"] if name == "pencil" else None,
                            initial_vectors=d["X0"] if name == "warm" else None,
                            **opts)
        A, B, X0 = worker.solve_cases(d)[name]
        with _one_thread():
            rt = fdtt.eigensolve(A, lowest, second_matrix=B,
                                 initial_vectors=X0, **opts)
        return rj, rt, to_numpy(A.to_dense()).astype(np.float64)

    return run


@pytest.mark.parametrize("name", list(worker.SOLVES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_solve_matches_single_device(ranks, inputs, single_device,
                                             world, name):
    d, _ = inputs
    rj, rt, dense = single_device(name)
    res = ranks(world)
    lowest, opts = worker.SOLVES[name]
    its = {int(r[f"{name}_iterations"]) for r in res}
    conv = {bool(r[f"{name}_converged"]) for r in res}
    assert len(its) == 1 and len(conv) == 1, "the ranks disagree"
    for r in res[1:]:
        np.testing.assert_array_equal(r[f"{name}_evals"], res[0][f"{name}_evals"])
    assert its == {int(rj.iterations)} == {rt.iterations}
    assert conv == {bool(rj.converged)} == {rt.converged} == {True}
    lam = res[0][f"{name}_evals"]
    tol = (dict(rtol=1e-5, atol=0) if opts.get("dtype") == "float32"
           else dict(rtol=0, atol=1e-10))
    if name == "int8_f64":
        # float64 on int8 storage: the apply's sums round to float32 in
        # both packages, in another order, so the solves agree to the
        # solve's 1e-6, as test_float64_solve_on_int8_storage_matches_jax
        # holds the single-device solves.
        tol = dict(rtol=0, atol=1e-6)
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), **tol)
    np.testing.assert_allclose(lam, to_numpy(rt.eigenvalues), **tol)
    X = _gathered(res, f"{name}_evecs").astype(np.float64)
    assert X.shape == (dense.shape[0], lowest)
    BX = X if name != "pencil" else d["B"] @ X
    r = np.linalg.norm(dense @ X - BX * lam[None, :].astype(np.float64),
                       axis=0)
    if opts.get("relative_tolerance"):
        r = r / np.maximum(np.abs(lam), 1.0)
    # int8 in float32: the loop's residual floor plus float32 roundoff of X.
    assert np.all(r <= opts["tolerance"] * (2.0 if "dtype" in opts else 1.0))


@pytest.mark.parametrize("name", list(worker.ROWS_SOLVES))
@pytest.mark.parametrize("world", worker.ROWS_WORLDS)
def test_rank_row_solve_gives_the_global_table_bits(ranks, world, name):
    # Operators each rank built from its own rows (n_block_rows=) solve to
    # the bits of those cut from the global tables: f64 "pallas-remote"
    # (the exchange route on CPU ranks) and the int8 halo (kernel 7).
    for r in ranks(world):
        assert bool(r[f"{name}_own_converged"])
        for key in ("evals", "evecs", "iterations"):
            np.testing.assert_array_equal(r[f"{name}_own_{key}"],
                                          r[f"{name}_cut_{key}"])


@pytest.mark.parametrize("name", ["qr", "qr_halo"])
def test_sharded_qr_at_world_size_one_is_the_single_device_qr(
        ranks, single_device, name):
    # One rank skips the TSQR's second stage: the single-device "qr"
    # solve's iterations and eigenvalue bits.
    _, rt, _ = single_device(name)
    r = ranks(1)[0]
    assert int(r[f"{name}_iterations"]) == rt.iterations
    np.testing.assert_array_equal(r[f"{name}_evals"],
                                  to_numpy(rt.eigenvalues))


@pytest.mark.parametrize("name", ["qr", "qr_halo"])
@pytest.mark.parametrize("world", (1, 2))
def test_sharded_qr_matches_jax_sharded(ranks, inputs, jax_ops, world, name):
    # The JAX package's sharded "qr" solve at the same world size:
    # iterations within ±1, eigenvalues within 1e-10.
    d, _ = inputs
    lowest, opts = worker.SOLVES[name]
    mesh = jpar.default_mesh(world)
    jA = (d["A"] if name == "qr" else jpar.HaloBSROperator.from_bsr(
        jax_ops["solve_halo"], 1, mesh, backend="pallas"))
    rj = jpar.eigensolve_sharded(jA, lowest, mesh, **opts)
    res = ranks(world)
    its = {int(r[f"{name}_iterations"]) for r in res}
    assert len(its) == 1 and abs(its.pop() - int(rj.iterations)) <= 1
    np.testing.assert_allclose(res[0][f"{name}_evals"],
                               np.asarray(rj.eigenvalues), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("world", worker.FREE_WORLDS)
def test_tsqr_keeps_zero_columns_zero(ranks, inputs, world):
    # orthonormalize_block's "qr" branch on row-sharded rows: the two zero
    # columns, the one in span(V) and the inactive one come out exactly
    # zero, after the survivors; the survivors are orthonormal and
    # orthogonal to V to 1e-13, and span what the JAX package's "qr"
    # branch spans (their projectors within 1e-12).
    d, _ = inputs
    res = ranks(world)
    q = _gathered(res, "qr_q")
    for r in res:
        np.testing.assert_array_equal(r["qr_alive"], [1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(q[:, 3:], 0.0)
    np.testing.assert_allclose(q[:, :3].T @ q[:, :3], np.eye(3), rtol=0,
                               atol=1e-13)
    assert np.max(np.abs(d["qr_V"].T @ q)) <= 1e-13
    from fortran_davidson_tpu.core import orthogonal as jortho
    qj, alive_j = jortho.orthonormalize_block(
        jnp.asarray(d["qr_V"]), jnp.asarray(d["qr_block"]),
        jnp.asarray(d["qr_mask"]), method="qr")
    qj = np.asarray(qj)[:, np.asarray(alive_j) > 0.5]
    np.testing.assert_allclose(q[:, :3] @ q[:, :3].T, qj @ qj.T, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["halo_remote", "remote_f32"])
@pytest.mark.parametrize("world", WORLDS)
def test_remote_solve_matches_jax_sharded(ranks, jax_ops, world, name):
    # The JAX package's sharded solve through its remote kernel (interpret
    # mode) at the same world size: the same iterations and eigenvalues.
    lowest, opts = worker.SOLVES[name]
    jA = jax_ops["solve_halo" if name == "halo_remote" else "solve_remote"]
    mesh = jpar.default_mesh(world)
    rj = jpar.eigensolve_sharded(
        jpar.HaloBSROperator.from_bsr(jA, jA.bandwidth, mesh,
                                      backend="pallas-remote"),
        lowest, mesh, **opts)
    res = ranks(world)
    assert {int(r[f"{name}_iterations"]) for r in res} == {int(rj.iterations)}
    tol = (dict(rtol=1e-5, atol=0) if opts.get("dtype") == "float32"
           else dict(rtol=0, atol=1e-10))
    np.testing.assert_allclose(res[0][f"{name}_evals"],
                               np.asarray(rj.eigenvalues), **tol)


@pytest.fixture(scope="module")
def sparse_single(inputs):
    """name -> (the port's global operator, its single-device solve, the
    JAX package's single-device solve of the same COO)."""
    d, _ = inputs
    ops = worker.sparse_cases(d)
    coo = (d["coo_rows"], d["coo_cols"], d["coo_vals"], int(d["coo_n"]))
    jops = {"ell": lambda: jsparse.ELLOperator.from_coo(*coo),
            "sell": lambda: jsparse.SlicedELLOperator.from_coo(*coo),
            "hybrid": lambda: jsparse.split_band_remainder(
                *coo, block_size=16, bandwidth=1, block_rows_multiple=2)}

    @functools.cache
    def run(name: str):
        lowest, opts = worker.SPARSE_SOLVES[name]
        return (ops[name], fdtt.eigensolve(ops[name], lowest, **opts),
                fdt.eigensolve(jops[name](), lowest, **opts))

    return run


@pytest.mark.parametrize("name", list(worker.SPARSE_SOLVES))
@pytest.mark.parametrize("world", worker.SPARSE_WORLDS)
def test_sharded_sparse_apply_matches_the_global_operator(
        ranks, inputs, sparse_single, world, name):
    # The rank's rows of the ELL table (sliced ELL through to_ell, the
    # hybrid's band through kernel 2's wrapper) over one all-gather of X:
    # the global apply within 1e-13 of max|Y|, the diagonal exactly.
    d, _ = inputs
    res = ranks(world)
    op = sparse_single(name)[0]
    y = op.matmat(torch.from_numpy(d["Xsp"][:op.shape[0]])).numpy()
    got = _gathered(res, f"sparse_{name}_y")
    assert got.shape == y.shape
    assert np.max(np.abs(got - y)) <= 1e-13 * np.max(np.abs(y))
    np.testing.assert_array_equal(_gathered(res, f"sparse_{name}_diag"),
                                  op.diagonal().numpy())
    assert {int(r[f"sparse_{name}_gathers"]) for r in res} == {1}


@pytest.mark.parametrize("name", list(worker.SPARSE_SOLVES))
@pytest.mark.parametrize("world", worker.SPARSE_WORLDS)
def test_sharded_sparse_offdiag_is_the_global_split(ranks, inputs,
                                                     sparse_single, world,
                                                     name):
    # The refined path's off-diagonal split of the rank's rows (the stored
    # diagonal slots zeroed): the global operator's offdiag() apply,
    # within 1e-13 of max|Y|.
    d, _ = inputs
    op = sparse_single(name)[0]
    X = torch.from_numpy(d["Xsp"][:op.shape[0]])
    y = op.offdiag().matmat(X).numpy()
    got = _gathered(ranks(world), f"sparse_{name}_offdiag_y")
    assert np.max(np.abs(got - y)) <= 1e-13 * np.max(np.abs(y))


@pytest.mark.parametrize("name", list(worker.SPARSE_SOLVES))
@pytest.mark.parametrize("world", worker.SPARSE_WORLDS)
def test_sharded_sparse_solve_matches_jax(ranks, sparse_single, world, name):
    # Against the port's single-device solve: the same iterations,
    # eigenvalues within 1e-10; against the JAX package's: iterations
    # within ±1, eigenvalues within 1e-8, the same converged flag; true
    # residuals of the gathered eigenvectors within the tolerance.
    op, rt, rj = sparse_single(name)
    res = ranks(world)
    lowest, opts = worker.SPARSE_SOLVES[name]
    its = {int(r[f"sparse_{name}_iterations"]) for r in res}
    conv = {bool(r[f"sparse_{name}_converged"]) for r in res}
    assert len(its) == 1 and len(conv) == 1, "the ranks disagree"
    assert its == {rt.iterations} and conv == {True} == {bool(rj.converged)}
    assert abs(its.pop() - int(rj.iterations)) <= 1
    lam = res[0][f"sparse_{name}_evals"]
    np.testing.assert_allclose(lam, to_numpy(rt.eigenvalues), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), rtol=0,
                               atol=1e-8)
    X = _gathered(res, f"sparse_{name}_evecs")
    dense = to_numpy(op.to_dense())
    r = np.linalg.norm(dense @ X - X * lam[None, :], axis=0)
    assert np.all(r <= opts["tolerance"])


@pytest.mark.parametrize("world", worker.CHEB_WORLDS)
def test_sharded_filtered_restarts_with_locking(ranks, inputs, world):
    # Every rank draws its rows of one start vector and sums the bound's
    # dots over the ranks, so the bound, each collapse's degree and the
    # operator applies are the single-device solve's on every rank (a
    # rank that took another degree would hang the next collective).
    d, _ = inputs
    lowest, opts = worker.CHEB
    with worker.recording_degrees() as degrees:
        rt = fdtt.eigensolve(convert.dense(d["Ac"], device="cpu"), lowest,
                             **opts)
    res = ranks(world)
    assert rt.converged and len(degrees) > 0
    dims = rt.subspace_dims[:rt.iterations]
    assert int(torch.sum(dims[1:] < dims[:-1])) == len(degrees)
    for r in res:
        assert r["cheb_degrees"].tolist() == degrees
        assert int(r["cheb_iterations"]) == rt.iterations
        assert int(r["cheb_operator_columns"]) == rt.operator_columns
        assert bool(r["cheb_converged"])
        np.testing.assert_allclose(r["cheb_evals"], to_numpy(rt.eigenvalues),
                                   rtol=0, atol=1e-10)
    want = np.linalg.eigvalsh(d["Ac"])[:lowest]
    np.testing.assert_allclose(res[0]["cheb_evals"], want, rtol=0, atol=1e-8)
    X = _gathered(res, "cheb_evecs")
    lam = res[0]["cheb_evals"]
    r = np.linalg.norm(d["Ac"] @ X - X * lam[None, :], axis=0)
    assert np.all(r <= opts["tolerance"])


@pytest.fixture(scope="module")
def jax_refined(inputs, jax_ops):
    """(name, world) -> the JAX package's sharded refined solve of a
    REFINED_SOLVES case on default_mesh(world)."""
    @functools.cache
    def run(name: str, world: int):
        lowest, opts = worker.REFINED_SOLVES[name]
        op = (surrogate_hamiltonian(2048, dtype=jnp.float32)
              if name in ("refined_surrogate", "refined_free")
              else jax_ops["refined_bsr"])
        res = jpar.eigensolve_sharded(op, lowest, jpar.default_mesh(world),
                                      **opts)
        res.block_until_ready()
        return res

    return run


@pytest.mark.parametrize("name", list(worker.REFINED_SOLVES))
@pytest.mark.parametrize("world", worker.REFINED_WORLDS)
def test_sharded_refined_matches_jax(ranks, inputs, jax_refined, world,
                                     name):
    # The shard-local double-single folds: the ranks agree bit for bit;
    # against the JAX package's sharded solve at the same world size,
    # iterations within ±1, the same converged flag, eigenvalues within
    # the JAX test's 1e-5; the loop's (or the polish's) true residuals
    # under the tolerance, and the gathered eigenvectors' float64
    # residuals against the stored matrix within float32 roundoff of it.
    d, _ = inputs
    res = ranks(world)
    rj = jax_refined(name, world)
    lowest, opts = worker.REFINED_SOLVES[name]
    for r in res[1:]:
        np.testing.assert_array_equal(r[f"{name}_evals"],
                                      res[0][f"{name}_evals"])
        assert int(r[f"{name}_iterations"]) == int(
            res[0][f"{name}_iterations"])
    r0 = res[0]
    assert abs(int(r0[f"{name}_iterations"]) - int(rj.iterations)) <= 1
    assert bool(r0[f"{name}_converged"]) == bool(rj.converged) == True
    np.testing.assert_allclose(r0[f"{name}_evals"],
                               np.asarray(rj.eigenvalues), rtol=0, atol=1e-5)
    assert float(np.max(r0[f"{name}_residuals"])) < opts["tolerance"]
    dense = (d["surrogate32"] if name in ("refined_surrogate",
                                          "refined_free")
             else to_numpy(worker.banded(d, "refined_bsr").to_dense()))
    X = _gathered(res, f"{name}_evecs").astype(np.float64)
    X /= np.linalg.norm(X, axis=0)
    lam = (r0[f"{name}_evals"].astype(np.float64)
           + r0[f"{name}_evals_lo"].astype(np.float64))
    r = np.linalg.norm(dense.astype(np.float64) @ X - X * lam, axis=0)
    assert np.all(r <= 1e-5 * np.maximum(np.abs(lam), 1.0))


@pytest.mark.parametrize("name", list(worker.CKPT_SOLVES))
@pytest.mark.parametrize("world", worker.CKPT_WORLDS)
def test_sharded_checkpoint_resumes_bit_for_bit(ranks, inputs, world, name):
    # The checkpointed sharded solve, its resume from the complete
    # directory, and an interrupted one resumed: the same bits, iterations
    # and operator columns as the uninterrupted sharded solve, on every
    # rank; the interrupted run left exactly its first step on disk.
    d, _ = inputs
    res = ranks(world)
    key, lowest, every, opts = worker.CKPT_SOLVES[name]
    for r in res:
        assert bool(r[f"{name}_converged"])
        for leg in ("again", "resumed"):
            for field in ("evals", "iterations", "operator_columns"):
                np.testing.assert_array_equal(r[f"{name}_{leg}_{field}"],
                                              r[f"{name}_{field}"])
        first = min(every, int(r[f"{name}_iterations"]))
        assert r[f"{name}_cut_saved"].tolist() == ["solver_config.json",
                                                   f"step_{first}"]
        np.testing.assert_array_equal(r[f"{name}_evals"],
                                      res[0][f"{name}_evals"])
    # The single-device solve of the same options: the same iterations.
    one = fdtt.eigensolve(convert.dense(d[key], device="cpu"), lowest,
                          **opts)
    assert int(res[0][f"{name}_iterations"]) == one.iterations
    np.testing.assert_allclose(res[0][f"{name}_evals"],
                               to_numpy(one.eigenvalues), rtol=0,
                               atol=1e-10 if "dtype" not in opts else 1e-6)


def test_sharded_checkpoint_moves_between_world_sizes(ranks, inputs):
    # Written on two ranks, resumed on one (rank 0's one-rank group), and
    # written on one, resumed on two: each rank reads the rows it owns,
    # and the solve ends with the uninterrupted iterations.
    res = ranks(2)
    full = res[0]
    for leg, holders in (("2to1", res[:1]), ("1to2", res)):
        for r in holders:
            assert bool(r[f"ckpt_{leg}_converged"])
            assert int(r[f"ckpt_{leg}_iterations"]) == int(
                full["ckpt_iterations"])
            np.testing.assert_allclose(r[f"ckpt_{leg}_evals"],
                                       full["ckpt_evals"], rtol=0,
                                       atol=1e-12)


# -- matrix-free operators through their per-rank callables -----------

def _jax_free(name: str, n: int = worker.FREE_N):
    """The JAX package's (A, B) of a FREE_SOLVES case."""
    if name == "free_elem":
        from fortran_davidson_tpu.ops.operators import from_element_fn
        return from_element_fn(
            lambda i, j: jnp.where(i == j, 1.0 + i,
                                   1e-3 * jnp.cos(0.01 * (i + j))), n), None
    return (surrogate_hamiltonian(n),
            jgen.surrogate_overlap(n) if name == "free_pencil" else None)


@pytest.fixture(scope="module")
def free_single(inputs):
    """name -> the port's single-device applies of a free_apply_ops()
    operator on inputs["Xf"]: y, diagonal, offdiag y, and (float32) the
    double-single applies' hi + lo."""
    d, _ = inputs
    ops = worker.free_apply_ops()

    @functools.cache
    def run(name: str) -> dict:
        op = ops[name]
        x = torch.from_numpy(d["Xf"]).to(op.dtype)
        with _one_thread():
            out = dict(y=op.matmat(x), diag=op.diagonal(),
                       offdiag_y=op.offdiag().matmat(x))
            if op.dtype == torch.float32:
                for tag, o in (("ds", op), ("offdiag_ds", op.offdiag())):
                    ds = o.matmat_ds(x, x * 1e-8)
                    if ds is not None:
                        out[tag] = ds[0].double() + ds[1].double()
        return {k: to_numpy(v) for k, v in out.items()}

    return run


@pytest.mark.parametrize("name", list(worker.free_apply_ops(8)))
@pytest.mark.parametrize("world", worker.FREE_WORLDS)
def test_sharded_matrix_free_apply_matches_single_device(
        ranks, free_single, world, name):
    # The rank's rows of every captured tensor, the callable run on them
    # with the mesh's hook: at world size 1 the single-device bits; at 2,
    # within 1e-13 of max|Y| in float64, two float32 ulps (1e-6) in
    # float32, the double-single applies within 1e-12 (the ranks' Dot2
    # partials fold exactly; what differs is the lo word's plain sum);
    # diagonals (stored or probed) exactly.
    want = free_single(name)
    res = ranks(world)
    for key, w in want.items():
        got = _gathered(res, f"fapply_{name}_{key}")
        assert got.shape == w.shape
        if world == 1 or key == "diag":
            np.testing.assert_array_equal(got, w, err_msg=key)
            continue
        rel = {np.dtype(np.float32): 1e-6}.get(w.dtype, 1e-13)
        if key.endswith("ds"):
            rel = 1e-12
        assert np.max(np.abs(got - w)) <= rel * np.max(np.abs(w)), key


def test_per_rank_callables_keep_their_single_device_bits(inputs):
    # On one device the per-rank callables get rows=LOCAL: the apply is
    # the global-view formula's bits (diag X + (U w) (Uᵀ X) - corr X; the
    # element rows in 256-row blocks against X), and every callable called
    # without the keyword gives what the operator gives through it.
    d, _ = inputs
    ops = worker.free_apply_ops()
    x = torch.from_numpy(d["Xf"])
    for name in ("free", "overlap"):
        diag, U, w = ops[name].captured
        want = (diag[:, None] * x + (U * w[None, :]) @ (U.T @ x)
                - torch.sum((U * U) * w[None, :], dim=1)[:, None] * x)
        assert torch.equal(ops[name].matmat(x), want), name
    out = torch.empty_like(x)
    cols = torch.arange(worker.FREE_N)
    for start in range(0, worker.FREE_N, 256):
        i = torch.arange(start, start + 256)[:, None]
        out[start:start + 256] = worker.element(i, cols[None, :]) @ x
    assert torch.equal(ops["free_elem"].matmat(x), out)
    op = ops["free32"]
    x32 = x.float()
    for o in (op, op.offdiag()):
        assert torch.equal(o.fn(x32, *o.captured), o.matmat(x32))
        if o.ds_fn is not None:
            for a, b in zip(o.ds_fn(x32, x32 * 1e-8, *o.captured),
                            o.matmat_ds(x32, x32 * 1e-8)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(worker.FREE_SOLVES))
@pytest.mark.parametrize("world", worker.FREE_WORLDS)
def test_sharded_matrix_free_solve_matches_jax(ranks, world, name):
    # Against the JAX package's eigensolve_sharded on default_mesh(world)
    # (tests/test_parallel.py:100): iterations within ±1, eigenvalues
    # within 1e-10; against the port's single-device solve: the same
    # iterations, eigenvalues within 1e-10 (at world size 1, its bits);
    # the ranks agree; true residuals of the gathered eigenvectors within
    # the tolerance.
    lowest, opts = worker.FREE_SOLVES[name]
    jA, jB = _jax_free(name)
    rj = jpar.eigensolve_sharded(jA, lowest, jpar.default_mesh(world),
                                 second_matrix=jB, **opts)
    A, B = worker.free_cases()[name]
    with _one_thread():
        rt = fdtt.eigensolve(A, lowest, second_matrix=B, **opts)
    res = ranks(world)
    its = {int(r[f"{name}_iterations"]) for r in res}
    assert len(its) == 1 and {bool(r[f"{name}_converged"]) for r in res} \
        == {True} == {bool(rj.converged)}
    it = its.pop()
    assert it == rt.iterations and abs(it - int(rj.iterations)) <= 1
    lam = res[0][f"{name}_evals"]
    for r in res[1:]:
        np.testing.assert_array_equal(r[f"{name}_evals"], lam)
    np.testing.assert_allclose(lam, np.asarray(rj.eigenvalues), rtol=0,
                               atol=1e-10)
    if world == 1:
        np.testing.assert_array_equal(lam, to_numpy(rt.eigenvalues))
    np.testing.assert_allclose(lam, to_numpy(rt.eigenvalues), rtol=0,
                               atol=1e-10)
    X = torch.from_numpy(_gathered(res, f"{name}_evecs"))
    BX = X if B is None else B.matmat(X)
    r = torch.linalg.vector_norm(A.matmat(X) - BX * torch.from_numpy(lam),
                                 dim=0)
    assert float(r.max()) <= opts["tolerance"]


@pytest.mark.parametrize("world", worker.FREE_WORLDS)
def test_per_rank_polish_matches_jax(ranks, inputs, jax_refined, world):
    # polish_eigenpairs(mesh=...) of the sharded matrix-free refined solve
    # against the JAX package's polish_eigenpairs of its sharded solve:
    # eigenvalues (hi + lo) within 1e-9 of the JAX package's float32
    # evals, which carry their rounding to float32 (eps·|λ| at most, the
    # JAX result has no low words); true residuals both under 1e-8;
    # the ranks' evecs_hi + evecs_lo equal their rows of the port's
    # single-device polish of the same (gathered) vectors within 1e-12;
    # the polish from the gathered global vectors gives the bits of the
    # polish from the rank's rows.
    d, _ = inputs
    res = ranks(world)
    rj = jax_refined("refined_free", world)
    pj = fdt.polish_eigenpairs(surrogate_hamiltonian(2048, dtype=jnp.float32),
                               rj, iterations=worker.POLISH_ITERATIONS)
    r0 = res[0]
    lam = (r0["polish_evals"].astype(np.float64)
           + r0["polish_evals_lo"].astype(np.float64))
    lam_j = np.asarray(pj.evals, np.float64)
    np.testing.assert_allclose(lam, lam_j, rtol=np.finfo(np.float32).eps,
                               atol=1e-9)
    assert np.max(r0["polish_errors"]) < 1e-8
    assert np.max(np.asarray(pj.errors)) < 1e-8
    for r in res:
        assert bool(r["polish_global_same"])
        np.testing.assert_array_equal(r["polish_evals"], r0["polish_evals"])
    op = worker.free_apply_ops(2048)["free32"]
    one = fdtt.DavidsonResult(
        eigenvalues=torch.from_numpy(r0["polish_input_evals"]),
        eigenvectors=torch.from_numpy(_gathered(res, "polish_input")),
        iterations=0, converged=True, converged_pairs=None,
        residual_norms=None, residual_history=None, subspace_dims=None)
    pol = fdtt.polish_eigenpairs(op, one,
                                 iterations=worker.POLISH_ITERATIONS)
    x = to_numpy(pol.evecs_hi).astype(np.float64) + to_numpy(pol.evecs_lo)
    np.testing.assert_allclose(_gathered(res, "polish_x"), x, rtol=0,
                               atol=1e-12)


# -- the scaling audit (parallel.scaling) -------------------------------

def _inventory(r: dict, prefix: str) -> tuple:
    """(stats, records) of an inventory a rank saved
    (``torch_dist_worker._inventory``)."""
    return (json.loads(str(r[f"{prefix}_stats"])),
            json.loads(str(r[f"{prefix}_records"])))


@pytest.mark.parametrize("world", WORLDS)
def test_scaling_probe_is_row_local(ranks, world):
    # One refined iteration of the int8 halo probe at 64 and 128 block rows
    # of 32: byte-identical inventories, no tall collective, the same on
    # every rank; at least one all-reduce, and two permutes (the ring
    # exchange's two sends) per operator apply, the only permutes.
    res = ranks(world)
    small, large = (_inventory(res[0], f"scaling{nbr}")[0]
                    for nbr in worker.SCALING_NBR)
    scaling.assert_n_independent(small, large)
    scaling.audit_no_tall_collectives(small, small["n_local"],
                                      small["m_max"])
    assert small["n_devices"] == world and small["n"] < large["n"]
    for r in res[1:]:
        assert _inventory(r, "scaling64") == _inventory(res[0], "scaling64")
    for nbr, stats in zip(worker.SCALING_NBR, (small, large)):
        applies = int(res[0][f"scaling{nbr}_applies"])
        kinds = stats["by_kind"]
        assert kinds["all-reduce"]["count"] >= 1
        assert applies >= 1 and stats["exchanges"] == applies
        assert kinds["collective-permute"]["count"] == 2 * applies
        assert stats["moved_bytes"] == (0 if world == 1
                                        else stats["total_bytes"])


def test_scaling_probe_agrees_across_world_sizes(ranks):
    # The same calls at every world size, in the same order, with the same
    # payloads, except each all-gather of the ranks' double-single
    # partials (``RowShardConstraint.sum_ds``): its result holds one
    # partial per rank, so it grows with the world size, not with n.
    one = _inventory(ranks(1)[0], "scaling64")[1]
    for world in WORLDS[1:]:
        recs = _inventory(ranks(world)[0], "scaling64")[1]
        assert [r[0] for r in recs] == [r[0] for r in one]
        for (kind, b, shape, _), (_, b1, shape1, _) in zip(recs, one):
            if kind == "all-gather":
                assert shape == [world * shape1[0], *shape1[1:]]
                assert b == world * b1
            else:
                assert (b, shape) == (b1, shape1)


def test_scaling_verdict_matches_jax(ranks):
    # The JAX package's compiled probe at 4 devices on the same shape gets
    # the port's verdicts: n-independent and row-local. The bytes are not
    # held equal: GSPMD combines the all-reduces and pads the width to
    # 128 lanes, where the port sends each call at the active width.
    res = ranks(4)
    small, large = (_inventory(res[0], f"scaling{nbr}")[0]
                    for nbr in worker.SCALING_NBR)
    j_small, j_large = (jscaling.probe_compiled_collectives(
        n_devices=4, nbr=nbr, bs=worker.SCALING_BS)
        for nbr in worker.SCALING_NBR)
    for check in (jscaling.assert_n_independent, scaling.assert_n_independent):
        check(j_small, j_large)
        check(small, large)
    for audit in (jscaling.audit_no_tall_collectives,
                  scaling.audit_no_tall_collectives):
        audit(j_small, j_small["n_local"], j_small["m_max"])
        audit(small, small["n_local"], small["m_max"])
    print(f"per-iteration collectives at 4 ranks, n={small['n']}: the port "
          f"{small['total_bytes']} B in {small['total_count']} calls "
          f"(m_max ceiling {small['m_max_ceiling_bytes']} B), the JAX "
          f"package {j_small['total_bytes']} B in {j_small['total_count']}")


def test_gathering_rule_fails_both_audits(ranks):
    # The ELL rule all-gathers x: its inventory grows with n and its
    # gathered block (m_max = 2k at 2 ranks) is a full local panel; both
    # audits fail with the JAX package's texts.
    small, large = (_inventory(ranks(2)[0], f"gather{n}")[0]
                    for n in worker.GATHER_N)
    for check, match in ((scaling.assert_n_independent, "scales with n"),
                         (jscaling.assert_n_independent, "scales with n")):
        with pytest.raises(AssertionError, match=match):
            check(small, large)
    texts = []
    for audit in (scaling.audit_no_tall_collectives,
                  jscaling.audit_no_tall_collectives):
        with pytest.raises(AssertionError, match="n-scale") as err:
            audit(small, small["n_local"], small["m_max"], small["itemsize"])
        texts.append(str(err.value))
    assert texts[0] == texts[1]
    assert small["largest"][0].endswith(
        f"f64[{small['n']},{worker.GATHER['lowest']}] all-gather")


@pytest.mark.parametrize("world", WORLDS)
def test_row_divisor_folds_as_the_ranks(ranks, inputs, world):
    # The ranks' double-single folds of their rows (each rank's tree, the
    # partials cascaded in rank order) are the one-device folds under
    # sum_strategy("tree", row_divisor=world), bit for bit.
    d, _ = inputs
    x, y = torch.from_numpy(d["ds_x"]), torch.from_numpy(d["ds_y"])
    with _one_thread(), tds.sum_strategy("tree", row_divisor=world):
        want = {"dot": tds.dot_cols_ds(x, y), "gram": tds.gram_ds(x, y),
                "sumsq": tds.col_sumsq_ds(x)}
    for r in ranks(world):
        for name, folded in want.items():
            np.testing.assert_array_equal(r[f"ds_{name}"],
                                          torch.stack(folded).numpy())


def test_tree_strategy_gives_the_world_one_refined_bits(ranks):
    # Past the cascade's threshold a one-device solve folds by the cascade
    # and a sharded rank by the tree; under sum_strategy("tree") the
    # one-device refined solve takes the world-size-1 sharded bits.
    r0 = ranks(1)[0]
    lowest, opts = worker.REFINED_SOLVES["refined_free"]
    op = tgen.surrogate_hamiltonian(worker.DS_N, dtype=torch.float32,
                                    device="cpu")
    with _one_thread(), tds.sum_strategy("tree"):
        res = fdtt.eigensolve(op, lowest, **opts)
    np.testing.assert_array_equal(res.eigenvalues.numpy(), r0["tall_evals"])
    assert res.iterations == int(r0["tall_iterations"])


# -- argument checks (no process group) --------------------------------

def test_unported_kinds_have_no_sharding_rule():
    mesh = _fake_mesh(2)
    free = fdtt.MatrixFreeOperator(lambda X: X, 64, dtype=torch.float64,
                                   diag=torch.ones(64), device="cpu")

    class Mystery(fdtt.LinearOperator):
        shape, dtype, device = (64, 64), torch.float64, CPU

        def matmat(self, block):
            return block

        def diagonal(self):
            return torch.ones(64, dtype=torch.float64)

    # A per-rank fn beside a global-view ds_fn: refused as well.
    half = fdtt.MatrixFreeOperator(lambda X, rows: X, 64, diag=torch.ones(64),
                                   device="cpu", ds_fn=lambda h, lo: (h, lo))
    for op in (free, half, Mystery()):
        with pytest.raises(OperatorError, match="no sharding rule"):
            tpar.shard_operator(op, mesh)


def test_halo_constructor_checks():
    bsr = fdtt.generate_banded_bsr(16, 8, bandwidth=1, seed=1, device="cpu")
    q = fdtt.quantize_banded_int8(bsr.astype(torch.float32))
    # 16 block rows on 8 ranks: 2 each, narrower than a bandwidth of 3.
    with pytest.raises(OperatorError, match="exceeds local slab"):
        tpar.HaloBSROperator(bsr.block_cols, bsr.blocks, 3, _fake_mesh(8))
    with pytest.raises(OperatorError, match="exceeds local slab"):
        tpar.HaloQuantizedOperator(q.qblocks, q.scale_rows, q.diag, 3,
                                   _fake_mesh(8))
    # 18 block rows do not split over 4 ranks.
    odd = fdtt.generate_banded_bsr(18, 8, bandwidth=1, seed=1, device="cpu")
    oq = fdtt.quantize_banded_int8(odd.astype(torch.float32))
    for build in (lambda m: tpar.HaloBSROperator.from_bsr(odd, 1, m),
                  lambda m: tpar.HaloQuantizedOperator.from_quantized(oq, m),
                  lambda m: tpar.shard_operator(odd, m),
                  lambda m: tpar.shard_operator(oq, m)):
        with pytest.raises(OperatorError, match="not divisible"):
            build(_fake_mesh(4))
    # The quantized halo needs DIA-aligned storage, as in JAX.
    with pytest.raises(OperatorError, match="K == 2"):
        tpar.HaloQuantizedOperator(q.qblocks, q.scale_rows, q.diag, 2,
                                   _fake_mesh(1))


def test_pallas_remote_names_kernel_8(monkeypatch):
    # "pallas-remote" applies through kernel 8 in two launches, interior
    # then edge; at world size 1 the exchange needs no process group.
    bsr = fdtt.generate_banded_bsr(16, 8, bandwidth=1, seed=1, device="cpu")
    h = tpar.HaloBSROperator.from_bsr(bsr, 1, _fake_mesh(1),
                                      backend="pallas-remote")
    assert h.backend == "pallas-remote"
    launches = []
    kernel8 = kernels.banded_remote_halo_spmm

    def spy(*args, rows, **kw):
        launches.append(rows)
        return kernel8(*args, rows=rows, **kw)
    monkeypatch.setattr(kernels, "banded_remote_halo_spmm", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((128, 3)))
    torch.testing.assert_close(h.matmat(x), bsr.matmat(x), rtol=0,
                               atol=1e-12)
    assert launches == ["interior", "edge"]
    # DIA-aligned storage only (K == 2*bw+1), as "pallas".
    with pytest.raises(OperatorError, match="K == 2"):
        tpar.HaloBSROperator.from_bsr(bsr, 2, _fake_mesh(1),
                                      backend="pallas-remote")
    with pytest.raises(OperatorError, match="unknown halo backend"):
        tpar.HaloBSROperator.from_bsr(bsr, 1, _fake_mesh(2), backend="mosaic")


def test_multihost_refuses_a_local_fallback(monkeypatch):
    # WORLD_SIZE=2 and no rendezvous: init_process_group fails, and a
    # one-rank group in its place would disagree with the other process.
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.is_coordinator()


def test_world_size_one_shard_is_a_view():
    bsr = fdtt.generate_banded_bsr(16, 8, bandwidth=1, seed=1, device="cpu")
    h = tpar.HaloBSROperator.from_bsr(bsr, 1, _fake_mesh(1), backend="pallas")
    assert h.blocks.data_ptr() == bsr.blocks.data_ptr()
    q = fdtt.quantize_banded_int8(bsr.astype(torch.float32))
    hq = tpar.shard_operator(q, _fake_mesh(1))
    assert hq.qblocks.data_ptr() == q.qblocks.data_ptr()
    # On two ranks, rank 1 keeps the second half of the rows.
    h1 = tpar.HaloBSROperator.from_bsr(bsr, 1, _fake_mesh(2, 1))
    assert torch.equal(h1.blocks, bsr.blocks[8:])
    assert h1.shape == bsr.shape


@pytest.mark.parametrize("kind", ["bsr", "int8", "remote"])
def test_convert_halo_reads_the_jax_tables(jax_ops, kind):
    jmesh = jpar.default_mesh(2)
    if kind == "int8":
        j = jpar.HaloQuantizedOperator.from_quantized(jax_ops["int8_1"],
                                                      jmesh, backend="xla")
        names = ("qblocks", "scale_rows", "diag")
    else:
        j = jpar.HaloBSROperator.from_bsr(
            jax_ops["halo1"], 1, jmesh,
            backend="pallas-remote" if kind == "remote" else "pallas")
        names = ("block_cols", "blocks")
    t = convert.halo(j, _fake_mesh(2, 1))
    assert type(t).__name__ == type(j).__name__ and t.backend == j.backend
    assert t.shape == j.shape and t.bandwidth == j.bandwidth
    for name in names:
        full = np.asarray(getattr(j, name))
        np.testing.assert_array_equal(to_numpy(getattr(t, name)),
                                      full[full.shape[0] // 2:])


@pytest.mark.parametrize("divisor", [1, 2, 4])
def test_memory_clamp_sizes_the_local_rows(monkeypatch, divisor):
    # A budget that clamps the default width: the sharded solve sizes it by
    # the rows one rank holds, as the JAX package does.
    monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", "1e8")
    n, k = 65536, 8
    opts = fdtt.DavidsonOptions()
    kw = dict(generalized=False, sharded=True, shard_row_divisor=divisor)
    t = tconfig.resolve_options(opts, k, n, device="cpu", **kw)
    j = jconfig.resolve_options(fdt.DavidsonOptions(), k, n, **kw)
    assert (t.max_dim, t.m_max) == (j.max_dim, j.m_max)
    unsharded = tconfig.resolve_options(opts, k, n, False, device="cpu")
    assert (t.m_max > unsharded.m_max) == (divisor > 1)
