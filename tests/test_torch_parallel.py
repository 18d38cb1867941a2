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
- the ring exchange of ``"pallas-remote"``: the halos equal the
  all-gather's bit for bit, and an apply makes two sends and two
  receives at world sizes 2 and 4 (none at 1) and no collective;
- at world sizes 1 and 2, the ELL family's sharded operators (ELL, sliced
  ELL, hybrid band + remainder) against the global operator, and their
  sharded solves against the port's and the JAX package's
  single-device solves.

The argument checks and ``convert.halo`` need no process group: they use
a :class:`RowMesh` whose group is never called.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu import config as jconfig
from fortran_davidson_tpu import parallel as jpar
from fortran_davidson_tpu.models import generators as jgen
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import config as tconfig
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch import parallel as tpar
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.parallel import multihost
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError)
from tests import torch_dist_worker as worker
from tests.torch_parity import to_numpy

WORLDS = (1, 2, 4)
CPU = torch.device("cpu")


def _fake_mesh(size: int, rank: int = 0) -> tpar.RowMesh:
    """A mesh for checks that run before any collective."""
    return tpar.RowMesh(group=None, size=size, rank=rank, device=CPU)


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
    return ops


@pytest.fixture(scope="module")
def inputs(jax_ops, tmp_path_factory):
    rng = np.random.default_rng(7)
    d = dict(A=np.asarray(jgen.generate_diagonal_dominant(64, 1e-3)),
             B=np.asarray(jgen.generate_diagonal_dominant(64, 1e-3,
                                                          diag_val=1.0)),
             X0=rng.standard_normal((64, 2)),
             X=rng.standard_normal((512, 6)),
             Xq=rng.standard_normal((256, 4)).astype(np.float32))
    d.update(X32=rng.standard_normal((1024, 5)).astype(np.float32),
             Xs=rng.standard_normal((64, 3)))
    # The ELL family's cases: a 500-row locality-bearing COO (the hybrid
    # pads it to 512 rows, 32 block rows of 16).
    rows, cols, vals = jsparse.generate_local_sparse(500, 6, locality=20.0,
                                                     seed=41)
    d.update(coo_rows=rows, coo_cols=cols, coo_vals=vals,
             coo_n=np.array(500),
             Xsp=np.random.default_rng(41).standard_normal((512, 4)))
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
    # Per rank and apply: two sends and two receives to the ring
    # neighbours (none at world size 1, where the halos are the rank's own
    # rows) and no collective; "pallas" makes one all-gather.
    for r in ranks(world):
        for bw in worker.HALO_BANDS:
            calls = dict(zip(worker.COUNTED,
                             r[f"halo{bw}_pallas-remote_calls"].tolist()))
            p2p = 2 if world > 1 else 0
            assert calls == {**dict.fromkeys(worker.COUNTED, 0),
                             "isend": p2p, "irecv": p2p}, calls
            gathers = dict(zip(worker.COUNTED,
                               r[f"halo{bw}_pallas_calls"].tolist()))
            assert sum(gathers[n] for n in worker.GATHERS) == 1


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
              "remote_f32": jax_ops["solve_remote"],
              "bsr": jax_ops["solve_bsr"],
              "int8": jax_ops["solve_int8"],
              "int8_f64": jax_ops["solve_int8"]}.get(name, d["A"])
        rj = fdt.eigensolve(jA, lowest,
                            second_matrix=d["B"] if name == "pencil" else None,
                            initial_vectors=d["X0"] if name == "warm" else None,
                            **opts)
        A, B, X0 = worker.solve_cases(d)[name]
        rt = fdtt.eigensolve(A, lowest, second_matrix=B, initial_vectors=X0,
                             **opts)
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

    for op in (free, Mystery()):
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


@pytest.mark.parametrize("option", [dict(refined=True)])
def test_sharded_solve_rejects_unported_options(option):
    A = np.asarray(jgen.generate_diagonal_dominant(64, 1e-3))
    with pytest.raises(InvalidOptionsError, match="not ported.*item 19"):
        tpar.eigensolve_sharded(A, 3, _fake_mesh(1), **option)


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
