"""The port's command line (``python -m fortran_davidson_tpu_torch``) and
its text I/O (``utils/io.py``) against the JAX package's.

Each ``main(argv)`` runs in this process (the JAX package's
``tests/test_cli.py`` spawns one process a case). The matrices are the
JAX package's 60-row fixture, written to disk by its ``utils.io``; the
port's solves run on the CPU (``--platform cpu``).
"""

import json

import jax
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch.distributed as dist

from fortran_davidson_tpu.__main__ import main as jax_main
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.utils import io as jio
from fortran_davidson_tpu_torch.__main__ import main
from fortran_davidson_tpu_torch.utils import io as tio


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The 60-row fixture A (and the B of the reference's demo) as .txt
    (written by the JAX package), .npy and .npz."""
    d = tmp_path_factory.mktemp("cli")
    A = np.asarray(generate_diagonal_dominant(60, 1e-3))
    B = np.asarray(generate_diagonal_dominant(60, 1e-3, diag_val=1.0,
                                              key=jax.random.PRNGKey(1)))
    paths = {"txt": str(d / "A.txt"), "npy": str(d / "A.npy"),
             "npz": str(d / "A.npz"), "B": str(d / "B.npy")}
    jio.write_matrix(paths["txt"], A)
    np.save(paths["npy"], A)
    np.savez(paths["npz"], matrix=A)
    np.save(paths["B"], B)
    return A, B, paths


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _solve(capsys, *args):
    """The port's ``solve`` on the CPU: its exit code and JSON line."""
    rc = main(["solve", *args, "--platform", "cpu"])
    return rc, _last_json(capsys)


@pytest.mark.parametrize("kind", ["matrix", "vector"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_io_reads_the_other_packages_files_bit_equal(tmp_path, kind, writer):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((6, 4) if kind == "matrix" else 17)
    write, read = ((jio, tio) if writer == "jax" else (tio, jio))
    path = tmp_path / f"{kind}.txt"
    getattr(write, f"write_{kind}")(path, data)
    got = getattr(read, f"read_{kind}")(path)
    want = getattr(write, f"read_{kind}")(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    # The text format keeps every bit of a float64 (savetxt's %.18e).
    assert np.array_equal(got.reshape(data.shape), data)


@pytest.mark.parametrize("fmt", ["txt", "npy", "npz"])
def test_solve_matches_the_jax_cli(files, capsys, fmt):
    A, _, paths = files
    args = [paths[fmt], "-k", "3", "--tolerance", "1e-8"]
    assert jax_main(["solve", *args]) == 0
    want = _last_json(capsys)
    rc, got = _solve(capsys, *args)
    assert rc == 0 and got["converged"]
    assert set(got) == set(want)
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=0, atol=1e-9)
    assert abs(got["iterations"] - want["iterations"]) <= 1
    exact = scipy.linalg.eigh(A, eigvals_only=True)[:3]
    np.testing.assert_allclose(got["eigenvalues"], exact, rtol=0, atol=1e-9)


def test_solve_second_matrix(files, capsys):
    A, B, paths = files
    rc, got = _solve(capsys, paths["npy"], "-k", "3", "--second-matrix",
                     paths["B"])
    assert rc == 0 and got["converged"]
    want = scipy.linalg.eigh(A, B, eigvals_only=True)[:3]
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=0, atol=1e-9)


def test_solve_writes_eigenvectors_and_reads_a_warm_start(files, capsys,
                                                          tmp_path):
    A, _, paths = files
    vec = str(tmp_path / "V.npy")
    rc, cold = _solve(capsys, paths["npy"], "-k", "2", "--eigenvectors", vec)
    assert rc == 0
    V = np.load(vec)
    assert V.shape == (60, 2)
    lam = np.asarray(cold["eigenvalues"])
    assert np.linalg.norm(A @ V - V * lam[None, :], axis=0).max() < 1e-7
    rc, warm = _solve(capsys, paths["npy"], "-k", "2", "--initial-vectors",
                      vec)
    assert rc == 0 and warm["iterations"] <= cold["iterations"]
    np.testing.assert_allclose(warm["eigenvalues"], lam, rtol=0, atol=1e-9)


def test_solve_sharded_on_one_rank(files, capsys, tmp_path):
    A, _, paths = files
    vec = str(tmp_path / "V.npy")
    try:
        rc, got = _solve(capsys, paths["npy"], "-k", "3", "--sharded",
                         "--eigenvectors", vec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rc == 0
    want = scipy.linalg.eigh(A, eigvals_only=True)[:3]
    np.testing.assert_allclose(got["eigenvalues"], want, rtol=0, atol=1e-9)
    V = np.load(vec)
    lam = np.asarray(got["eigenvalues"])
    assert V.shape == (60, 3)
    assert np.linalg.norm(A @ V - V * lam[None, :], axis=0).max() < 1e-7


def test_nonconvergence_exits_1(files, capsys):
    _, _, paths = files
    rc, got = _solve(capsys, paths["txt"], "-k", "2", "--max-iterations",
                     "1", "--tolerance", "1e-14")
    assert rc == 1 and not got["converged"]


def test_scipy_csr_npz_raises_by_name(files, tmp_path, capsys):
    # The name is kept from when the port refused CSR input by name (the
    # ELL operator was missing): a CSR .npz now becomes an ELLOperator, as
    # in the JAX CLI, and its solve must match the JAX CLI's.
    A, _, _ = files
    csr = sp.csr_matrix(A)
    path = tmp_path / "A.npz"
    np.savez(path, data=csr.data, indices=csr.indices, indptr=csr.indptr,
             shape=np.asarray(csr.shape))
    args = [str(path), "-k", "3", "--tolerance", "1e-8"]
    assert jax_main(["solve", *args]) == 0
    want = _last_json(capsys)
    rc, got = _solve(capsys, *args)
    assert rc == 0 and got["converged"] == want["converged"] is True
    assert abs(got["iterations"] - want["iterations"]) <= 1
    np.testing.assert_allclose(got["eigenvalues"], want["eigenvalues"],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got["eigenvalues"],
                               scipy.linalg.eigh(A, eigvals_only=True)[:3],
                               rtol=0, atol=1e-8)
