"""The port's entry points run on the card unless asked for the CPU.

Every entry point that builds tensors from numpy, Python values or a seed
resolves its device through ``utils.dtypes.default_device``: ``None``
means ``cuda``, and with no card it raises ``DeviceUnavailableError``
(which says to pass ``device="cpu"``) rather than drop to the CPU. The
first test pretends there is a card and stops each entry point at the
resolver, before it allocates anything; the second takes the card away.
"""

import sys
import tempfile

import numpy as np
import pytest
import scipy.sparse
import torch

import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch import __main__ as cli
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.config import validate_initial_vectors
from fortran_davidson_tpu_torch.examples import (benchmark_free, demo,
                                                 northstar)
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.parallel import mesh as tmesh
from fortran_davidson_tpu_torch.parallel import multihost
from fortran_davidson_tpu_torch.utils import dtypes

_RNG = np.random.default_rng(0)
_A = np.eye(16) + 1e-3 * _RNG.standard_normal((16, 16))
_COLS = np.array([[0, 0, 1], [0, 1, 1]], np.int32)
_BLOCKS = _RNG.standard_normal((2, 4, 12))


def _cli_solve():
    """``python -m fortran_davidson_tpu_torch solve`` on a .npy file."""
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/A.npy"
        np.save(path, _A)
        return cli.main(["solve", path])


def _cli_solve_csr():
    """The same on an .npz of scipy CSR members (an ELLOperator)."""
    csr = scipy.sparse.csr_matrix(_A)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/A.npz"
        np.savez(path, data=csr.data, indices=csr.indices, indptr=csr.indptr,
                 shape=np.asarray(csr.shape))
        return cli.main(["solve", path])


def _checkpointed():
    """``eigensolve_checkpointed`` on numpy, into a fresh directory."""
    with tempfile.TemporaryDirectory() as d:
        return fdtt.eigensolve_checkpointed(_A, 2, d)


_LOCAL = fdtt.generate_local_sparse(64, 4, locality=4.0, seed=0)


# Each entry point given numpy (or nothing but sizes and a seed) and no
# device.
ENTRY_POINTS = {
    "eigensolve": lambda: fdtt.eigensolve(_A, 2),
    "as_operator": lambda: fdtt.as_operator(_A),
    "DenseOperator": lambda: fdtt.DenseOperator(_A),
    "DiagonalOperator": lambda: fdtt.DiagonalOperator(np.arange(1.0, 5.0)),
    "MatrixFreeOperator": lambda: fdtt.MatrixFreeOperator(
        lambda X: X, 8, dtype=torch.float64, diag=np.ones(8)),
    "from_element_fn": lambda: fdtt.from_element_fn(
        lambda i, j: (i == j).double(), 8),
    "BSROperator": lambda: fdtt.BSROperator(_COLS, _BLOCKS),
    "BSROperator.from_block_coo": lambda: fdtt.BSROperator.from_block_coo(
        [0, 1], [0, 1], _RNG.standard_normal((2, 4, 4)), 2),
    "BSROperator.from_dense": lambda: fdtt.BSROperator.from_dense(_A, 4),
    "QuantizedBandedOperator": lambda: fdtt.QuantizedBandedOperator(
        np.zeros((2, 4, 12), np.int8), np.ones((2, 12), np.float32),
        np.ones((2, 4), np.float32), 1),
    "generate_banded_bsr": lambda: fdtt.generate_banded_bsr(4, 4, seed=0),
    "generate_banded_bsr_quantized":
        lambda: fdtt.generate_banded_bsr_quantized(4, 4, seed=0),
    "bse_surrogate": lambda: tgen.bse_surrogate(16),
    "surrogate_hamiltonian": lambda: tgen.surrogate_hamiltonian(16),
    "surrogate_overlap": lambda: tgen.surrogate_overlap(16),
    "validate_initial_vectors": lambda: validate_initial_vectors(
        np.ones((16, 2)), 16, 4, "float64"),
    "convert.dense": lambda: convert.dense(_A),
    "convert.bsr": lambda: convert.bsr(_COLS, _BLOCKS),
    "convert.quantized": lambda: convert.quantized(
        np.zeros((2, 4, 12), np.int8), np.ones((2, 12), np.float32),
        np.ones((2, 4), np.float32), 1),
    "convert.diagonal": lambda: convert.diagonal(np.arange(1.0, 5.0)),
    "parallel.mesh_device": lambda: tmesh.mesh_device(),
    "parallel.multihost.initialize": lambda: multihost.initialize(),
    "generate_diagonal_dominant":
        lambda: tgen.generate_diagonal_dominant(16, 1e-3),
    "ELLOperator": lambda: fdtt.ELLOperator(np.zeros((4, 2), np.int32),
                                            np.ones((4, 2))),
    "ELLOperator.from_coo": lambda: fdtt.ELLOperator.from_coo(*_LOCAL, 64),
    "ELLOperator.from_csr": lambda: fdtt.ELLOperator.from_csr(
        [0, 1, 2], [0, 1], [1.0, 2.0]),
    "ELLOperator.from_dense": lambda: fdtt.ELLOperator.from_dense(_A),
    "SlicedELLOperator.from_coo":
        lambda: fdtt.SlicedELLOperator.from_coo(*_LOCAL, 64),
    "split_band_remainder": lambda: fdtt.split_band_remainder(
        *_LOCAL, 64, block_size=8),
    "split_band_remainder rcm": lambda: fdtt.split_band_remainder(
        *_LOCAL, 64, block_size=8, reorder="rcm"),
    "generate_sparse_diagonal_dominant":
        lambda: fdtt.generate_sparse_diagonal_dominant(64, 4),
    "as_operator(scipy csr)": lambda: fdtt.as_operator(
        scipy.sparse.csr_matrix(_A)),
    "eigensolve(scipy csr)": lambda: fdtt.eigensolve(
        scipy.sparse.csr_matrix(_A), 2),
    "convert.ell": lambda: convert.ell(np.zeros((4, 2), np.int32),
                                       np.ones((4, 2))),
    "convert.sliced_ell": lambda: convert.sliced_ell(
        [np.zeros(1, np.int32)], [np.zeros((1, 1), np.int32)],
        [np.ones((1, 1))], np.zeros(4, np.int32)),
    "eigsh": lambda: fdtt.eigsh(_A, k=2),
    "eigsh(scipy csr)": lambda: fdtt.eigsh(scipy.sparse.csr_matrix(_A), k=2),
    "eigsh sigma": lambda: fdtt.eigsh(_A, k=2, sigma=1.0),
    "eigensolve_batched": lambda: fdtt.eigensolve_batched(
        np.stack([_A, _A]), 2),
    "eigensolve_batched diagonal": lambda: fdtt.eigensolve_batched(
        np.arange(1.0, 17.0).reshape(2, 8), 1),
    "eigensolve_checkpointed": _checkpointed,
    "cli.solve": _cli_solve,
    "cli.solve CSR .npz": _cli_solve_csr,
    "cli.demo": lambda: cli.main(["demo"]),
    "examples.demo": lambda: demo.main([]),
    "examples.benchmark_free": lambda: benchmark_free.main([]),
    "examples.northstar": lambda: northstar.main(["--n", "1024"]),
    "examples.northstar --mode banded --quantize": lambda: northstar.main(
        ["--mode", "banded", "--quantize", "--n", "1024", "--block-size",
         "16"]),
}


class _Resolved(Exception):
    """Raised by the spy once the resolver has answered."""


@pytest.fixture
def spy(monkeypatch):
    """Wrap ``default_device`` in every module of the port that holds it:
    record what it resolves to and stop the entry point there."""
    seen = []
    real = dtypes.default_device

    def resolve(device=None):
        seen.append(real(device))
        raise _Resolved

    for name, module in list(sys.modules.items()):
        if (name.startswith("fortran_davidson_tpu_torch")
                and getattr(module, "default_device", None) is real):
            monkeypatch.setattr(module, "default_device", resolve)
    return seen


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_resolve_to_the_card(monkeypatch, spy, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_Resolved):
        ENTRY_POINTS[entry]()
    assert spy == [torch.device("cuda")]


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_without_a_card_raise(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(fdtt.DeviceUnavailableError, match="device='cpu'"):
        ENTRY_POINTS[entry]()


def test_tensors_keep_their_device_and_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # A tensor follows its own device; numpy goes where it is told.
    assert fdtt.as_operator(torch.from_numpy(_A)).device.type == "cpu"
    assert fdtt.as_operator(_A, device="cpu").device.type == "cpu"
    res = fdtt.eigensolve(torch.from_numpy(_A), 2)
    assert res.eigenvalues.device.type == "cpu"
    assert dtypes.default_device("cpu") == torch.device("cpu")
