"""The port's entry points run on the card unless asked for the CPU.

Every entry point that builds tensors from numpy, Python values or a seed
resolves its device through ``utils.dtypes.default_device``: ``None``
means ``cuda``, and with no card it raises ``DeviceUnavailableError``
(which says to pass ``device="cpu"``) rather than drop to the CPU. The
first test pretends there is a card and stops each entry point at the
resolver, before it allocates anything; the second takes the card away.
"""

import sys

import numpy as np
import pytest
import torch

import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.config import validate_initial_vectors
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.parallel import mesh as tmesh
from fortran_davidson_tpu_torch.parallel import multihost
from fortran_davidson_tpu_torch.utils import dtypes

_RNG = np.random.default_rng(0)
_A = np.eye(16) + 1e-3 * _RNG.standard_normal((16, 16))
_COLS = np.array([[0, 0, 1], [0, 1, 1]], np.int32)
_BLOCKS = _RNG.standard_normal((2, 4, 12))

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
