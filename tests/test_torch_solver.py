"""The slice as a whole: the same problems, built once by the JAX package
and handed over as numpy, through ``fortran_davidson_tpu.eigensolve`` and
``fortran_davidson_tpu_torch.eigensolve``.

Matching (ROADMAP): eigenvalues to 1e-10, iteration counts within ±1
(exactly where ``tests/test_regression.py`` pins them), the same
``converged`` flag, and the port's true residuals ||Ax - λBx|| at or
below the tolerance.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.models.generators import (bse_surrogate,
                                                    generate_diagonal_dominant)
from fortran_davidson_tpu.ops.sparse import generate_banded_bsr
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError)
from tests.test_regression import PINNED_EIGENVALUES, PINNED_ITERS
from tests.torch_parity import (assert_parity, solve_both, to_numpy,
                                true_residuals)


def _dd(n, key, diag_val=None, sparsity=1e-3):
    return np.array(generate_diagonal_dominant(
        n, sparsity, diag_val=diag_val, key=jax.random.PRNGKey(key)))


# The DPR cases of tests/test_parity.py: (n, k, max_dim, generalized, tol).
PARITY_DPR = [
    (50, 3, None, False, 1e-8),
    (50, 3, 10, True, 1e-8),
    (100, 3, 10, True, 1e-5),
    (80, 2, 8, False, 1e-8),   # forces repeated collapses
]


@pytest.mark.parametrize("n,k,max_dim,gen,tol", PARITY_DPR)
def test_parity_dpr(n, k, max_dim, gen, tol):
    A = _dd(n, n + k)
    B = _dd(n, n + k + 1, diag_val=1.0) if gen else None
    rj, rt = solve_both(A, k, B, method="DPR", tolerance=tol,
                        max_dim_sub=max_dim, max_iterations=500)
    assert rt.converged
    assert_parity(rj, rt, A, tol, B)


def test_bse_regression_dpr():
    A = np.asarray(bse_surrogate())
    rj, rt = solve_both(A, 6, method="DPR", tolerance=1e-4, max_iterations=50,
                        max_dim_sub=18)
    assert rt.converged
    assert rt.iterations == PINNED_ITERS["DPR"] == int(rj.iterations)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues), PINNED_EIGENVALUES,
                               atol=5e-6)
    assert_parity(rj, rt, A, 1e-4, exact_iterations=True)


def test_banded_bsr_repeated_collapses():
    op = generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1, seed=0)
    rj, rt = solve_both(op, 3, max_dim_sub=12)
    dims = to_numpy(rt.subspace_dims)[:rt.iterations]
    assert np.any(np.diff(dims) < 0), f"no collapse in {dims}"
    np.testing.assert_array_equal(
        dims, np.asarray(rj.subspace_dims)[:int(rj.iterations)])
    assert_parity(rj, rt, np.asarray(op.to_dense()), 1e-8)


def test_lowest_k_expansion():
    A = _dd(300, 5, sparsity=1.0)
    rj, rt = solve_both(A, 4, tolerance=1e-8, max_iterations=400,
                        expansion="lowest-k")
    assert rt.converged and not rt.stalled
    assert rt.operator_columns == int(rj.operator_columns)
    assert_parity(rj, rt, A, 1e-8)


@pytest.mark.parametrize("expansion", ["doubling", "lowest-k"])
def test_warm_start(expansion):
    A = _dd(300, 5, sparsity=1.0)
    cold = fdtt.eigensolve(torch.from_numpy(A), 4, tolerance=1e-8,
                           max_iterations=400)
    X0 = (to_numpy(cold.eigenvectors)
          + 1e-3 * np.random.default_rng(0).standard_normal((300, 4)))
    rj, rt = solve_both(A, 4, tolerance=1e-8, max_iterations=400,
                        initial_vectors=X0, expansion=expansion)
    assert rt.iterations <= cold.iterations
    assert_parity(rj, rt, A, 1e-8)


def test_olsen_and_float32():
    A = _dd(120, 9, sparsity=1e-2)
    rj, rt = solve_both(A, 3, method="OLSEN", tolerance=1e-9)
    assert_parity(rj, rt, A, 1e-9)
    rj, rt = solve_both(A, 3, dtype="float32", tolerance=1e-4)
    assert rt.eigenvalues.dtype == torch.float32
    assert_parity(rj, rt, A, 1e-4, eig_atol=1e-4)


def test_matrix_free_generalized_surrogates():
    import fortran_davidson_tpu as fdt
    from fortran_davidson_tpu.models import generators as jgen
    n, k = 400, 3
    rj = fdt.eigensolve(jgen.surrogate_hamiltonian(n, 1e-3), k,
                        second_matrix=jgen.surrogate_overlap(n, 1e-4))
    rt = fdtt.eigensolve(tgen.surrogate_hamiltonian(n, 1e-3, device="cpu"), k,
                         second_matrix=tgen.surrogate_overlap(n, 1e-4,
                                                              device="cpu"))
    eye = torch.eye(n, dtype=torch.float64)
    A = to_numpy(tgen.surrogate_hamiltonian(n, 1e-3, device="cpu").matmat(eye))
    B = to_numpy(tgen.surrogate_overlap(n, 1e-4, device="cpu").matmat(eye))
    assert_parity(rj, rt, A, 1e-8, B)


def test_result_layout_and_history():
    A = _dd(50, 53)
    rt = fdtt.eigensolve(torch.from_numpy(A), 3, max_iterations=20)
    assert rt.residual_history.shape == (20, 3)
    assert rt.subspace_dims.shape == (20,)
    hist = to_numpy(rt.residual_history)
    assert np.all(np.isfinite(hist[:rt.iterations]))
    assert np.all(np.isnan(hist[rt.iterations:]))
    assert np.all(to_numpy(rt.subspace_dims)[rt.iterations:] == 0)
    assert rt.eigenvectors.shape == (50, 3) and rt.converged_pairs.all()
    res = true_residuals(A, rt.eigenvectors, rt.eigenvalues)
    np.testing.assert_allclose(res, to_numpy(rt.residual_norms), atol=1e-10)


def test_invalid_inputs_raise():
    A = torch.from_numpy(_dd(30, 1))
    with pytest.raises(OperatorError):
        fdtt.eigensolve(torch.zeros((4, 5), dtype=torch.float64), 1)
    with pytest.raises(InvalidOptionsError):
        fdtt.eigensolve(A, 31)
    with pytest.raises(OperatorError):
        fdtt.eigensolve(A, 2, second_matrix=torch.eye(29, dtype=torch.float64))
    with pytest.raises(OperatorError):
        fdtt.eigensolve(A, 2, initial_vectors=torch.zeros((30, 5)))
    with pytest.raises(InvalidOptionsError):
        fdtt.eigensolve(A, 2, method="nonsense")
    with pytest.raises(ValueError):
        fdtt.eigensolve(A, 2, dtype="bfloat16")


def test_generalized_eigensolver_warns_without_convergence():
    A = torch.from_numpy(_dd(60, 2, sparsity=1.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = fdtt.generalized_eigensolver(A, 3, max_iterations=2)
    assert not res.converged and res.iterations == 2
    assert any("did not converge" in str(w.message) for w in caught)
