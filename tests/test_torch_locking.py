"""Locking (deflation of converged pairs) in the port, held to the JAX
package on ``tests/test_locking.py``'s problem: converged pairs keep
their Ritz vectors in the basis but spend no correction column, so the
eigenvalues stay and ``operator_columns`` drops.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.models.generators import bse_surrogate
from tests.torch_parity import assert_parity


@pytest.fixture(scope="module")
def spread_problem():
    # A clustered BSE-style spectrum whose pairs converge at spread-out
    # iterations (tests/test_locking.py).
    return np.array(bse_surrogate(400, coupling=2e-3))


@pytest.mark.parametrize("locking", [False, True])
@pytest.mark.parametrize("method", ["DPR", "GJD"])
def test_locking_matches_jax(spread_problem, method, locking):
    A = spread_problem
    kwargs = dict(method=method, tolerance=1e-9, expansion="lowest-k",
                  max_dim_sub=40, max_iterations=60, locking=locking)
    rj = fdt.eigensolve(A, 6, **kwargs)
    rt = fdtt.eigensolve(torch.from_numpy(A), 6, **kwargs)
    assert_parity(rj, rt, A, 1e-9, eig_atol=1e-9)
    assert abs(rt.operator_columns - int(rj.operator_columns)) <= 6


@pytest.mark.parametrize("method", ["DPR", "GJD"])
def test_locking_same_eigenvalues_fewer_columns(spread_problem, method):
    A = torch.from_numpy(spread_problem)
    kwargs = dict(method=method, tolerance=1e-9, expansion="lowest-k",
                  max_dim_sub=40, max_iterations=60)
    base = fdtt.eigensolve(A, 6, locking=False, **kwargs)
    lock = fdtt.eigensolve(A, 6, locking=True, **kwargs)
    assert base.converged and lock.converged and not lock.stalled
    want = scipy.linalg.eigh(spread_problem, eigvals_only=True)[:6]
    np.testing.assert_allclose(base.eigenvalues.numpy(), want, atol=1e-8)
    np.testing.assert_allclose(lock.eigenvalues.numpy(), want, atol=1e-8)
    assert lock.operator_columns < base.operator_columns


def test_locking_does_not_stall(spread_problem):
    res = fdtt.eigensolve(torch.from_numpy(spread_problem), 8, locking=True,
                          tolerance=1e-10, expansion="lowest-k",
                          max_dim_sub=48, max_iterations=80)
    assert res.converged and not res.stalled
    want = scipy.linalg.eigh(spread_problem, eigvals_only=True)[:8]
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, atol=1e-9)


@pytest.mark.parametrize("method", ["DPR", "OLSEN"])
def test_locking_on_the_doubling_schedule(spread_problem, method):
    # Doubling corrects every pair; locking masks the converged wanted ones.
    A = spread_problem
    kwargs = dict(method=method, tolerance=1e-9, locking=True)
    rj = fdt.eigensolve(A, 4, **kwargs)
    rt = fdtt.eigensolve(torch.from_numpy(A), 4, **kwargs)
    assert_parity(rj, rt, A, 1e-9, eig_atol=1e-9)


def test_operator_columns_reported_without_locking(spread_problem):
    res = fdtt.eigensolve(torch.from_numpy(spread_problem), 3,
                          tolerance=1e-8)
    assert res.operator_columns >= 6
