"""The port's ``eigensolve_batched`` (``batched.py``), held to the JAX
package's vmapped engine and to each problem's single solve on
``tests/test_batched.py``'s inputs: every leaf carries a leading batch
axis, and every problem keeps its own schedule and iteration count.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError)
from tests.test_batched import _batch


def _cpu(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_matches_jax(rj, rt, atol=1e-10):
    its_j = np.asarray(rj.iterations)
    its_t = rt.iterations.numpy()
    assert np.all(np.abs(its_t - its_j) <= 1), (its_t, its_j)
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.eigenvalues.numpy(),
                               np.asarray(rj.eigenvalues), atol=atol)


def test_matches_jax_and_scipy_every_element():
    mats = _batch(6, 100)
    rj = fdt.eigensolve_batched(mats, 3, tolerance=1e-9)
    rt = fdtt.eigensolve_batched(mats, 3, tolerance=1e-9, device="cpu")
    _assert_matches_jax(rj, rt)
    assert bool(torch.all(rt.converged))
    for i in range(6):
        sci = scipy.linalg.eigh(mats[i], eigvals_only=True)[:3]
        np.testing.assert_allclose(rt.eigenvalues[i].numpy(), sci, atol=1e-9)


@pytest.mark.parametrize("opts", [dict(), dict(method="GJD", max_dim_sub=10),
                                  dict(expansion="lowest-k", locking=True),
                                  dict(cheb_degree=4, max_dim_sub=8)])
def test_each_element_is_its_single_solve(opts):
    mats = _batch(4, 80, seed=3)
    res = fdtt.eigensolve_batched(_cpu(mats), 3, tolerance=1e-9, **opts)
    for i in range(4):
        one = fdtt.eigensolve(_cpu(mats[i]), 3, tolerance=1e-9, **opts)
        assert int(res.iterations[i]) == one.iterations
        assert int(res.operator_columns[i]) == one.operator_columns
        assert torch.equal(res.eigenvalues[i], one.eigenvalues)
        torch.testing.assert_close(res.residual_history[i],
                                   one.residual_history, rtol=0, atol=0,
                                   equal_nan=True)


def test_per_problem_iteration_counts_differ():
    rng = np.random.default_rng(9)
    n = 90
    d = np.arange(1, n + 1, dtype=np.float64)
    easy = np.diag(d)
    off = (rng.random((n, n)) - 0.5) * 5e-2
    hard = np.diag(d) + np.triu(off, 1) + np.triu(off, 1).T
    mats = np.stack([easy, hard])
    rj = fdt.eigensolve_batched(mats, 3, tolerance=1e-9)
    rt = fdtt.eigensolve_batched(mats, 3, tolerance=1e-9, device="cpu")
    _assert_matches_jax(rj, rt)
    its = rt.iterations.numpy()
    assert its[0] < its[1]


def test_diagonal_batch():
    diags = np.stack([np.linspace(1.0, 50.0, 64) + 0.3 * i for i in range(3)])
    rj = fdt.eigensolve_batched(diags, 2, tolerance=1e-10)
    rt = fdtt.eigensolve_batched(diags, 2, tolerance=1e-10, device="cpu")
    _assert_matches_jax(rj, rt)
    np.testing.assert_allclose(rt.eigenvalues.numpy(),
                               np.sort(diags, axis=1)[:, :2], atol=1e-10)


def test_dense_pencils():
    mats = _batch(4, 70, seed=5)
    rng = np.random.default_rng(6)
    bs = []
    for _ in range(4):
        off = (rng.random((70, 70)) - 0.5) * 1e-3
        bs.append(np.eye(70) + np.triu(off, 1) + np.triu(off, 1).T)
    bs = np.stack(bs)
    rj = fdt.eigensolve_batched(mats, 3, second_matrices=bs, tolerance=1e-9)
    rt = fdtt.eigensolve_batched(mats, 3, second_matrices=bs, tolerance=1e-9,
                                 device="cpu")
    _assert_matches_jax(rj, rt, atol=1e-9)
    for i in range(4):
        sci = scipy.linalg.eigh(mats[i], bs[i], eigvals_only=True)[:3]
        np.testing.assert_allclose(rt.eigenvalues[i].numpy(), sci, atol=1e-8)


def test_dense_a_diagonal_b():
    mats = _batch(3, 60, seed=7)
    diag_b = np.stack([1.0 + 0.05 * np.random.default_rng(i).random(60)
                       for i in range(3)])
    rj = fdt.eigensolve_batched(mats, 2, second_matrices=diag_b,
                                tolerance=1e-9)
    rt = fdtt.eigensolve_batched(mats, 2, second_matrices=diag_b,
                                 tolerance=1e-9, device="cpu")
    _assert_matches_jax(rj, rt, atol=1e-9)
    for i in range(3):
        sci = scipy.linalg.eigh(mats[i], np.diag(diag_b[i]),
                                eigvals_only=True)[:2]
        np.testing.assert_allclose(rt.eigenvalues[i].numpy(), sci, atol=1e-8)


def test_gjd_batch_counts_inner_iterations():
    mats = _batch(3, 60, seed=11)
    rj = fdt.eigensolve_batched(mats, 2, method="GJD", tolerance=1e-9,
                                max_dim_sub=10)
    rt = fdtt.eigensolve_batched(mats, 2, method="GJD", tolerance=1e-9,
                                 max_dim_sub=10, device="cpu")
    _assert_matches_jax(rj, rt, atol=1e-9)
    assert rt.inner_iterations.shape == (3,)


def test_warm_start_batch():
    mats = _batch(3, 60, seed=13)
    cold = fdtt.eigensolve_batched(mats, 2, tolerance=1e-9, device="cpu")
    warm = fdtt.eigensolve_batched(mats, 2, tolerance=1e-9, device="cpu",
                                   initial_vectors=cold.eigenvectors)
    assert bool(torch.all(warm.converged))
    assert bool(torch.all(warm.iterations <= cold.iterations))
    np.testing.assert_allclose(warm.eigenvalues.numpy(),
                               cold.eigenvalues.numpy(), atol=1e-9)


def test_refined_f32_batch():
    mats = _batch(3, 64, seed=17).astype(np.float32)
    rt = fdtt.eigensolve_batched(_cpu(mats), 2, dtype="float32",
                                 tolerance=1e-6, refined=True,
                                 final_polish=2)
    assert bool(torch.all(rt.converged))
    assert rt.eigenvalues_lo.shape == (3, 2)
    for i in range(3):
        sci = scipy.linalg.eigh(mats[i].astype(np.float64),
                                eigvals_only=True)[:2]
        np.testing.assert_allclose(rt.eigenvalues[i].numpy(), sci, atol=1e-5)


def test_bad_shapes_raise():
    with pytest.raises(OperatorError):
        fdtt.eigensolve_batched(np.ones((4, 5, 6)), 2, device="cpu")
    with pytest.raises(OperatorError):
        fdtt.eigensolve_batched(np.ones((2, 8, 8)), 2, device="cpu",
                                second_matrices=np.ones((3, 8, 8)))
    with pytest.raises(OperatorError):
        fdtt.eigensolve_batched(_batch(2, 40), 2, device="cpu",
                                initial_vectors=np.ones((2, 40, 99)))
    with pytest.raises(OperatorError):
        fdtt.eigensolve_batched(np.ones(5), 1, device="cpu")


def test_chunked_layout_rejected():
    with pytest.raises(InvalidOptionsError, match="chunked"):
        fdtt.eigensolve_batched(_batch(2, 64).astype(np.float32), 2,
                                dtype="float32", refined=True,
                                carry_layout="chunked", device="cpu")


def test_result_leaves_are_batched():
    res = fdtt.eigensolve_batched(_batch(5, 40), 2, tolerance=1e-9,
                                  device="cpu")
    assert res.eigenvalues.shape == (5, 2)
    assert res.eigenvectors.shape == (5, 40, 2)
    for leaf in ("iterations", "converged", "operator_columns", "stalled"):
        assert getattr(res, leaf).shape == (5,)
    assert res.residual_history.shape[0] == 5
    assert res.subspace_dims.shape[0] == 5
    assert res.inner_iterations is None
    assert "eigensolve_batched" in fdtt.__all__ and "eigsh" in fdtt.__all__
