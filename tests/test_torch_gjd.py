"""GJD in the port against the JAX package: the batched MINRES
(``core/krylov.py``), the GJD correction (``core/correction.py``) and the
loop's GJD branch, on numpy-built inputs handed to both.

Matching: the parity cases of ``tests/test_parity.py`` within ±1
iteration and 1e-10 in the eigenvalues; the BSE GJD regression at exactly
its pinned 4 iterations; ``inner_iterations`` within one MINRES step per
corrected column per outer iteration of the JAX package's on the float64
fixtures; MINRES solutions to 1e-12 of ||b||, with the same per-column
step counts. The sharded GJD solves run in ``tests/torch_dist_worker.py``
(``gjd``, ``gjd_warm``, ``gjd_halo``), compared in
``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.core import correction as jcorr
from fortran_davidson_tpu.core.krylov import minres_block as jminres
from fortran_davidson_tpu.models.generators import (bse_surrogate,
                                                    generate_diagonal_dominant)
from fortran_davidson_tpu_torch.core import correction as tcorr
from fortran_davidson_tpu_torch.core.krylov import _stall_params
from fortran_davidson_tpu_torch.core.krylov import minres_block as tminres
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError
from tests.test_regression import PINNED_EIGENVALUES, PINNED_ITERS
from tests.torch_parity import assert_parity, solve_both, to_numpy


def _dd(n, key, diag_val=None, sparsity=1e-3):
    return np.array(generate_diagonal_dominant(
        n, sparsity, diag_val=diag_val, key=jax.random.PRNGKey(key)))


def _inner_close(rj, rt, columns: int):
    """inner_iterations within one step per column per outer iteration."""
    bound = columns * max(int(rj.iterations), rt.iterations)
    assert abs(rt.inner_iterations - int(rj.inner_iterations)) <= bound, (
        rt.inner_iterations, int(rj.inner_iterations))


# The GJD cases of tests/test_parity.py: (n, k, max_dim, generalized, tol).
PARITY_GJD = [(50, 3, None, False, 1e-8), (50, 3, 10, True, 1e-8)]


@pytest.mark.parametrize("n,k,max_dim,gen,tol", PARITY_GJD)
def test_parity_gjd(n, k, max_dim, gen, tol):
    A = _dd(n, n + k)
    B = _dd(n, n + k + 1, diag_val=1.0) if gen else None
    rj, rt = solve_both(A, k, B, method="GJD", tolerance=tol,
                        max_dim_sub=max_dim, max_iterations=500)
    assert rt.converged and rt.inner_iterations > 0
    assert_parity(rj, rt, A, tol, B)
    _inner_close(rj, rt, k)


def test_bse_regression_gjd():
    A = np.asarray(bse_surrogate())
    rj, rt = solve_both(A, 6, method="GJD", tolerance=1e-4,
                        max_iterations=50, max_dim_sub=18)
    assert rt.converged
    assert rt.iterations == PINNED_ITERS["GJD"] == int(rj.iterations)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues), PINNED_EIGENVALUES,
                               atol=5e-6)
    assert_parity(rj, rt, A, 1e-4, exact_iterations=True)


@pytest.mark.parametrize("precond", ["dpr", "olsen"])
def test_preconditioned_gjd_matches_jax(precond):
    A = _dd(60, 11)
    rj, rt = solve_both(A, 3, method="GJD", tolerance=1e-9,
                        gjd_preconditioner=precond)
    assert rt.converged
    assert_parity(rj, rt, A, 1e-9)
    _inner_close(rj, rt, 3)


def test_schedule_validation():
    with pytest.raises(InvalidOptionsError):
        fdtt.DavidsonOptions(gjd_inner_schedule="geometric")
    with pytest.raises(InvalidOptionsError):
        fdtt.DavidsonOptions(gjd_preconditioner="jacobi")


@pytest.mark.parametrize("gen", [False, True])
def test_adaptive_matches_fixed_outer_trajectory(gen):
    n, k = 50, 3
    A = torch.from_numpy(_dd(n, n + k))
    B = torch.from_numpy(_dd(n, n + k + 1, diag_val=1.0)) if gen else None
    runs = {}
    for sched in ("fixed", "adaptive"):
        res = fdtt.eigensolve(A, k, second_matrix=B, method="GJD",
                              tolerance=1e-8, max_dim_sub=10,
                              max_iterations=100, gjd_inner_schedule=sched)
        assert res.converged
        runs[sched] = res
    assert runs["adaptive"].iterations == runs["fixed"].iterations
    assert runs["adaptive"].inner_iterations <= runs["fixed"].inner_iterations
    np.testing.assert_allclose(to_numpy(runs["adaptive"].eigenvalues),
                               to_numpy(runs["fixed"].eigenvalues), atol=1e-8)


def test_relative_tolerance_forcing_converges():
    A = _dd(60, 7)
    rj, rt = solve_both(A, 2, method="GJD", tolerance=1e-9, max_dim_sub=12,
                        max_iterations=100, relative_tolerance=True)
    assert rt.converged
    assert_parity(rj, rt, A, 1e-9 * max(1.0, float(np.abs(A).max())))


def _spd(n, seed, spectrum):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(spectrum) @ Q.T, rng


def test_minres_matches_jax_per_column():
    """The same block solve through both: the same per-column step counts
    (the JAX package returns their maximum) and solutions within 1e-12 of
    ||b||; each column meets its own relative tolerance."""
    A, rng = _spd(80, 3, np.linspace(1.0, 50.0, 80))
    b = rng.standard_normal((80, 2))
    rtol = np.array([1e-10, 1e-3])
    xj, itj = jminres(lambda T: jnp.asarray(A) @ T, jnp.asarray(b),
                      maxiter=200, rtol=jnp.asarray(rtol), return_iters=True)
    At = torch.from_numpy(A)
    xt, itt = tminres(lambda T: At @ T, torch.from_numpy(b), maxiter=200,
                      rtol=torch.from_numpy(rtol), return_iters=True)
    assert itt.shape == (2,) and int(itt.max()) == int(itj)
    assert int(itt[1]) < int(itt[0])
    bn = np.linalg.norm(b, axis=0)
    np.testing.assert_allclose(to_numpy(xt), np.asarray(xj), rtol=0,
                               atol=1e-12 * bn.max())
    res = np.linalg.norm(A @ to_numpy(xt) - b, axis=0)
    assert res[0] <= 1e-9 * bn[0] and res[1] <= 1e-2 * bn[1]


def test_minres_polls_the_host_every_few_steps():
    A, rng = _spd(60, 4, np.linspace(1.0, 30.0, 60))
    b = torch.from_numpy(rng.standard_normal((60, 3)))
    At = torch.from_numpy(A)
    before = tminres.polls
    _, iters = tminres(lambda T: At @ T, b, maxiter=500, rtol=1e-12,
                       return_iters=True)
    polls = tminres.polls - before
    assert polls <= int(iters.max()) // 4 + 2


def test_minres_stall_cutoff_fires_at_f32_floor():
    A, rng = _spd(120, 11, np.geomspace(1.0, 1e4, 120))
    A = A.astype(np.float32)
    b = rng.standard_normal((120, 3)).astype(np.float32)
    At = torch.from_numpy(A)
    x, iters = tminres(lambda T: At @ T, torch.from_numpy(b), maxiter=5000,
                       rtol=1e-12, return_iters=True)
    assert int(iters.max()) < 5000, "stall cutoff should fire before the cap"
    res = np.linalg.norm(A.astype(np.float64) @ to_numpy(x) - b, axis=0)
    assert np.all(res <= 1e-2 * np.linalg.norm(b, axis=0))


def test_minres_stall_window_no_false_trigger_f64():
    A, rng = _spd(150, 5, np.linspace(1.0, 100.0, 150))
    b = rng.standard_normal((150, 4))
    At = torch.from_numpy(A)
    x = tminres(lambda T: At @ T, torch.from_numpy(b), maxiter=2000,
                rtol=1e-12)
    res = np.linalg.norm(A @ to_numpy(x) - b, axis=0)
    assert np.all(res <= 1e-11 * np.linalg.norm(b, axis=0))
    assert _stall_params(torch.float64)[0] >= 4


def test_minres_rate_cutoff_on_slow_progress():
    window32, improvement32 = _stall_params(torch.float32)
    assert improvement32 / window32 >= 0.01 and window32 >= 8
    n = 400
    d_good = torch.linspace(1.0, 2.0, n, dtype=torch.float32)
    d_bad = torch.logspace(-4, 4, n, dtype=torch.float32)

    def matvec(X):
        return torch.stack([d_good * X[:, 0], d_bad * X[:, 1]], dim=1)

    b = torch.ones((n, 2), dtype=torch.float32)
    x, iters = tminres(matvec, b, maxiter=4096, rtol=1e-6, return_iters=True)
    r0 = float(torch.linalg.norm(d_good * x[:, 0] - b[:, 0]))
    assert r0 <= 1e-5 * float(torch.linalg.norm(b[:, 0]))
    assert int(iters.max()) < 1024


def test_minres_f64_slow_but_real_progress_not_cut():
    assert _stall_params(torch.float64) != _stall_params(torch.float32)
    n = 200
    d = torch.from_numpy(np.geomspace(1e-5, 1.0, n))
    b = torch.ones((n, 1), dtype=torch.float64)
    x, iters = tminres(lambda T: d[:, None] * T, b, maxiter=8000,
                       rtol=1e-10, return_iters=True)
    assert float(torch.linalg.norm(d[:, None] * x - b)) <= 1e-9 * float(
        torch.linalg.norm(b))
    assert int(iters.max()) > 200


def test_inner_iterations_telemetry():
    A = _dd(200, 0)
    rj, rt = solve_both(A, 2, method="GJD", tolerance=1e-9)
    assert rt.inner_iterations is not None and rt.inner_iterations > 0
    _inner_close(rj, rt, 2)
    assert fdtt.eigensolve(torch.from_numpy(A), 2, method="DPR",
                           tolerance=1e-9).inner_iterations is None
    # The adaptive schedule never spends more inner work than the fixed
    # one (a refined float32 GJD solve).
    op = tgen.surrogate_hamiltonian(2048, dtype=torch.float32, device="cpu")
    kw = dict(method="GJD", tolerance=1e-5, dtype="float32", refined=True)
    ad = fdtt.eigensolve(op, 2, gjd_inner_schedule="adaptive", **kw)
    fx = fdtt.eigensolve(op, 2, gjd_inner_schedule="fixed", **kw)
    assert ad.converged and fx.converged
    assert ad.inner_iterations <= fx.inner_iterations


def test_gjd_warm_start_cuts_inner_work_same_outer_trajectory():
    # Lowest-4 at 4096 rows takes 3 outer iterations; a solve that ends in
    # 2 has no second correction for the recycled guess to start.
    op = tgen.surrogate_hamiltonian(4096, dtype=torch.float32, device="cpu")
    common = dict(method="GJD", tolerance=1e-8, relative_tolerance=True,
                  dtype="float32", refined=True, final_polish=2,
                  gjd_preconditioner="dpr", expansion="lowest-k",
                  max_iterations=40)
    cold = fdtt.eigensolve(op, 4, gjd_warm_start=False, **common)
    warm = fdtt.eigensolve(op, 4, gjd_warm_start=True, **common)
    assert cold.converged and warm.converged
    assert warm.iterations == cold.iterations
    assert warm.inner_iterations < cold.inner_iterations
    np.testing.assert_allclose(to_numpy(warm.eigenvalues),
                               to_numpy(cold.eigenvalues), rtol=1e-6,
                               atol=1e-8)


def test_gjd_warm_start_parity_pins_hold():
    A = _dd(50, 53)
    kw = dict(method="GJD", tolerance=1e-8, max_dim_sub=10,
              max_iterations=100)
    rj, rt = solve_both(A, 3, gjd_warm_start=True, **kw)
    base = fdtt.eigensolve(torch.from_numpy(A), 3, **kw)
    assert rt.iterations == base.iterations
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               to_numpy(base.eigenvalues), atol=1e-10)
    assert_parity(rj, rt, A, 1e-8)
    _inner_close(rj, rt, 3)


class TestOlsenGJDWarmStart:
    """``tests/test_olsen.py::TestOlsenGJDWarmStart`` through both
    packages' ``gjd_correction`` on the same Ritz data."""

    def _ritz_data(self, A64, k):
        w, V = np.linalg.eigh(A64)
        rng = np.random.default_rng(1)
        X = V[:, :k] + 1e-3 * rng.standard_normal((A64.shape[0], k))
        X /= np.linalg.norm(X, axis=0)
        lam = np.sum(X * (A64 @ X), axis=0)
        return lam, X, A64 @ X - X * lam[None, :]

    def test_warm_start_cuts_inner_iterations(self):
        A64 = _dd(200, 0, sparsity=1e-2)
        lam, X, R = self._ritz_data(A64, 3)
        diag = np.diag(A64).copy()
        At = torch.from_numpy(A64)
        common = dict(inner_iters=400, inner_tol=1e-6, scale=False,
                      return_inner_iters=True)

        def proj_op(T):
            Tp = T - X * np.sum(X * T, axis=0)[None, :]
            S = A64 @ Tp - Tp * lam[None, :]
            return S - X * np.sum(X * S, axis=0)[None, :]

        target = 1e-5 * np.linalg.norm(R, axis=0)
        its = {}
        for start in (False, True):
            t_t, it_t = tcorr.gjd_correction(
                lambda T: At @ T, None, torch.from_numpy(lam),
                torch.from_numpy(X), torch.from_numpy(R),
                torch.ones(3, dtype=torch.float64),
                diag_a=torch.from_numpy(diag), olsen_start=start, **common)
            t_j, it_j = jcorr.gjd_correction(
                lambda T: jnp.asarray(A64) @ T, None, jnp.asarray(lam),
                jnp.asarray(X), jnp.asarray(R), jnp.ones((3,)),
                diag_a=jnp.asarray(diag), olsen_start=start, **common)
            resid = np.linalg.norm(proj_op(to_numpy(t_t)) + R, axis=0)
            assert (resid < target).all(), resid
            assert int(it_t.max()) == int(it_j)
            np.testing.assert_allclose(to_numpy(t_t), np.asarray(t_j),
                                       rtol=0, atol=1e-8)
            its[start] = int(it_t.max())
        assert its[True] < its[False], its

    def test_gjd_olsen_outer_parity(self):
        A = torch.from_numpy(_dd(60, 0))
        kw = dict(method="GJD", tolerance=1e-9, gjd_inner_tol=1e-12)
        ref = fdtt.eigensolve(A, 3, gjd_preconditioner="none", **kw)
        got = fdtt.eigensolve(A, 3, gjd_preconditioner="olsen", **kw)
        assert got.converged and got.iterations == ref.iterations
        np.testing.assert_allclose(to_numpy(got.eigenvalues),
                                   to_numpy(ref.eigenvalues), atol=1e-9)
