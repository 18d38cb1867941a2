"""The port's scipy-shaped ``eigsh`` (``scipy_compat.py``), held to the
JAX package's ``eigsh`` and to scipy on ``tests/test_scipy_compat.py``'s
inputs: every ``which``, ``sigma`` through the spectral fold, pencils,
scipy sparse input (an ELL operator), ``v0``, ``ncv``/``maxiter`` and the
honest non-convergence error. Results are numpy, as scipy's are.
"""

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.linalg
import torch

from fortran_davidson_tpu import scipy_compat as jsc
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu_torch import scipy_compat as tsc
from fortran_davidson_tpu_torch.ops.sparse import ELLOperator
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError


@pytest.fixture(scope="module")
def A():
    return np.array(generate_diagonal_dominant(120, 1e-3))


@pytest.fixture(scope="module")
def B():
    return np.array(generate_diagonal_dominant(120, 1e-3, diag_val=1.0))


def _both(A, **kw):
    """(JAX, port) eigsh of the same numpy input."""
    return (jsc.eigsh(A, **kw), tsc.eigsh(A, device="cpu", **kw))


def _residuals(A, w, v, B=None):
    BV = v if B is None else B @ v
    return np.linalg.norm(A @ v - BV * w[None, :], axis=0)


@pytest.mark.parametrize("which,k,atol", [("SA", 4, 1e-9), ("LA", 3, 1e-7),
                                          ("LM", 4, 1e-7), ("BE", 5, 1e-7)])
def test_which_matches_jax_and_scipy(A, which, k, atol):
    (wj, _), (w, v) = _both(A, k=k, which=which, tol=1e-9)
    assert isinstance(w, np.ndarray) and isinstance(v, np.ndarray)
    np.testing.assert_allclose(w, wj, atol=1e-9)
    ws = scipy.sparse.linalg.eigsh(A, k=k, which=which)[0]
    np.testing.assert_allclose(w, np.sort(ws), atol=atol)
    assert np.all(np.diff(w) >= 0)  # ascending, scipy's order
    assert np.all(_residuals(A, w, v) < 1e-8)


def test_sa_vectors_match_scipy(A):
    w, v = tsc.eigsh(A, k=4, which="SA", tol=1e-9, device="cpu")
    ws, vs = scipy.sparse.linalg.eigsh(A, k=4, which="SA")
    np.testing.assert_allclose(w, ws, atol=1e-8)
    for j in range(4):
        assert abs(float(v[:, j] @ vs[:, j])) > 1.0 - 1e-8


def test_which_none_is_sa(A):
    np.testing.assert_array_equal(
        tsc.eigsh(A, k=3, tol=1e-9, device="cpu", return_eigenvectors=False),
        tsc.eigsh(A, k=3, which="SA", tol=1e-9, device="cpu",
                  return_eigenvectors=False))


@pytest.mark.parametrize("which,k", [("SA", 3), ("LM", 3), ("BE", 4)])
def test_pencils_match_jax_and_scipy(A, B, which, k):
    (wj, _), (w, v) = _both(A, k=k, M=B, which=which, tol=1e-9)
    np.testing.assert_allclose(w, wj, atol=1e-9)
    full = scipy.linalg.eigh(A, B, eigvals_only=True)
    if which == "SA":
        expect = full[:k]
    elif which == "LM":
        expect = np.sort(full[np.argsort(-np.abs(full))[:k]])
    else:
        expect = np.sort(np.concatenate([full[:k // 2],
                                         full[-(k - k // 2):]]))
    np.testing.assert_allclose(w, expect, rtol=1e-8, atol=1e-8)
    assert np.all(_residuals(A, w, v, B) < 1e-7)


def test_scipy_sparse_input_runs_on_ell(A, monkeypatch):
    seen = []
    apply = ELLOperator.matmat
    monkeypatch.setattr(ELLOperator, "matmat",
                        lambda self, X: seen.append(1) or apply(self, X))
    As = scipy.sparse.csr_matrix(A)
    w = tsc.eigsh(As, k=2, tol=1e-9, return_eigenvectors=False,
                  device="cpu")
    assert seen
    np.testing.assert_allclose(w, jsc.eigsh(As, k=2, tol=1e-9,
                                            return_eigenvectors=False),
                               atol=1e-9)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A)[:2], atol=1e-8)


def test_v0_and_tensor_input(A):
    w0, v0 = tsc.eigsh(A, k=2, tol=1e-9, device="cpu")
    w, _ = tsc.eigsh(torch.from_numpy(A), k=2, tol=1e-9, v0=v0)
    np.testing.assert_allclose(w, w0, atol=1e-9)
    w1 = tsc.eigsh(A, k=1, tol=1e-9, v0=v0[:, 0], device="cpu",
                   return_eigenvectors=False)
    np.testing.assert_allclose(w1, w0[:1], atol=1e-9)


def test_ncv_and_overrides(A):
    (wj, _), (w, _) = _both(A, k=2, ncv=12, maxiter=200, method="GJD",
                            tol=1e-9)
    np.testing.assert_allclose(w, wj, atol=1e-9)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(A)[:2], atol=1e-8)


def test_sigma_interior_fold(A):
    sig = float(np.median(np.linalg.eigvalsh(A)))
    (wj, _), (w, v) = _both(A, k=3, sigma=sig, tol=1e-9)
    np.testing.assert_allclose(w, wj, atol=1e-8)
    ws = scipy.sparse.linalg.eigsh(A, k=3, sigma=sig)[0]
    np.testing.assert_allclose(w, np.sort(ws), atol=1e-7)
    assert np.all(_residuals(A, w, v) < 1e-8)


def test_which_sm_folds_at_zero(A):
    As = A - np.median(np.linalg.eigvalsh(A)) * np.eye(A.shape[0])
    (wj, _), (w, v) = _both(As, k=3, which="SM", tol=1e-9)
    np.testing.assert_allclose(w, wj, atol=1e-8)
    full = np.linalg.eigvalsh(As)
    np.testing.assert_allclose(w, np.sort(full[np.argsort(np.abs(full))[:3]]),
                               atol=1e-7)
    assert np.all(_residuals(As, w, v) < 1e-8)


def test_which_lm_negative_end():
    d = np.concatenate([[-9.0, -8.5], np.linspace(-1, 1, 56),
                        [7.0, 8.0, 9.5]])
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.standard_normal((d.size, d.size)))[0]
    A = Q @ np.diag(d) @ Q.T
    w = tsc.eigsh(A, k=4, which="LM", tol=1e-9, return_eigenvectors=False,
                  device="cpu")
    np.testing.assert_allclose(sorted(np.abs(w)), [8.0, 8.5, 9.0, 9.5],
                               atol=1e-7)


@pytest.mark.parametrize("kw,match", [
    (dict(sigma=0.5, which="SA"), "'LM'"),
    (dict(which="XX"), "not supported"),
    (dict(k=70, which="LM"), "fit n"),
    (dict(k=121, which="BE"), "fit n"),
])
def test_bad_requests_raise(A, kw, match):
    # LM and BE solve both ends: k_lo + k_hi must fit n = 120.
    kw = dict(dict(k=2), **kw)
    with pytest.raises(InvalidOptionsError, match=match):
        tsc.eigsh(A, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(sigma=0.5), dict(which="SM")])
def test_fold_of_a_pencil_raises(A, B, kw):
    with pytest.raises(InvalidOptionsError, match="standard"):
        tsc.eigsh(A, k=2, M=B, device="cpu", **kw)


def test_no_convergence_raises_with_partials(A):
    with pytest.raises(tsc.ArpackNoConvergence) as exc:
        tsc.eigsh(A, k=3, maxiter=1, tol=1e-14, device="cpu")
    e = exc.value
    assert e.result is not None and e.result.iterations == 1
    assert e.eigenvalues.shape[0] == e.eigenvectors.shape[1]
    assert isinstance(e.eigenvalues, np.ndarray)


def test_fold_no_convergence_reports_unfolded_pairs(A):
    sig = float(np.median(np.linalg.eigvalsh(A)))
    with pytest.raises(tsc.ArpackNoConvergence) as exc:
        tsc.eigsh(A, k=2, sigma=sig, maxiter=1, tol=1e-14, device="cpu")
    part = exc.value.result
    assert part.eigenvalues.shape == (2,)
    assert np.all(np.abs(part.eigenvalues - sig) < 5.0)
    assert part.fold_result is not None
