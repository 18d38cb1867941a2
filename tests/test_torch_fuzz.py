"""The randomized configuration sweeps of ``tests/test_fuzz.py``
(``_cases``, the reference surface, and ``_feature_cases``: refined,
final_polish, locking, Chebyshev fixed and auto, Olsen, pencils), run
through the port on the same matrices and held to the same contract:
finite eigenvalues and residuals, scipy's answer whenever the solve says
it converged. Beside that, each case is held to the JAX package's solve:
the same converged flag, iterations within ±1, eigenvalues within the
tolerance's scale; the refined feature cases, whose JAX compiles take
most of this file's time, only to scipy (``tests/test_torch_refine.py``
holds the refined path to the JAX package's). The Chebyshev cases start
Lanczos from the JAX package's vector (``tests/test_torch_chebyshev.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu_torch.core import chebyshev as tcheb
from tests.test_fuzz import _cases, _feature_cases


@pytest.fixture(autouse=True)
def jax_vector(monkeypatch):
    monkeypatch.setattr(tcheb, "start_vector", lambda n, seed=7: (
        torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(seed), (n,), jnp.float64)))))


def _expected(A, B, k):
    A64 = np.asarray(A, np.float64)
    if B is None:
        return scipy.linalg.eigh(A64, eigvals_only=True)[:k]
    return scipy.linalg.eigh(A64, np.asarray(B, np.float64),
                             eigvals_only=True)[:k]


def _run(A, B, k, atol, jax_parity=True, **opts):
    rt = fdtt.eigensolve(torch.from_numpy(A), k, second_matrix=None
                         if B is None else torch.from_numpy(B), **opts)
    vals = rt.eigenvalues.numpy()
    assert np.all(np.isfinite(vals)), "NaN/Inf eigenvalues"
    assert np.all(np.isfinite(rt.residual_norms.numpy()))
    if rt.converged:
        np.testing.assert_allclose(vals, _expected(A, B, k), atol=atol)
    if jax_parity:
        rj = fdt.eigensolve(A, k, second_matrix=B, **opts)
        assert rt.converged == bool(rj.converged)
        assert abs(rt.iterations - int(rj.iterations)) <= 1
        np.testing.assert_allclose(vals, np.asarray(rj.eigenvalues),
                                   atol=atol)


@pytest.mark.parametrize("seed,n,k,method,expansion,gen,max_dim", _cases())
def test_random_config(seed, n, k, method, expansion, gen, max_dim):
    A = np.array(generate_diagonal_dominant(n, 1e-3,
                                            key=jax.random.PRNGKey(seed)))
    B = (np.array(generate_diagonal_dominant(
        n, 1e-3, diag_val=1.0, key=jax.random.PRNGKey(seed + 100)))
         if gen else None)
    _run(A, B, k, 1e-7, method=method, expansion=expansion,
         max_dim_sub=max_dim, tolerance=1e-8, max_iterations=300)


@pytest.mark.parametrize(
    "seed,n,k,method,refined,polish,locking,cheb,dtype,expansion,gen",
    _feature_cases())
def test_random_feature_combo(seed, n, k, method, refined, polish, locking,
                              cheb, dtype, expansion, gen):
    A = np.array(generate_diagonal_dominant(n, 1e-3,
                                            key=jax.random.PRNGKey(seed)))
    B = (np.array(generate_diagonal_dominant(
        n, 1e-3, diag_val=1.0, key=jax.random.PRNGKey(seed + 300)))
         if gen else None)
    A = A.astype(dtype)
    B = None if B is None else B.astype(dtype)
    _run(A, B, k, 1e-7 if dtype == "float64" else 5e-4,
         jax_parity=not refined, method=method,
         tolerance=1e-8 if dtype == "float64" else 1e-5,
         max_iterations=400, dtype=dtype, expansion=expansion,
         refined=refined, final_polish=polish, locking=locking,
         cheb_degree=cheb)
