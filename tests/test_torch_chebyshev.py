"""Chebyshev-filtered restarts in the port (``core/chebyshev.py``, the
loop's filtered collapse), held to the JAX package's ``core.chebyshev``
and to ``tests/test_chebyshev.py``'s claims on the same inputs.

The JAX bound starts Lanczos from ``jax.random.normal(PRNGKey(7), (n,))``,
whose bits PyTorch cannot draw. The solve-parity cases replace the port's
start-vector helper with that vector, so both packages take the same
bound, the same degrees and the same trajectory: the same iterations and
operator columns, eigenvalues within 1e-10. Unpatched, the port's own
vector gives another bound, so its solves are held to scipy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.core import chebyshev as jcheb
from fortran_davidson_tpu.models.generators import (bse_surrogate,
                                                    generate_diagonal_dominant)
from fortran_davidson_tpu_torch.core import chebyshev as tcheb
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError
from tests.torch_dist_worker import recording_degrees
from tests.torch_parity import assert_parity, true_residuals

COLLAPSING = dict(tolerance=1e-8, max_dim_sub=10, init_dim=6,
                  max_iterations=300)


def _jax_start_vector(n, seed=7):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(seed), (n,), jnp.float64)))


@pytest.fixture
def jax_vector(monkeypatch):
    monkeypatch.setattr(tcheb, "start_vector", _jax_start_vector)


def _dd(n, coupling, key=0):
    return np.array(generate_diagonal_dominant(n, coupling,
                                               key=jax.random.PRNGKey(key)))


@pytest.mark.parametrize("n", [50, 300])
def test_bound_matches_jax_and_bounds_the_spectrum(jax_vector, n):
    A = _dd(n, 1e-3)
    lam_max = scipy.linalg.eigh(A, eigvals_only=True)[-1]
    want = float(jcheb.lanczos_upper_bound(lambda X: jnp.asarray(A) @ X, n,
                                           jnp.float64))
    At = torch.from_numpy(A)
    ub = float(tcheb.lanczos_upper_bound(lambda X: At @ X, n, torch.float64))
    assert ub == pytest.approx(want, rel=1e-12)
    assert lam_max <= ub < 3.0 * lam_max


@pytest.mark.parametrize("n", [50, 300])
def test_own_start_vector_bounds_the_spectrum(n):
    A = torch.from_numpy(_dd(n, 1e-3))
    lam_max = float(torch.linalg.eigvalsh(A)[-1])
    ub = float(tcheb.lanczos_upper_bound(lambda X: A @ X, n, torch.float64))
    assert lam_max <= ub < 3.0 * lam_max
    # One global vector: the helper's draw depends on n and the seed only.
    assert torch.equal(tcheb.start_vector(n), tcheb.start_vector(n))


def test_filter_matches_jax_and_damps_the_interval():
    d = np.linspace(1.0, 100.0, 64)
    X = np.random.default_rng(0).standard_normal((64, 3))
    want = np.asarray(jcheb.chebyshev_filter(
        lambda Y: jnp.asarray(d)[:, None] * Y, jnp.asarray(X), 8, 10.0,
        101.0, 1.0))
    dt = torch.from_numpy(d)
    got = tcheb.chebyshev_filter(lambda Y: dt[:, None] * Y,
                                 torch.from_numpy(X), 8, 10.0, 101.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    gain = tcheb.chebyshev_filter(lambda Y: dt[:, None] * Y,
                                  torch.ones((64, 1), dtype=torch.float64),
                                  8, 10.0, 101.0, 1.0)[:, 0].abs().numpy()
    wanted, unwanted = gain[d < 5.0], gain[d > 10.0]
    assert wanted.min() > 25 * unwanted.max()
    assert wanted.max() < 1e3


def test_zero_columns_stay_zero():
    d = torch.linspace(1.0, 50.0, 32, dtype=torch.float64)
    X = torch.zeros((32, 3), dtype=torch.float64)
    X[:, 0] = 1.0
    Y = tcheb.chebyshev_filter(lambda T: d[:, None] * T, X, 6, 5.0, 51.0, 1.0)
    assert torch.all(Y[:, 1:] == 0) and Y[:, 0].abs().max() > 0


@pytest.mark.parametrize("lo,a,b", [(1.0, 50.0, 100.0), (49.9, 50.0, 100.0),
                                    (1.0, 50.0, 50.0), (-3.0, 2.0, 9.0),
                                    (0.5, 0.6, 1e4)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_auto_degree_matches_jax(lo, a, b, dtype):
    want = int(jcheb.auto_degree(lo, a, b, jnp.dtype(dtype)))
    got = tcheb.auto_degree(lo, a, b, getattr(torch, dtype))
    assert isinstance(got, int) and got == want
    assert 2 <= got <= 12


def test_auto_degree_geometry():
    sep = tcheb.auto_degree(1.0, 50.0, 100.0, torch.float64)
    clustered = tcheb.auto_degree(49.9, 50.0, 100.0, torch.float64)
    assert 2 <= sep < clustered == 12


@pytest.mark.parametrize("cheb", [6, "auto"])
@pytest.mark.parametrize("case", ["dd300", "dd200", "bse300"])
def test_filtered_solve_matches_jax(jax_vector, case, cheb):
    A = {"dd300": lambda: _dd(300, 0.1, key=3),
         "dd200": lambda: _dd(200, 0.05),
         "bse300": lambda: np.array(bse_surrogate(300, coupling=2e-3))}[case]()
    rj = fdt.eigensolve(A, 3, cheb_degree=cheb, **COLLAPSING)
    rt = fdtt.eigensolve(torch.from_numpy(A), 3, cheb_degree=cheb,
                         **COLLAPSING)
    assert_parity(rj, rt, A, 1e-8, exact_iterations=True)
    assert rt.operator_columns == int(rj.operator_columns)
    dims = rt.subspace_dims[:rt.iterations]
    assert int(torch.sum(dims[1:] < dims[:-1])) > 0, "no collapse"


def test_own_vector_solve_matches_scipy():
    A = _dd(400, 1.0, key=3)
    res = fdtt.eigensolve(torch.from_numpy(A), 4, tolerance=1e-8,
                          max_dim_sub=12, init_dim=6, cheb_degree=6,
                          max_iterations=300)
    assert res.converged
    want = scipy.linalg.eigh(A, eigvals_only=True)[:4]
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, atol=1e-8)
    assert np.all(true_residuals(A, res.eigenvectors, res.eigenvalues)
                  <= 1e-8)


@pytest.mark.parametrize("cheb,ratio", [(8, 0.7), ("auto", 0.8)])
def test_accelerates_collapse_heavy_solve(cheb, ratio):
    # tests/test_chebyshev.py's problem: plain DPR collapses often.
    A = torch.from_numpy(_dd(400, 1.0, key=3))
    common = dict(tolerance=1e-8, max_dim_sub=12, init_dim=6,
                  max_iterations=300)
    plain = fdtt.eigensolve(A, 4, **common)
    filt = fdtt.eigensolve(A, 4, cheb_degree=cheb, **common)
    assert plain.converged and filt.converged
    assert filt.iterations < ratio * plain.iterations


def test_off_by_default_identical():
    A = torch.from_numpy(_dd(80, 1e-3))
    base = fdtt.eigensolve(A, 3, tolerance=1e-8)
    for cheb in (0, 1):
        same = fdtt.eigensolve(A, 3, tolerance=1e-8, cheb_degree=cheb)
        assert same.iterations == base.iterations
        assert torch.equal(same.eigenvalues, base.eigenvalues)


class _Counted(fdtt.LinearOperator):
    """A dense operator that counts its applies and their nonzero
    columns."""

    def __init__(self, A):
        self.A, self.calls, self.columns = A, [], 0

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def matmat(self, block):
        self.calls.append(block.shape[1])
        self.columns += int(torch.count_nonzero(block.abs().sum(dim=0)))
        return self.A @ block

    def diagonal(self):
        return torch.diagonal(self.A)


@pytest.mark.parametrize("cheb", [0, 6, "auto"])
def test_operator_columns_charge_the_filter_not_the_bound(cheb):
    # operator_columns counts every nonzero column the loop applied A to:
    # (degree + 1)·init_dim per filtered collapse, never the 12
    # single-column Lanczos applies of the bound.
    op = _Counted(torch.from_numpy(_dd(400, 1.0, key=3)))
    with recording_degrees() as degrees:
        res = fdtt.eigensolve(op, 4, tolerance=1e-8, max_dim_sub=12,
                              init_dim=6, max_iterations=300,
                              cheb_degree=cheb)
    assert res.converged
    dims = res.subspace_dims[:res.iterations]
    collapses = int(torch.sum(dims[1:] < dims[:-1]))
    lanczos = 0 if cheb == 0 else 12
    assert op.calls[1:1 + lanczos] == [1] * lanczos
    if cheb == "auto":
        assert len(degrees) == collapses > 0
    else:
        assert degrees == []
        degrees = [cheb] * collapses if cheb else []
    expansions = res.iterations - 1 - collapses
    assert len(op.calls) == (1 + lanczos + expansions
                             + sum(d + 1 for d in degrees))
    assert res.operator_columns == op.columns - lanczos
    assert res.operator_columns >= sum(d + 1 for d in degrees) * 6


@pytest.mark.parametrize("cheb", [6, "auto"])
def test_filtered_restart_on_a_pencil_raises(cheb):
    A = _dd(40, 1e-3)
    B = np.array(generate_diagonal_dominant(40, 1e-3, diag_val=1.0))
    with pytest.raises(InvalidOptionsError, match="standard problem"):
        fdtt.eigensolve(torch.from_numpy(A), 3,
                        second_matrix=torch.from_numpy(B), cheb_degree=cheb)


@pytest.mark.parametrize("bad", ["fast", -1, 2.5])
def test_bogus_degree_raises(bad):
    with pytest.raises(InvalidOptionsError, match="cheb_degree"):
        fdtt.DavidsonOptions(cheb_degree=bad)
