"""The refined (double-single) path of the port against the JAX package
and float64 oracles: ``core/refine.py``, the loop's refined branch, the
final polish and ``polish_eigenpairs``.

Inputs are numpy-built (the JAX package's generators, handed over as
numpy) and go through both packages where the JAX tests do; the
tolerances are the JAX tests' (``tests/test_refine.py``,
``tests/test_noise_gate.py``, ``tests/test_refined_generalized.py``,
``tests/test_ds_apply.py``, ``tests/test_ds_apply_sparse.py``). The
sizes are cut to a few thousand rows: where a JAX test needs its scale to
show a float32 floor, the check here is held to a float64 oracle of the
same stored matrix instead.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.core import refine as jrefine
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.core import loop as tloop
from fortran_davidson_tpu_torch.core import refine
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.ops.operators import DiagonalOperator
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError
from tests.torch_parity import to_numpy


def to64(x):
    return to_numpy(x).astype(np.float64)


@pytest.fixture(scope="module")
def banded():
    """A float32 banded BSR operator (n = 2048, diagonal 1..n, couplings
    1e-3), its float64 dense promotion and its lowest 3 eigenpairs."""
    j = jsparse.generate_banded_bsr(128, 16, bandwidth=1, coupling=1e-3,
                                    dtype=jnp.float32)
    t = convert.operator(j, device="cpu")
    A64 = np.asarray(j.to_dense()).astype(np.float64)
    w, V = scipy.linalg.eigh(A64, subset_by_index=[0, 2])
    return j, t, A64, w, V


def test_refined_pairs_match_f64_truth_and_jax(banded):
    j, t, A64, w, V = banded
    X32 = V.astype(np.float32)
    X64 = X32.astype(np.float64)
    lam64 = np.sum(X64 * (A64 @ X64), axis=0) / np.sum(X64 * X64, axis=0)
    err64 = np.linalg.norm(A64 @ X64 - X64 * lam64[None, :], axis=0)
    got = refine.refined_pairs(t.offdiag(), t.diagonal(),
                               torch.from_numpy(X32))
    np.testing.assert_allclose(to64(got.evals), lam64, rtol=3e-7, atol=1e-9)
    errs = to64(got.errors)
    assert (errs >= err64 - 1e-9).all()
    assert errs.max() < 5e-7
    naive = np.linalg.norm(to64(t.matmat(torch.from_numpy(X32)))
                           - X64 * to64(got.evals)[None, :], axis=0)
    assert naive.max() > 30 * errs.max()
    want = jrefine.refined_pairs(j.offdiag(), j.diagonal(), jnp.asarray(X32))
    np.testing.assert_allclose(to64(got.evals), np.asarray(want.evals),
                               rtol=3e-7)
    np.testing.assert_allclose(errs, np.asarray(want.errors), rtol=0,
                               atol=2e-9)


@pytest.mark.parametrize("update", ["dpr", "olsen"])
def test_polish_reaches_sub_f32_residuals(banded, update):
    j, t, A64, w, V = banded
    X32 = V.astype(np.float32)
    res = refine.polish(t.offdiag(), t.diagonal(),
                        torch.from_numpy(w.astype(np.float32)),
                        torch.from_numpy(X32), iterations=4, update=update)
    x64 = to64(res.evecs_hi) + to64(res.evecs_lo)
    lam = np.sum(x64 * (A64 @ x64), axis=0) / np.sum(x64 * x64, axis=0)
    err = np.linalg.norm(A64 @ x64 - x64 * lam[None, :], axis=0)
    assert err.max() < 2e-9 * max(np.abs(lam).max(), 1.0)
    np.testing.assert_allclose(lam, w, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to64(res.evals) + to64(res.evals_lo), w,
                               rtol=0, atol=1e-10)
    assert (to64(res.errors) >= err - 1e-9).all()
    jres = jrefine.polish(j.offdiag(), j.diagonal(),
                          jnp.asarray(w.astype(np.float32)),
                          jnp.asarray(X32), iterations=4, update=update)
    jx = (np.asarray(jres.evecs_hi, np.float64)
          + np.asarray(jres.evecs_lo))
    np.testing.assert_allclose(x64, jx, rtol=0, atol=1e-9)


def test_polish_unknown_update_raises(banded):
    _, t, _, w, V = banded
    with pytest.raises(ValueError):
        refine.polish(t.offdiag(), t.diagonal(),
                      torch.from_numpy(w.astype(np.float32)),
                      torch.from_numpy(V.astype(np.float32)), update="bogus")


def test_polish_generalized(banded):
    _, t, A64, _, _ = banded
    n = A64.shape[0]
    db = (1.0 + 0.1 * np.random.default_rng(0).random(n)).astype(np.float32)
    B64 = np.diag(db.astype(np.float64))
    wg, Vg = scipy.linalg.eigh(A64, B64, subset_by_index=[0, 2])
    Bop = DiagonalOperator(torch.from_numpy(db))
    res = refine.polish(t.offdiag(), t.diagonal(),
                        torch.from_numpy(wg.astype(np.float32)),
                        torch.from_numpy(Vg.astype(np.float32)),
                        iterations=4, B_off=Bop.offdiag(),
                        diag_b=Bop.diagonal())
    x64 = to64(res.evecs_hi) + to64(res.evecs_lo)
    lam = (np.sum(x64 * (A64 @ x64), axis=0)
           / np.sum(x64 * (B64 @ x64), axis=0))
    err = np.linalg.norm(A64 @ x64 - (B64 @ x64) * lam[None, :], axis=0)
    assert err.max() < 5e-9 * max(np.abs(lam).max(), 1.0)
    np.testing.assert_allclose(lam, wg, rtol=1e-9, atol=1e-9)


def test_refined_solve_beats_f32_floor(banded):
    """refined=True in float32 converges at 1e-8 absolute, with true
    residuals (held to the float64 oracle)."""
    _, t, A64, w, _ = banded
    rt = fdtt.eigensolve(t, 3, dtype="float32", refined=True, tolerance=1e-8,
                         max_iterations=60, expansion="lowest-k")
    assert rt.converged
    np.testing.assert_allclose(to64(rt.eigenvalues), w, rtol=3e-7, atol=3e-7)
    X64 = to64(rt.eigenvectors)
    nrm2 = np.sum(X64 * X64, axis=0)
    lam64 = np.sum(X64 * (A64 @ X64), axis=0) / nrm2
    err64 = np.linalg.norm(A64 @ X64 - X64 * lam64[None, :], axis=0) \
        / np.sqrt(nrm2)
    assert err64.max() < 1e-8
    np.testing.assert_allclose(to64(rt.residual_norms), err64, rtol=0.5,
                               atol=3e-9)


def test_trial_polish_certification_exit():
    """Absolute 1e-10 on the 4096-row surrogate: the loop's own residual
    plateaus near 1e-9 (without a polish it stalls, unconverged); with
    final_polish the trial polish at the first short plateau certifies
    the pairs and the loop exits through the stall path, earlier, with
    converged=True and honest residuals."""
    op = tgen.surrogate_hamiltonian(4096, dtype=torch.float32, device="cpu")
    kw = dict(method="DPR", tolerance=1e-10, dtype="float32",
              expansion="lowest-k", refined=True, max_iterations=80)
    plain = fdtt.eigensolve(op, 4, **kw)
    assert not plain.converged and plain.stalled
    res = fdtt.eigensolve(op, 4, final_polish=3, **kw)
    assert res.converged and res.stalled
    assert float(res.residual_norms.max()) < 1e-10
    assert res.iterations < plain.iterations < kw["max_iterations"]
    assert res.eigenvalues_lo is not None


class TestNoiseGateSmall:
    """The non-slow tests of ``tests/test_noise_gate.py``."""

    def test_requires_refined(self):
        with pytest.raises(InvalidOptionsError):
            fdtt.DavidsonOptions(final_polish=2)

    def test_small_problem_semantics(self):
        A32 = np.array(generate_diagonal_dominant(200, 1e-3)).astype(
            np.float32)
        kw = dict(tolerance=1e-7, dtype="float32", refined=True,
                  final_polish=3, max_iterations=200)
        rt = fdtt.eigensolve(torch.from_numpy(A32), 3, **kw)
        assert rt.converged
        want = scipy.linalg.eigh(A32.astype(np.float64),
                                 eigvals_only=True)[:3]
        np.testing.assert_allclose(to64(rt.eigenvalues), want, atol=1e-5)
        assert float(rt.residual_norms.max()) < 1e-7

    def test_unstalled_f64_has_flag_false(self):
        A = np.array(generate_diagonal_dominant(60, 1e-3))
        res = fdtt.eigensolve(torch.from_numpy(A), 3, tolerance=1e-8)
        assert res.converged and res.stalled is False


@pytest.fixture(scope="module")
def pencil_200():
    A = np.array(generate_diagonal_dominant(200, 1e-3))
    B = np.array(generate_diagonal_dominant(200, 1e-3, diag_val=1.0,
                                              key=jax.random.PRNGKey(3)))
    return A, B, scipy.linalg.eigh(A, B, eigvals_only=True)


class TestRefinedPencilSmall:
    """``tests/test_refined_generalized.py::TestRefinedPencilSmall``."""

    def test_f32_pencil_polish_reaches_true_1e7(self, pencil_200):
        A, B, want = pencil_200
        kw = dict(tolerance=1e-7, dtype="float32", refined=True,
                  final_polish=3, max_iterations=200)
        rt = fdtt.eigensolve(torch.from_numpy(A.astype(np.float32)), 3,
                             second_matrix=torch.from_numpy(
                                 B.astype(np.float32)), **kw)
        assert rt.converged
        assert float(rt.residual_norms.max()) < 1e-7
        np.testing.assert_allclose(to64(rt.eigenvalues), want[:3], atol=5e-7)

    def test_f64_refined_pencil_parity(self, pencil_200):
        A, B, want = pencil_200
        rt = fdtt.eigensolve(torch.from_numpy(A), 3,
                             second_matrix=torch.from_numpy(B),
                             tolerance=1e-10, refined=True,
                             max_iterations=200)
        assert rt.converged
        np.testing.assert_allclose(to64(rt.eigenvalues), want[:3],
                                   atol=1e-12)

    def test_refined_pencil_gjd(self, pencil_200):
        A, B, want = pencil_200
        rt = fdtt.eigensolve(torch.from_numpy(A.astype(np.float32)), 2,
                             second_matrix=torch.from_numpy(
                                 B.astype(np.float32)),
                             method="GJD", tolerance=1e-6, dtype="float32",
                             refined=True, final_polish=2,
                             max_iterations=200)
        assert rt.converged and rt.inner_iterations > 0
        np.testing.assert_allclose(to64(rt.eigenvalues), want[:2], atol=5e-7)

    def test_plateau_stall_surfaces_for_pencils(self, pencil_200):
        A, B, _ = pencil_200
        rt = fdtt.eigensolve(torch.from_numpy(A.astype(np.float32)), 3,
                             second_matrix=torch.from_numpy(
                                 B.astype(np.float32)),
                             tolerance=1e-14, dtype="float32", refined=True,
                             final_polish=0, max_iterations=300)
        assert not rt.converged and rt.stalled
        assert rt.iterations < 300


def test_quantized_northstar_contract():
    """``tests/test_ds_apply_sparse.py::TestQuantizedNorthstarContract`` in
    both packages at n = 4096: the int8 banded operator, a loose float32
    stage, then refined + final_polish from its vectors at 1e-8 (the same
    start in both), with
    oracle-true residuals (float64 of the same stored matrix, eigenvalues
    with their low words) below tolerance."""
    q = jsparse.quantize_banded_int8(jsparse.generate_banded_bsr(
        256, 16, bandwidth=1, coupling=1e-3, dtype=jnp.float32))
    qt = convert.operator(q, device="cpu")
    loose_kw = dict(method="DPR", tolerance=1e-3, relative_tolerance=True,
                    dtype="float32", expansion="lowest-k", max_iterations=30)
    kw = dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
              dtype="float32", expansion="lowest-k", refined=True,
              final_polish=3, max_iterations=60)
    A64 = np.asarray(q.to_dense()).astype(np.float64)
    # The loose stage runs once (the port's); both refined stages start
    # from its vectors, handed over as numpy.
    loose = fdtt.eigensolve(qt, 4, **loose_kw)
    assert loose.converged
    X0 = to_numpy(loose.eigenvectors)
    results = {}
    for name, solve, op in (("jax", fdt.eigensolve, q),
                            ("torch", fdtt.eigensolve, qt)):
        res = solve(op, 4, initial_vectors=X0, **kw)
        assert bool(res.converged), name
        lam = to64(res.eigenvalues) + to64(res.eigenvalues_lo)
        X = to64(res.eigenvectors)
        X = X / np.linalg.norm(X, axis=0)
        r = A64 @ X - X * lam[None, :]
        assert np.linalg.norm(r, axis=0).max() < 1e-8, name
        results[name] = (int(res.iterations), lam)
    assert abs(results["torch"][0] - results["jax"][0]) <= 2
    np.testing.assert_allclose(results["torch"][1], results["jax"][1],
                               rtol=0, atol=2e-8)


def test_chunked_carry_layout_resolves_to_flat():
    op = tgen.surrogate_hamiltonian(1024, dtype=torch.float32, device="cpu")
    kw = dict(tolerance=1e-6, relative_tolerance=True, dtype="float32",
              refined=True, expansion="lowest-k", max_iterations=40)
    flat = fdtt.eigensolve(op, 3, carry_layout="flat", **kw)
    chunked = fdtt.eigensolve(op, 3, carry_layout="chunked", **kw)
    auto = fdtt.eigensolve(op, 3, **kw)
    for res in (chunked, auto):
        assert res.iterations == flat.iterations
        assert torch.equal(res.eigenvalues, flat.eigenvalues)
        assert torch.equal(res.eigenvectors, flat.eigenvectors)
    with pytest.raises(InvalidOptionsError):
        fdtt.DavidsonOptions(carry_layout="chunked")
    with pytest.raises(InvalidOptionsError):
        fdtt.DavidsonOptions(carry_layout="chunked", refined=True,
                             orthonormalization="qr")


def test_polish_eigenpairs_entry_point(banded):
    j, t, A64, w, _ = banded
    res = fdtt.eigensolve(t, 3, dtype="float32", tolerance=1e-4,
                          relative_tolerance=True, expansion="lowest-k")
    pol = fdtt.polish_eigenpairs(t, res, iterations=3)
    x64 = to64(pol.evecs_hi) + to64(pol.evecs_lo)
    x64 /= np.linalg.norm(x64, axis=0)
    lam = to64(pol.evals) + to64(pol.evals_lo)
    assert np.linalg.norm(A64 @ x64 - x64 * lam, axis=0).max() < 1e-8
    jres = fdt.eigensolve(j, 3, dtype="float32", tolerance=1e-4,
                          relative_tolerance=True, expansion="lowest-k")
    jpol = fdt.polish_eigenpairs(j, jres, iterations=3)
    np.testing.assert_allclose(lam, np.asarray(jpol.evals, np.float64)
                               + np.asarray(jpol.evals_lo), rtol=0,
                               atol=1e-9)


def test_polish_update_option_and_validation():
    op = tgen.surrogate_hamiltonian(4096, dtype=torch.float32, device="cpu")
    r = fdtt.eigensolve(op, 2, method="DPR", tolerance=1e-8,
                        relative_tolerance=True, dtype="float32",
                        refined=True, final_polish=3,
                        polish_update="olsen", max_iterations=60)
    assert r.converged and float(r.residual_norms.max()) < 1e-8
    with pytest.raises(InvalidOptionsError):
        fdtt.eigensolve(op, 2, dtype="float32", refined=True,
                        final_polish=1, polish_update="bogus")


def test_generalized_eigensolver_hint_follows_resolved_refined():
    A = torch.from_numpy(np.array(generate_diagonal_dominant(
        60, 1.0)).astype(np.float32))
    for opts, hinted in ((dict(), True),
                         (dict(options=fdtt.DavidsonOptions(refined=True)),
                          False)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fdtt.generalized_eigensolver(A, 3, max_iterations=2,
                                         tolerance=1e-9, dtype="float32",
                                         **opts)
        msgs = [str(w.message) for w in caught
                if "did not converge" in str(w.message)]
        assert msgs and (("refined=True" in msgs[0]) == hinted)


def test_refined_functions_pin_tf32_off(monkeypatch, banded):
    """refined_pairs, polish and polish_eigenpairs can run outside the
    loop, so each pins TF32 off itself (a no-op on the CPU; checked
    through the flag the operator's applies see) and restores it."""
    _, t, _, w, V = banded
    seen = []

    class Recording(fdtt.BSROperator):
        def matmat(self, block):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return super().matmat(block)

        def matmat_ds(self, x_hi, x_lo):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return super().matmat_ds(x_hi, x_lo)

        def offdiag(self):
            off = super().offdiag()
            return Recording(off.block_cols, off.blocks, off.bandwidth)

    op = Recording(t.block_cols, t.blocks, t.bandwidth)
    lam = torch.from_numpy(w.astype(np.float32))
    X = torch.from_numpy(V.astype(np.float32))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    refine.refined_pairs(op.offdiag(), op.diagonal(), X)
    refine.polish(op.offdiag(), op.diagonal(), lam, X, iterations=1)
    res = fdtt.DavidsonResult(
        eigenvalues=lam, eigenvectors=X, iterations=1, converged=True,
        converged_pairs=None, residual_norms=None, residual_history=None,
        subspace_dims=None)
    fdtt.polish_eigenpairs(op, res, iterations=1)
    assert len(seen) == 3 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32
    assert tloop._PLATEAU_ITERS == 10 and tloop._POLISH_POLL_AT == 4
