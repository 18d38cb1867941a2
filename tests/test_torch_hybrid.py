"""The port's band + remainder operator (``split_band_remainder``,
``HybridBandedOperator``), its generator and the double-single applies of
the ELL family against the JAX package, on the CPU.

The analogues of ``tests/test_hybrid.py``, ``tests/test_sell.py``'s
remainder-format class and ``tests/test_ds_apply_sparse.py:108-139``.
Inputs are numpy COO triplets from a seed, handed to both packages.
Tolerances:

- generators and the band's blocks: bit-equal (the same numpy draws and
  the same ``np.add.at`` assembly);
- applies in float64: within 1e-13 of max|Y| of the JAX package's;
- ``to_dense``, ``diagonal``, ``offdiag`` and ``band_fraction``: equal;
- ``matmat_ds`` on float32 storage: error < 5e-10 against a float64
  oracle of the same stored matrix (the JAX package's bound);
- solves: iterations within ±1, the same ``converged`` flag, eigenvalues
  within 1e-8, true residuals at the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.ops import kernels
from fortran_davidson_tpu_torch.utils.errors import OperatorError
from tests.torch_parity import assert_parity, to_numpy

APPLY_RTOL = 1e-13
DS_TOL = 5e-10


def _x(n, m, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(dtype)


def _assert_apply(got, ref):
    ref = np.asarray(ref)
    assert np.max(np.abs(to_numpy(got) - ref)) <= APPLY_RTOL * np.max(
        np.abs(ref))


@pytest.fixture(scope="module")
def local_coo():
    """``tests/test_hybrid.py``'s fixture."""
    return jsparse.generate_local_sparse(600, 12, locality=30.0, seed=7)


@pytest.mark.parametrize("n,nnz,locality,seed,dtype", [
    (600, 12, 30.0, 7, "float64"), (530, 10, 20.0, 11, "float64"),
    (1024, 8, 40.0, 5, "float32"), (640, 4, 2.0, 3, "float64")])
def test_generate_local_sparse_bit_equal(n, nnz, locality, seed, dtype):
    j = jsparse.generate_local_sparse(n, nnz, locality=locality, seed=seed,
                                      dtype=getattr(jnp, dtype))
    t = fdtt.generate_local_sparse(n, nnz, locality=locality, seed=seed,
                                   dtype=dtype)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt,bs,bw", [("sell", 64, 1), ("ell", 32, 2)])
def test_split_matches_jax(local_coo, fmt, bs, bw):
    rows, cols, vals = local_coo
    t = fdtt.split_band_remainder(rows, cols, vals, 600, block_size=bs,
                                  bandwidth=bw, remainder_format=fmt,
                                  device="cpu")
    j = jsparse.split_band_remainder(rows, cols, vals, 600, block_size=bs,
                                     bandwidth=bw, remainder_format=fmt)
    assert t.shape == j.shape and t.shape[0] % bs == 0 and t.perm is None
    assert t.band.bandwidth == bw == j.band.bandwidth
    np.testing.assert_array_equal(to_numpy(t.band.blocks),
                                  np.asarray(j.band.blocks))
    np.testing.assert_array_equal(to_numpy(t.band.block_cols),
                                  np.asarray(j.band.block_cols))
    assert type(t.remainder).__name__ == type(j.remainder).__name__ == {
        "sell": "SlicedELLOperator", "ell": "ELLOperator"}[fmt]
    assert t.band_fraction == j.band_fraction
    X = _x(t.shape[0], 5)
    _assert_apply(t.matmat(torch.from_numpy(X)), j.matmat(jnp.asarray(X)))
    _assert_apply(t.offdiag().matmat(torch.from_numpy(X)),
                  j.offdiag().matmat(jnp.asarray(X)))
    for name in ("diagonal", "to_dense"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)()),
                                      np.asarray(getattr(j, name)()))


def test_split_matches_unsplit_with_padding_above_the_spectrum(local_coo):
    rows, cols, vals = local_coo
    n = 600
    hyb = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                    bandwidth=1, device="cpu")
    n_pad = hyb.shape[0]
    assert n_pad == 640
    full = fdtt.ELLOperator.from_coo(rows, cols, vals, n, device="cpu")
    X = _x(n_pad, 5, seed=1)
    got = to_numpy(hyb.matmat(torch.from_numpy(X)))
    d = to_numpy(hyb.diagonal())
    np.testing.assert_allclose(d[:n], np.arange(1, n + 1), rtol=0, atol=1e-12)
    row_abs = np.zeros(n)
    np.add.at(row_abs, rows, np.abs(vals))
    assert (d[n:] == 2.0 * row_abs.max() + 1.0).all()
    expected = np.concatenate([to_numpy(full.matmat(torch.from_numpy(X[:n]))),
                               d[n:, None] * X[n:]])
    np.testing.assert_allclose(got, expected, rtol=0,
                               atol=APPLY_RTOL * np.abs(expected).max())
    assert hyb.band_fraction > 0.9
    b = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                  bandwidth=1, pad_diag=1.0, device="cpu")
    np.testing.assert_array_equal(to_numpy(b.diagonal())[n:], 1.0)


def test_solve_on_hybrid_matches_jax(local_coo):
    rows, cols, vals = local_coo
    t = fdtt.split_band_remainder(rows, cols, vals, 600, block_size=64,
                                  bandwidth=1, device="cpu")
    j = jsparse.split_band_remainder(rows, cols, vals, 600, block_size=64,
                                     bandwidth=1)
    kernels.reset_launch_counts()
    rt = fdtt.eigensolve(t, 4, tolerance=1e-8)
    # On the CPU the band's wrapper takes kernel 1's plain version.
    assert kernels.banded_bsr_spmm.launches == 0
    rj = fdt.eigensolve(j, 4, tolerance=1e-8)
    dense = to_numpy(t.to_dense())
    assert_parity(rj, rt, dense, 1e-8, eig_atol=1e-8)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               scipy.linalg.eigh(dense, eigvals_only=True)[:4],
                               rtol=0, atol=1e-8)


def test_padding_never_displaces_true_eigenpairs():
    # n not a multiple of the block: 110 padded rows, whose diagonal sits
    # above the spectrum; the oracle is the original n x n matrix.
    n = 530
    rows, cols, vals = fdtt.generate_local_sparse(n, 10, locality=20.0,
                                                  seed=11)
    t = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                  bandwidth=1, device="cpu")
    assert t.shape[0] > n
    rt = fdtt.eigensolve(t, 4, tolerance=1e-8)
    rj = fdt.eigensolve(jsparse.split_band_remainder(
        rows, cols, vals, n, block_size=64, bandwidth=1), 4, tolerance=1e-8)
    assert_parity(rj, rt, to_numpy(t.to_dense()), 1e-8, eig_atol=1e-8)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               scipy.linalg.eigh(dense, eigvals_only=True)[:4],
                               rtol=0, atol=1e-8)
    assert np.abs(to_numpy(rt.eigenvectors)[n:]).max() < 1e-8


def test_remainder_formats_take_the_same_iterations():
    rows, cols, vals = fdtt.generate_local_sparse(600, 9, locality=40.0,
                                                  seed=5)
    res = {fmt: fdtt.eigensolve(fdtt.split_band_remainder(
        rows, cols, vals, 600, block_size=32, bandwidth=1,
        remainder_format=fmt, device="cpu"), 2, tolerance=1e-9)
        for fmt in ("sell", "ell")}
    assert res["sell"].converged and res["ell"].converged
    assert res["sell"].iterations == res["ell"].iterations
    np.testing.assert_allclose(to_numpy(res["sell"].eigenvalues),
                               to_numpy(res["ell"].eigenvalues), rtol=0,
                               atol=1e-9)


def test_pure_band_has_no_remainder_and_bad_arguments_raise():
    rows, cols, vals = fdtt.generate_local_sparse(640, 4, locality=2.0,
                                                  seed=3)
    hyb = fdtt.split_band_remainder(rows, cols, vals, 640, block_size=64,
                                    bandwidth=2, device="cpu")
    assert hyb.remainder is None and hyb.band_fraction == 1.0
    x = torch.from_numpy(_x(640, 2))
    assert torch.equal(hyb.matmat(x), hyb.band.matmat(x))
    with pytest.raises(OperatorError, match="remainder_format"):
        fdtt.split_band_remainder(rows, cols, vals, 640,
                                  remainder_format="csr", device="cpu")
    with pytest.raises(OperatorError, match="reorder"):
        fdtt.split_band_remainder(rows, cols, vals, 640, reorder="amd",
                                  device="cpu")
    with pytest.raises(OperatorError, match="block rows"):
        fdtt.split_band_remainder(rows, cols, vals, 640, block_size=512,
                                  bandwidth=1, device="cpu")


def test_block_rows_multiple():
    rows, cols, vals = fdtt.generate_local_sparse(600, 6, locality=10.0,
                                                  seed=2)
    t = fdtt.split_band_remainder(rows, cols, vals, 600, block_size=16,
                                  bandwidth=1, block_rows_multiple=8,
                                  device="cpu")
    j = jsparse.split_band_remainder(rows, cols, vals, 600, block_size=16,
                                     bandwidth=1, block_rows_multiple=8)
    assert t.shape == j.shape == (640, 640)
    assert t.band.n_block_rows % 8 == 0


def test_convert_recognises_the_hybrid_first(local_coo):
    rows, cols, vals = local_coo
    for fmt in ("sell", "ell"):
        j = jsparse.split_band_remainder(rows, cols, vals, 600, block_size=64,
                                         bandwidth=1, remainder_format=fmt,
                                         reorder="rcm")
        t = convert.operator(j, device="cpu")
        assert isinstance(t, fdtt.HybridBandedOperator)
        assert isinstance(t.band, fdtt.BSROperator) and t.band.bandwidth == 1
        assert type(t.remainder).__name__ == type(j.remainder).__name__
        np.testing.assert_array_equal(to_numpy(t.perm), np.asarray(j.perm))
        X = _x(t.shape[0], 3)
        _assert_apply(t.matmat(torch.from_numpy(X)), j.matmat(jnp.asarray(X)))


# -- double-single applies (tests/test_ds_apply_sparse.py:108-139) ------

def _ds_block(n, k=4, seed=0, lo_scale=1e-8):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((n, k)).astype(np.float32)
    xh = (xh / np.linalg.norm(xh, axis=0)).astype(np.float32)
    xl = (rng.standard_normal((n, k)) * lo_scale).astype(np.float32)
    return torch.from_numpy(xh), torch.from_numpy(xl)


def _ds_err(op, xh, xl):
    """Column norms of (y_hi + y_lo) - A64 (x_hi + x_lo), A64 the float64
    promotion of the same stored matrix."""
    A64 = to_numpy(op.to_dense()).astype(np.float64)
    X64 = to_numpy(xh).astype(np.float64) + to_numpy(xl).astype(np.float64)
    yh, yl = op.matmat_ds(xh, xl)
    assert yh.dtype == yl.dtype == torch.float32
    y = to_numpy(yh).astype(np.float64) + to_numpy(yl).astype(np.float64)
    return np.linalg.norm(y - A64 @ X64, axis=0)


@pytest.fixture(scope="module")
def f32_case():
    rows, cols, vals = fdtt.generate_local_sparse(
        1024, 8, locality=40.0, sparsity=1e-3, seed=5, dtype=torch.float32)
    return rows, cols, vals


@pytest.mark.parametrize("kind", ["hybrid_sell", "hybrid_ell", "ell", "sell"])
def test_matmat_ds_on_the_off_diagonal_split(f32_case, kind):
    rows, cols, vals = f32_case
    if kind.startswith("hybrid"):
        op = fdtt.split_band_remainder(
            rows, cols, vals, 1024, block_size=16, bandwidth=1,
            dtype=torch.float32, remainder_format=kind.split("_")[1],
            device="cpu")
        assert op.remainder is not None  # the split must be exercised
    else:
        cls = {"ell": fdtt.ELLOperator, "sell": fdtt.SlicedELLOperator}[kind]
        op = cls.from_coo(rows, cols, vals, 1024, dtype=torch.float32,
                          device="cpu")
    off = op.offdiag()
    xh, xl = _ds_block(op.shape[0], seed=6)
    err = _ds_err(off, xh, xl)
    assert err.max() < DS_TOL
    # The plain float32 apply is far off that.
    y32 = (to_numpy(off.matmat(xh)).astype(np.float64)
           + to_numpy(off.matmat(xl)).astype(np.float64))
    A64 = to_numpy(off.to_dense()).astype(np.float64)
    X64 = to_numpy(xh).astype(np.float64) + to_numpy(xl).astype(np.float64)
    assert err.max() <= np.linalg.norm(y32 - A64 @ X64, axis=0).max()


def test_matmat_ds_matches_jax_on_the_hybrid(f32_case):
    rows, cols, vals = f32_case
    t = fdtt.split_band_remainder(rows, cols, vals, 1024, block_size=16,
                                  bandwidth=1, dtype=torch.float32,
                                  device="cpu").offdiag()
    j = jsparse.split_band_remainder(rows, cols, vals, 1024, block_size=16,
                                     bandwidth=1, dtype=jnp.float32).offdiag()
    xh, xl = _ds_block(t.shape[0], seed=6)
    th, tl = t.matmat_ds(xh, xl)
    jh, jl = j.matmat_ds(jnp.asarray(to_numpy(xh)), jnp.asarray(to_numpy(xl)))
    got = to_numpy(th).astype(np.float64) + to_numpy(tl).astype(np.float64)
    ref = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=DS_TOL)


def test_hybrid_without_remainder_passes_the_band_through():
    band = fdtt.generate_banded_bsr(32, 16, bandwidth=1, coupling=1e-3,
                                    dtype=torch.float32, device="cpu")
    hyb = fdtt.HybridBandedOperator(band, None)
    xh, xl = _ds_block(band.shape[0], seed=7)
    got = hyb.offdiag().matmat_ds(xh, xl)
    want = band.offdiag().matmat_ds(xh, xl)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_refined_solve_on_the_hybrid_holds_the_oracle(f32_case):
    # The recipe of tests/test_ds_apply_sparse.py:141-164 on the float32
    # hybrid: a loose warm start, then refined + final polish at relative
    # 1e-8, held to the float64 promotion of the stored matrix.
    rows, cols, vals = f32_case
    op = fdtt.split_band_remainder(rows, cols, vals, 1024, block_size=16,
                                   bandwidth=1, dtype=torch.float32,
                                   device="cpu")
    loose = fdtt.eigensolve(op, 4, method="DPR", tolerance=1e-3,
                            relative_tolerance=True, dtype="float32",
                            expansion="lowest-k", max_iterations=30)
    res = fdtt.eigensolve(op, 4, method="DPR", tolerance=1e-8,
                          relative_tolerance=True, dtype="float32",
                          expansion="lowest-k", refined=True, final_polish=3,
                          max_iterations=60,
                          initial_vectors=loose.eigenvectors)
    assert bool(res.converged)
    A64 = to_numpy(op.to_dense()).astype(np.float64)
    lam = to_numpy(res.eigenvalues).astype(np.float64)
    if res.eigenvalues_lo is not None:
        lam = lam + to_numpy(res.eigenvalues_lo).astype(np.float64)
    X = to_numpy(res.eigenvectors).astype(np.float64)
    X = X / np.linalg.norm(X, axis=0)
    r = np.linalg.norm(A64 @ X - X * lam[None, :], axis=0)
    assert np.max(r / np.maximum(np.abs(lam), 1.0)) <= 1e-8
