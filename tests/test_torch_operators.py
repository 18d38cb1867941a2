"""The port's operators, generators and small linear algebra against the
JAX package's, on the same numpy-built inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.core import orthogonal as jorth
from fortran_davidson_tpu.models import generators as jgen
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu.utils import linalg as jlinalg
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.core import orthogonal
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.ops import sparse as tsparse
from fortran_davidson_tpu_torch.utils import linalg as tlinalg
from fortran_davidson_tpu_torch.utils.errors import (NumericalError,
                                                     OperatorError)
from tests.torch_parity import to_numpy

RTOL = 1e-12


@pytest.mark.parametrize("nbr,bs,bw,seed,dtype", [
    (8, 4, 1, 0, "float64"), (12, 8, 2, 3, "float64"),
    (9, 16, 3, 7, "float32"), (5, 2, 2, 11, "float64")])
def test_generate_banded_bsr_bit_equal(nbr, bs, bw, seed, dtype):
    j = jsparse.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                                    coupling=0.05, dtype=dtype)
    t = tsparse.generate_banded_bsr(nbr, bs, bandwidth=bw, seed=seed,
                                    coupling=0.05, dtype=dtype, device="cpu")
    assert t.bandwidth == j.bandwidth == bw
    np.testing.assert_array_equal(to_numpy(t.block_cols), np.asarray(j.block_cols))
    np.testing.assert_array_equal(to_numpy(t.blocks), np.asarray(j.blocks))
    assert to_numpy(t.blocks).dtype == np.dtype(dtype)


def test_bse_surrogate_bit_equal():
    np.testing.assert_array_equal(to_numpy(tgen.bse_surrogate(200, device="cpu")),
                                  np.asarray(jgen.bse_surrogate(200)))


def _bsr_pair(kind):
    if kind == "banded":
        j = jsparse.generate_banded_bsr(10, 8, bandwidth=2, seed=1,
                                        coupling=0.1)
    elif kind == "general":
        rng = np.random.default_rng(2)
        dense = rng.standard_normal((48, 48)) * (rng.random((48, 48)) < 0.05)
        dense = dense + dense.T + np.diag(np.arange(1.0, 49.0))
        j = jsparse.BSROperator.from_dense(dense, 8)
    else:  # from_block_coo with scrambled rows and own-row padding
        rng = np.random.default_rng(3)
        brows = np.array([0, 3, 1, 2, 0, 3, 2, 1])
        bcols = np.array([0, 3, 1, 2, 3, 0, 1, 2])
        vals = rng.standard_normal((8, 4, 4))
        j = jsparse.BSROperator.from_block_coo(brows, bcols, vals, 4,
                                               pad_width=4)
    return j, convert.operator(j, device="cpu")


@pytest.mark.parametrize("kind", ["banded", "general", "coo"])
def test_bsr_operator_matches_jax(kind, rng):
    j, t = _bsr_pair(kind)
    n = j.shape[0]
    assert t.shape == j.shape and t.bandwidth == j.bandwidth
    X = rng.standard_normal((n, 5))
    np.testing.assert_allclose(to_numpy(t.matmat(torch.from_numpy(X))),
                               np.asarray(j.matmat(jnp.asarray(X))),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(to_numpy(t.diagonal()),
                                  np.asarray(j.diagonal()))
    np.testing.assert_array_equal(to_numpy(t.to_dense()),
                                  np.asarray(j.to_dense()))
    np.testing.assert_array_equal(to_numpy(t.offdiag().to_dense()),
                                  np.asarray(j.offdiag().to_dense()))
    np.testing.assert_allclose(to_numpy(t.offdiag().matmat(torch.from_numpy(X))),
                               np.asarray(j.offdiag().matmat(jnp.asarray(X))),
                               rtol=RTOL, atol=RTOL)


def test_bsr_constructors_match_jax():
    j, _ = _bsr_pair("general")
    dense = np.asarray(j.to_dense())
    t = tsparse.BSROperator.from_dense(dense, 8, device="cpu")
    np.testing.assert_array_equal(to_numpy(t.block_cols), np.asarray(j.block_cols))
    np.testing.assert_array_equal(to_numpy(t.blocks), np.asarray(j.blocks))
    with pytest.raises(OperatorError):
        tsparse.BSROperator.from_dense(dense[:47, :47], 8, device="cpu")
    with pytest.raises(OperatorError):
        tsparse.BSROperator(np.zeros((3, 2), np.int32), np.zeros((3, 4, 4)),
                            device="cpu")


def test_bsr_mixed_precision_storage(rng):
    j = jsparse.generate_banded_bsr(16, 8, bandwidth=1, seed=12,
                                    dtype=jnp.float32)
    t = convert.operator(j, device="cpu")
    X = rng.standard_normal((j.shape[0], 4)).astype(np.float32)
    out = t.astype(torch.bfloat16).matmat(torch.from_numpy(X))
    assert out.dtype == torch.float32
    ref = np.asarray(j.astype(jnp.bfloat16).matmat(jnp.asarray(X)))
    np.testing.assert_allclose(to_numpy(out), ref, rtol=1e-5,
                               atol=1e-5 * np.max(np.abs(ref)))


def test_convert_roundtrips_dense_and_diagonal(rng):
    A = np.asarray(jgen.generate_diagonal_dominant(20, 1e-2))
    jd = fdt.DenseOperator(A)
    td = convert.operator(jd, device="cpu")
    assert isinstance(td, fdtt.DenseOperator)
    np.testing.assert_array_equal(to_numpy(td.to_dense()), np.asarray(jd.to_dense()))
    jg = fdt.DiagonalOperator(jnp.arange(1.0, 21.0))
    tg = convert.operator(jg, device="cpu")
    assert isinstance(tg, fdtt.DiagonalOperator)
    np.testing.assert_array_equal(to_numpy(tg.diagonal()), np.asarray(jg.diagonal()))
    X = rng.standard_normal((20, 3))
    for jo, to in ((jd, td), (jg, tg)):
        np.testing.assert_allclose(to_numpy(to.matmat(torch.from_numpy(X))),
                                   np.asarray(jo.matmat(jnp.asarray(X))),
                                   rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(
            to_numpy(to.offdiag().matmat(torch.from_numpy(X))),
            np.asarray(jo.offdiag().matmat(jnp.asarray(X))),
            rtol=RTOL, atol=RTOL)
    f32 = convert.dense(A, dtype="float32", device="cpu")
    assert f32.dtype == torch.float32
    with pytest.raises(OperatorError):
        convert.operator(jgen.surrogate_hamiltonian(8), device="cpu")


def test_matrix_free_probed_diagonal_matches_jax():
    rng = np.random.default_rng(4)
    M = rng.standard_normal((300, 300))
    M = M + M.T
    jop = fdt.MatrixFreeOperator(lambda X, M: M @ X, 300,
                                 captured=(jnp.asarray(M),))
    top = fdtt.MatrixFreeOperator(lambda X, M: M @ X, 300,
                                  captured=(torch.from_numpy(M),))
    np.testing.assert_array_equal(to_numpy(top.diagonal()),
                                  np.asarray(jop.diagonal()))
    np.testing.assert_allclose(to_numpy(top.offdiag().diagonal()), 0.0)


def test_surrogates_match_jax(rng):
    X = rng.standard_normal((257, 4))
    for jfn, tfn in ((jgen.surrogate_hamiltonian, tgen.surrogate_hamiltonian),
                     (jgen.surrogate_overlap, tgen.surrogate_overlap)):
        jop, top = jfn(257, coupling=1e-2), tfn(257, coupling=1e-2,
                                                device="cpu")
        np.testing.assert_allclose(to_numpy(top.matmat(torch.from_numpy(X))),
                                   np.asarray(jop.matmat(jnp.asarray(X))),
                                   rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(
            to_numpy(top.offdiag().matmat(torch.from_numpy(X))),
            np.asarray(jop.offdiag().matmat(jnp.asarray(X))),
            rtol=RTOL, atol=RTOL)
        np.testing.assert_array_equal(to_numpy(top.diagonal()),
                                      np.asarray(jop.diagonal()))


def test_from_element_fn_matches_jax(rng):
    def fn(i, j):
        return jnp.where(i == j, 1.0 + i, 1e-3 / (1.0 + i + j))

    def tfn(i, j):
        i, j = i.double(), j.double()
        return torch.where(i == j, 1.0 + i, 1e-3 / (1.0 + i + j))

    jop = fdt.from_element_fn(fn, 70, row_block=16)
    top = fdtt.from_element_fn(tfn, 70, row_block=16, device="cpu")
    X = rng.standard_normal((70, 3))
    np.testing.assert_allclose(to_numpy(top.matmat(torch.from_numpy(X))),
                               np.asarray(jop.matmat(jnp.asarray(X))),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(to_numpy(top.diagonal()),
                                  np.asarray(jop.diagonal()))


def test_as_operator_routes_and_rejects():
    assert isinstance(fdtt.as_operator(np.eye(3), device="cpu"),
                      fdtt.DenseOperator)
    assert isinstance(fdtt.as_operator(np.ones(3), device="cpu"),
                      fdtt.DiagonalOperator)
    # scipy sparse input becomes an ELLOperator (the port refused it by
    # name until the ELL family was ported), on the device asked for.
    ell = fdtt.as_operator(scipy.sparse.eye(4, format="csr"), device="cpu")
    assert isinstance(ell, fdtt.ELLOperator) and ell.device.type == "cpu"
    assert torch.equal(ell.to_dense(), torch.eye(4, dtype=torch.float64))
    with pytest.raises(OperatorError):
        fdtt.as_operator(np.zeros((2, 2, 2)), device="cpu")
    with pytest.raises(OperatorError):
        fdtt.DenseOperator(np.zeros((2, 3)), device="cpu")


def test_linalg_matches_jax(rng):
    M = rng.standard_normal((12, 12))
    H = M + M.T
    S = np.eye(12) + 0.1 * (M @ M.T) / 12
    for Sx in (None, S):
        wj, Wj = jlinalg.generalized_eigensolver(jnp.asarray(H),
                                                 None if Sx is None else jnp.asarray(Sx))
        wt, Wt = tlinalg.generalized_eigensolver(
            torch.from_numpy(H), None if Sx is None else torch.from_numpy(Sx))
        np.testing.assert_allclose(to_numpy(wt), np.asarray(wj), atol=1e-12)
        # eigenvector signs differ between LAPACK builds: compare |W|
        np.testing.assert_allclose(np.abs(to_numpy(Wt)), np.abs(np.asarray(Wj)),
                                   atol=1e-10)
    wl, Wl = tlinalg.generalized_eigensolver_lowest(torch.from_numpy(H), 3)
    assert wl.shape == (3,) and Wl.shape == (12, 3)
    b = rng.standard_normal(12)
    np.testing.assert_allclose(to_numpy(tlinalg.solve_symmetric(torch.from_numpy(H),
                                                                torch.from_numpy(b))),
                               np.asarray(jlinalg.solve_symmetric(jnp.asarray(H),
                                                                  jnp.asarray(b))),
                               rtol=1e-10)
    sing = np.zeros((3, 3))
    assert np.all(np.isfinite(to_numpy(tlinalg.solve_symmetric(
        torch.from_numpy(sing), torch.ones(3, dtype=torch.float64)))))
    w = rng.standard_normal(6)
    V = rng.standard_normal((4, 6))
    sj = jlinalg.sort_eigenpairs(jnp.asarray(w), jnp.asarray(V))
    st = tlinalg.sort_eigenpairs(torch.from_numpy(w), torch.from_numpy(V))
    for a, b_ in zip(st, sj):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b_))
    for method in ("cholqr2", "qr"):
        Q = to_numpy(tlinalg.qr_orthonormalize(torch.from_numpy(M[:, :5]), method))
        np.testing.assert_allclose(Q.T @ Q, np.eye(5), atol=1e-12)
    with pytest.raises(NumericalError, match="DSYEV"):
        tlinalg.check_finite("DSYEV", torch.tensor([1.0, float("nan")]))


def test_svqb_drops_rank_deficient_directions():
    rng = np.random.default_rng(8)
    base = rng.standard_normal((40, 2))
    block = np.concatenate([base, base @ np.array([[1.0], [2.0]]),
                            np.zeros((40, 1))], axis=1)
    mask = np.array([1.0, 1.0, 1.0, 0.0])
    Qj, aj = jorth.svqb(jnp.asarray(block), jnp.asarray(mask),
                        return_alive=True)
    Qt, at = orthogonal.svqb(torch.from_numpy(block), torch.from_numpy(mask),
                             return_alive=True)
    np.testing.assert_array_equal(to_numpy(at), np.asarray(aj))
    assert to_numpy(at).tolist() == [1.0, 1.0, 0.0, 0.0]
    Qt = to_numpy(Qt)
    np.testing.assert_allclose(Qt.T @ Qt, np.diag(to_numpy(at)), atol=1e-12)
    # the same span as the JAX package's basis
    Pj = np.asarray(Qj) @ np.asarray(Qj).T
    np.testing.assert_allclose(Qt @ Qt.T, Pj, atol=1e-12)
