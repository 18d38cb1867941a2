"""The port's padded and sliced ELL operators, their native assembly and
the ELL generator against the JAX package, on the CPU.

The analogues of ``tests/test_native.py``, ``tests/test_sparse.py``'s
ELL class and ``tests/test_sell.py``. Inputs are numpy COO triplets from
a seed, handed to both packages. Tolerances:

- assembly: the port's native and numpy builders give the JAX package's
  tables bit for bit; native against numpy: index tables equal, values
  within 4 eps of max|value| (``std::sort`` is not stable, so three or
  more duplicates of one entry may be summed in another order);
- generators: bit-equal (the same numpy draws);
- applies in float64: within 1e-13 of max|Y| of the JAX package's (the
  same products, summed in chunks in another order inside a chunk);
- ``to_dense``, ``diagonal`` and ``offdiag``: bit-equal;
- solves: iterations within ±1, the same ``converged`` flag, eigenvalues
  within 1e-8, true residuals at the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu import native as jnative
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import convert, native
from fortran_davidson_tpu_torch.ops import sparse as tsparse
from fortran_davidson_tpu_torch.utils.errors import OperatorError
from tests.torch_parity import assert_parity, to_numpy, true_residuals

APPLY_RTOL = 1e-13


def _random_coo(n, nnz, seed, dtype=np.float64, with_dups=True):
    """``tests/test_native.py``'s COO: random entries, a quarter of them
    repeated."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    if with_dups:
        rows = np.concatenate([rows, rows[: nnz // 4]])
        cols = np.concatenate([cols, cols[: nnz // 4]])
        vals = np.concatenate([vals, vals[: nnz // 4]])
    return rows, cols, vals


def _sym_coo(n, nnz, seed):
    """``tests/test_sparse.py``'s symmetric COO with a dominant
    diagonal."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n, nnz)
    j = rng.integers(0, n, nnz)
    v = rng.random(nnz)
    rows = np.concatenate([i, j, np.arange(n)])
    cols = np.concatenate([j, i, np.arange(n)])
    vals = np.concatenate([v, v, np.full(n, 10.0 + n)])
    return rows, cols, vals


def _skewed_coo():
    """``tests/test_sell.py``'s skewed pattern: most rows hold 0-3 stray
    entries, six rows hold 20-25."""
    rng = np.random.default_rng(11)
    n = 400
    rows, cols, vals = [], [], []
    for r in range(n):
        k = 0 if r % 4 else rng.integers(1, 4)
        if r < 6:
            k = 20 + int(r)
        for c in rng.choice(n, size=k, replace=False):
            v = rng.standard_normal()
            rows += [r, c]
            cols += [c, r]
            vals += [v, v]
    rows += list(range(n))
    cols += list(range(n))
    vals += [50.0 + r for r in range(n)]
    return np.array(rows), np.array(cols), np.array(vals), n


def _x(n, m, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(dtype)


def _assert_sum_order(got, ref):
    """Equal up to the order in which duplicates were summed."""
    eps = np.finfo(ref.dtype).eps
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=4 * eps * np.max(np.abs(ref)))


def _assert_apply(got, ref):
    ref = np.asarray(ref)
    assert np.max(np.abs(to_numpy(got) - ref)) <= APPLY_RTOL * np.max(
        np.abs(ref))


# -- native assembly (tests/test_native.py) -----------------------------

def test_native_library_builds_into_the_build_dir():
    assert native.load() is not None
    st = native.status()
    assert st["built"] and "/_build/" in st["path"]
    assert not native.library_path().parent.samefile(
        jnative.__file__.rsplit("/", 1)[0])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_matches_numpy_and_jax(dtype):
    n = 57
    rows, cols, vals = _random_coo(n, 400, seed=1, dtype=dtype)
    got = native.ell_from_coo(rows, cols, vals, n)
    idx_np, val_np = tsparse._ell_from_coo_np(rows, cols, vals, n)
    idx_j, val_j = jsparse._ell_from_coo_np(rows, cols, vals, n)
    np.testing.assert_array_equal(got[0], idx_np)
    _assert_sum_order(got[1], val_np)
    np.testing.assert_array_equal(idx_np, idx_j)
    np.testing.assert_array_equal(val_np, val_j)
    if jnative.load() is not None:
        jgot = jnative.ell_from_coo(rows, cols, vals, n)
        np.testing.assert_array_equal(got[0], jgot[0])
        np.testing.assert_array_equal(got[1], jgot[1])


def test_native_pad_width():
    n = 20
    rows, cols, vals = _random_coo(n, 60, seed=2)
    got = native.ell_from_coo(rows, cols, vals, n, pad_width=32)
    assert got[0].shape == (n, 32)
    idx_np, val_np = tsparse._ell_from_coo_np(rows, cols, vals, n, 32)
    np.testing.assert_array_equal(got[0], idx_np)
    _assert_sum_order(got[1], val_np)


@pytest.mark.parametrize("build", [
    lambda: native.ell_from_coo(np.zeros(5, np.int64), np.arange(5),
                                np.ones(5), 6, pad_width=2),
    lambda: native.ell_from_coo([0, 9], [0, 0], [1.0, 1.0], 5),
    lambda: native.rcm_order([0, 5], [0, 0], 5),
    lambda: tsparse._ell_from_coo_np([1, 2], [0, -1], [1.0, 1.0], 5),
    lambda: tsparse._ell_from_coo_np([0, 9], [0, 0], [1.0, 1.0], 5),
    lambda: fdtt.SlicedELLOperator.from_coo([0, 5], [1, 1], [1.0, 2.0], 4,
                                            device="cpu"),
    lambda: fdtt.ELLOperator.from_coo([0, 5], [1, 1], [1.0, 2.0], 4,
                                      use_native=False, device="cpu"),
    lambda: native.ell_from_coo([0, 1, 2], [0, 1], [1.0, 1.0, 1.0], 5),
    lambda: native.rcm_order([0, 1, 2], [0, 1], 5),
], ids=["native_pad_too_small", "native_out_of_range", "rcm_out_of_range",
        "numpy_negative_col", "numpy_row_out_of_range", "sell_out_of_range",
        "ell_fallback_out_of_range", "native_ragged_coo", "rcm_ragged_coo"])
def test_bad_coo_raises(build):
    # The index contract of the native assembler and of its fallbacks: a
    # negative column would otherwise fold into key = row*n + col, and a
    # short array would be read past its end by the C++ code.
    with pytest.raises(ValueError):
        build()


def test_rcm_fallback_is_scipy_and_raises_out_of_range(monkeypatch):
    monkeypatch.setattr(native, "load", lambda: None)
    rows, cols, _ = _sym_coo(64, 100, seed=4)
    perm = native.rcm_order(rows, cols, 64)
    assert sorted(perm.tolist()) == list(range(64))
    with pytest.raises(ValueError):
        native.rcm_order([0, 5], [0, 0], 5)
    assert native.ell_from_coo(rows, cols, np.ones(len(rows)), 64) is None


def test_from_coo_native_and_fallback_agree():
    n = 48
    rows, cols, vals = _random_coo(n, 300, seed=3)
    a = fdtt.ELLOperator.from_coo(rows, cols, vals, n, device="cpu")
    b = fdtt.ELLOperator.from_coo(rows, cols, vals, n, use_native=False,
                                  device="cpu")
    assert torch.equal(a.indices, b.indices) and a.indices.dtype == torch.int32
    _assert_sum_order(to_numpy(a.values), to_numpy(b.values))


# -- ELLOperator (tests/test_sparse.py's TestELL) -----------------------

def test_ell_tables_roundtrip_and_split_match_jax():
    n = 37
    rows, cols, vals = _sym_coo(n, 120, seed=5)
    t = fdtt.ELLOperator.from_coo(rows, cols, vals, n, device="cpu")
    j = jsparse.ELLOperator.from_coo(rows, cols, vals, n)
    np.testing.assert_array_equal(to_numpy(t.indices), np.asarray(j.indices))
    np.testing.assert_array_equal(to_numpy(t.values), np.asarray(j.values))
    assert t.shape == (n, n) and t.nnz_per_row == j.nnz_per_row
    assert t.nnz == j.nnz
    for name in ("to_dense", "diagonal"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)()),
                                      np.asarray(getattr(j, name)()))
    np.testing.assert_array_equal(to_numpy(t.offdiag().to_dense()),
                                  np.asarray(j.offdiag().to_dense()))
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(to_numpy(t.to_dense()), dense, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_ell_matmat_chunking_matches_jax(chunk):
    n = 53
    rows, cols, vals = _sym_coo(n, 200, seed=6)
    t = fdtt.ELLOperator.from_coo(rows, cols, vals, n, chunk=chunk,
                                  device="cpu")
    j = jsparse.ELLOperator.from_coo(rows, cols, vals, n, chunk=chunk)
    X = _x(n, 7)
    _assert_apply(t.matmat(torch.from_numpy(X)), j.matmat(jnp.asarray(X)))
    _assert_apply(t.offdiag().matmat(torch.from_numpy(X)),
                  j.offdiag().matmat(jnp.asarray(X)))


def test_ell_float32_apply_matches_jax():
    n = 53
    rows, cols, vals = _sym_coo(n, 200, seed=7)
    t = fdtt.ELLOperator.from_coo(rows, cols, vals, n, dtype=torch.float32,
                                  device="cpu")
    j = jsparse.ELLOperator.from_coo(rows, cols, vals, n, dtype=jnp.float32)
    assert t.values.dtype == torch.float32
    X = _x(n, 5, dtype=np.float32)
    ref = np.asarray(j.matmat(jnp.asarray(X)))
    np.testing.assert_allclose(to_numpy(t.matmat(torch.from_numpy(X))), ref,
                               rtol=0, atol=1e-6 * np.max(np.abs(ref)))


def test_ell_from_csr_and_from_dense_match_jax():
    n = 20
    rows, cols, vals = _sym_coo(n, 40, seed=8)
    csr = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    t = fdtt.ELLOperator.from_csr(csr.indptr, csr.indices, csr.data,
                                  device="cpu")
    j = jsparse.ELLOperator.from_csr(csr.indptr, csr.indices, csr.data)
    np.testing.assert_array_equal(to_numpy(t.indices), np.asarray(j.indices))
    np.testing.assert_array_equal(to_numpy(t.values), np.asarray(j.values))
    dense = csr.toarray()
    t = fdtt.ELLOperator.from_dense(dense, device="cpu")
    j = jsparse.ELLOperator.from_dense(dense)
    np.testing.assert_array_equal(to_numpy(t.to_dense()),
                                  np.asarray(j.to_dense()))
    np.testing.assert_array_equal(to_numpy(t.to_dense()), dense)


def test_ell_duplicate_coo_entries_summed():
    op = fdtt.ELLOperator.from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 5.0], 2,
                                   device="cpu")
    np.testing.assert_array_equal(to_numpy(op.to_dense()),
                                  [[0.0, 5.0], [5.0, 0.0]])


@pytest.mark.parametrize("n,nnz_per_row,seed", [(400, 9, 3), (257, 1, 0),
                                                (64, 17, 5)])
def test_generate_sparse_diagonal_dominant_bit_equal(n, nnz_per_row, seed):
    j = jsparse.generate_sparse_diagonal_dominant(n, nnz_per_row, seed=seed)
    t = fdtt.generate_sparse_diagonal_dominant(n, nnz_per_row, seed=seed,
                                               device="cpu")
    np.testing.assert_array_equal(to_numpy(t.indices), np.asarray(j.indices))
    np.testing.assert_array_equal(to_numpy(t.values), np.asarray(j.values))
    # The COO helper gives the same operator through scipy's CSR.
    rows, cols, vals = tsparse.sparse_diagonal_dominant_coo(n, nnz_per_row,
                                                            seed=seed)
    csr = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    np.testing.assert_allclose(csr.toarray(), to_numpy(t.to_dense()),
                               rtol=0, atol=1e-15)


def test_eigensolve_on_ell_matches_jax():
    j = jsparse.generate_sparse_diagonal_dominant(400, 9, sparsity=1e-3,
                                                  seed=3)
    t = fdtt.generate_sparse_diagonal_dominant(400, 9, sparsity=1e-3, seed=3,
                                               device="cpu")
    rj = fdt.eigensolve(j, 4, tolerance=1e-8)
    rt = fdtt.eigensolve(t, 4, tolerance=1e-8)
    assert_parity(rj, rt, to_numpy(t.to_dense()), 1e-8, eig_atol=1e-8)


def test_eigensolve_scipy_csr_matches_jax():
    # scipy sparse input becomes an ELLOperator in both packages.
    rows, cols, vals = tsparse.sparse_diagonal_dominant_coo(300, 7, seed=9)
    csr = sp.csr_matrix((vals, (rows, cols)), shape=(300, 300))
    op = fdtt.as_operator(csr, device="cpu")
    assert isinstance(op, fdtt.ELLOperator) and op.dtype == torch.float64
    rj = fdt.eigensolve(csr, 3)
    rt = fdtt.eigensolve(op, 3)
    assert_parity(rj, rt, csr.toarray(), 1e-8, eig_atol=1e-8)


# -- SlicedELLOperator (tests/test_sell.py) ------------------------------

@pytest.fixture(scope="module")
def skewed():
    rows, cols, vals, n = _skewed_coo()
    return dict(coo=(rows, cols, vals, n),
                t=fdtt.SlicedELLOperator.from_coo(rows, cols, vals, n,
                                                  device="cpu"),
                j=jsparse.SlicedELLOperator.from_coo(rows, cols, vals, n),
                ell=fdtt.ELLOperator.from_coo(rows, cols, vals, n,
                                              device="cpu"))


def test_sell_buckets_equal_jax(skewed):
    t, j = skewed["t"], skewed["j"]
    assert len(t.bucket_rows) == len(j.bucket_rows) > 1
    for name in ("bucket_rows", "bucket_indices", "bucket_values"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    np.testing.assert_array_equal(to_numpy(t.gather_map),
                                  np.asarray(j.gather_map))
    assert t.gather_slots == j.gather_slots and t.nnz == j.nnz
    assert all(i.dtype == torch.int32 for i in t.bucket_indices)


def test_sell_matmat_matches_jax_and_ell(skewed):
    t, j, ell = skewed["t"], skewed["j"], skewed["ell"]
    n = t.shape[0]
    X = _x(n, 7)
    y = t.matmat(torch.from_numpy(X))
    _assert_apply(y, j.matmat(jnp.asarray(X)))
    _assert_apply(y, ell.matmat(torch.from_numpy(X)))


def test_sell_traffic_reduction(skewed):
    t, ell = skewed["t"], skewed["ell"]
    n = t.shape[0]
    assert t.gather_slots < n * ell.nnz_per_row / 3
    assert t.gather_slots <= 2 * t.nnz + n + sum(
        int(r.shape[0]) for r in t.bucket_rows)


def test_sell_diagonal_offdiag_to_dense_match_jax(skewed):
    t, j, ell = skewed["t"], skewed["j"], skewed["ell"]
    for name in ("diagonal", "to_dense"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)()),
                                      np.asarray(getattr(j, name)()))
    # The ELL fixture went through the native assembler, SELL through
    # numpy: duplicates summed in another order.
    _assert_sum_order(to_numpy(t.to_dense()), to_numpy(ell.to_dense()))
    od = t.offdiag()
    np.testing.assert_array_equal(to_numpy(od.to_dense()),
                                  np.asarray(j.offdiag().to_dense()))
    assert od.gather_slots == t.gather_slots


def test_sell_from_ell_and_to_ell_roundtrip(skewed):
    t, ell = skewed["t"], skewed["ell"]
    back = fdtt.SlicedELLOperator.from_ell(ell)
    np.testing.assert_array_equal(to_numpy(back.to_dense()),
                                  to_numpy(ell.to_dense()))
    again = t.to_ell()
    assert isinstance(again, fdtt.ELLOperator)
    np.testing.assert_array_equal(to_numpy(again.indices),
                                  to_numpy(ell.indices))
    _assert_sum_order(to_numpy(again.values), to_numpy(ell.values))


def test_sell_empty_and_zero_rows():
    t = fdtt.SlicedELLOperator.from_coo([], [], [], 8, device="cpu")
    j = jsparse.SlicedELLOperator.from_coo([], [], [], 8)
    assert t.shape == (8, 8) and len(t.bucket_rows) == 1
    assert tuple(t.bucket_indices[0].shape) == (0, 1)
    x = torch.ones((8, 3), dtype=torch.float64)
    assert torch.equal(t.matmat(x), torch.zeros_like(x))
    assert torch.equal(t.diagonal(), torch.zeros(8, dtype=torch.float64))
    np.testing.assert_array_equal(to_numpy(t.matmat(x)),
                                  np.asarray(j.matmat(jnp.ones((8, 3)))))
    with pytest.raises(OperatorError, match="bucket"):
        fdtt.SlicedELLOperator([], [], [], np.zeros(4), device="cpu")


def test_eigensolve_through_sell_matches_jax(skewed):
    t, j = skewed["t"], skewed["j"]
    rj = fdt.eigensolve(j, 3, tolerance=1e-9)
    rt = fdtt.eigensolve(t, 3, tolerance=1e-9)
    assert_parity(rj, rt, to_numpy(t.to_dense()), 1e-9, eig_atol=1e-8)


def test_convert_carries_ell_and_sell(skewed):
    j = skewed["j"]
    t = convert.operator(j, device="cpu")
    assert isinstance(t, fdtt.SlicedELLOperator)
    for a, b in zip(t.bucket_values, j.bucket_values):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    je = jsparse.ELLOperator.from_coo(*skewed["coo"][:3], skewed["coo"][3],
                                      chunk=5)
    te = convert.operator(je, device="cpu")
    assert type(te) is fdtt.ELLOperator and te.chunk == 5
    np.testing.assert_array_equal(to_numpy(te.values), np.asarray(je.values))
    X = _x(t.shape[0], 3)
    rt = true_residuals(to_numpy(t.to_dense()), X, np.zeros(3))
    np.testing.assert_allclose(
        rt, np.linalg.norm(to_numpy(te.matmat(torch.from_numpy(X))), axis=0),
        rtol=1e-13)
