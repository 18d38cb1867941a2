"""Reverse Cuthill-McKee reordering of the port's hybrid operator
(``split_band_remainder(..., reorder="rcm")``) against the JAX package, on
the CPU: the analogue of ``tests/test_rcm.py``.

The native ordering is the JAX package's bit for bit (the same C++ file);
the scipy fallback is of the same quality, not the same ordering.
Tolerances: band fraction and tables equal to the JAX package's; solves:
iterations within ±1, the same ``converged`` flag, eigenvalues within
1e-8; unpermuted eigenvectors within 1e-6 of scipy's in overlap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse
import scipy.sparse.csgraph as csg
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu import native as jnative
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import native
from tests.torch_parity import assert_parity, to_numpy


def scrambled_local_coo(n, seed=3):
    """A locality-bearing pattern behind a random permutation."""
    rows, cols, vals = fdtt.generate_local_sparse(n, 10, locality=12.0,
                                                  seed=seed)
    scram = np.random.default_rng(seed + 1).permutation(n)
    return scram[rows], scram[cols], vals


def _bandwidth(perm, rows, cols):
    inv = np.empty(len(perm), np.int64)
    inv[perm] = np.arange(len(perm))
    return np.abs(inv[rows] - inv[cols])


def test_rcm_recovers_the_bandwidth_and_equals_jax():
    n = 512
    rows, cols, _ = scrambled_local_coo(n)
    perm = native.rcm_order(rows, cols, n)
    assert native.status()["used"]["rcm_order"] > 0
    assert sorted(perm.tolist()) == list(range(n))
    spread = _bandwidth(perm, rows, cols)
    assert np.abs(rows - cols).max() > n // 2
    assert spread.max() < n // 4 and np.median(spread) < 64
    jperm = jnative.rcm_order(rows, cols, n)
    if jnative.load() is not None:
        np.testing.assert_array_equal(perm, jperm)


def test_native_matches_the_scipy_fallback_in_quality(monkeypatch):
    n = 256
    rows, cols, _ = scrambled_local_coo(n, seed=9)
    nat = native.rcm_order(rows, cols, n)
    monkeypatch.setattr(native, "load", lambda: None)
    fallback = native.rcm_order(rows, cols, n)
    pattern = scipy.sparse.coo_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_array_equal(fallback, csg.reverse_cuthill_mckee(
        pattern, symmetric_mode=True))
    assert (_bandwidth(nat, rows, cols).max()
            <= 2 * _bandwidth(fallback, rows, cols).max() + 16)


def test_band_fraction_improves_as_in_jax():
    n = 768
    rows, cols, vals = scrambled_local_coo(n)
    raw = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                    bandwidth=1, device="cpu")
    rcm = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                    bandwidth=1, reorder="rcm", device="cpu")
    assert rcm.band_fraction > raw.band_fraction + 0.2
    assert rcm.band_fraction > 0.9
    j = jsparse.split_band_remainder(rows, cols, vals, n, block_size=64,
                                     bandwidth=1, reorder="rcm")
    assert rcm.band_fraction == j.band_fraction
    np.testing.assert_array_equal(to_numpy(rcm.perm), np.asarray(j.perm))
    assert rcm.perm.dtype == torch.int32


def test_eigensolve_and_unpermute_match_jax():
    n = 530  # not a multiple of the block: padding and reordering mixed
    rows, cols, vals = scrambled_local_coo(n, seed=5)
    t = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                  bandwidth=1, reorder="rcm", device="cpu")
    j = jsparse.split_band_remainder(rows, cols, vals, n, block_size=64,
                                     bandwidth=1, reorder="rcm")
    rt = fdtt.eigensolve(t, 4, tolerance=1e-8)
    rj = fdt.eigensolve(j, 4, tolerance=1e-8)
    assert_parity(rj, rt, to_numpy(t.to_dense()), 1e-8, eig_atol=1e-8)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    w, V = scipy.linalg.eigh(dense)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues), w[:4], rtol=0,
                               atol=1e-8)
    back = to_numpy(t.unpermute(rt.eigenvectors))
    assert back.shape == (n, 4)
    np.testing.assert_array_equal(
        back, np.asarray(j.unpermute(jnp.asarray(to_numpy(rt.eigenvectors)))))
    for k in range(4):
        np.testing.assert_allclose(np.abs(back[:, k] @ V[:, k]), 1.0,
                                   atol=1e-6)
    # Without a reordering, unpermute hands the rows back as they are.
    plain = fdtt.split_band_remainder(rows, cols, vals, n, block_size=64,
                                      bandwidth=1, device="cpu")
    assert plain.unpermute(rt.eigenvectors) is rt.eigenvectors
