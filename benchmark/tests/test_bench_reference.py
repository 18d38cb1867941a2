"""The plain reference against dense linear algebra at small n, the
device draw's ranges against the whole table, and the program's plain
solve against the reference."""

import numpy as np
import pytest
import torch

from benchmark import banded, reference, surrogate


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(banded, "CHUNK_ROWS", 5)


BANDED = dict(n_block_rows=23, block_size=8, bandwidth=2, coupling=1e-3,
              dtype="float64")


def _dense(blocks, params):
    nbr, bs = params["n_block_rows"], params["block_size"]
    bw = params["bandwidth"]
    dense = np.zeros((nbr * bs, nbr * bs))
    b = blocks.numpy()
    for r in range(nbr):
        for k in range(2 * bw + 1):
            c = r - bw + k
            if 0 <= c < nbr:
                dense[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += \
                    b[r, :, k * bs:(k + 1) * bs]
    return dense


@pytest.mark.parametrize("rows", [(0, 7), (7, 14), (14, 23), (3, 4),
                                  (22, 23), (1, 2)])
def test_a_range_of_rows_is_the_whole_draw_s(small_chunks, rows):
    whole = banded.draw_rows(BANDED, 2**31 + 5, slice(0, 23), "cpu")
    a, b = rows
    part = banded.draw_rows(BANDED, 2**31 + 5, slice(a, b), "cpu")
    assert torch.equal(part, whole[a:b])


def test_banded_recipe_and_reference(small_chunks):
    blocks = banded.draw_rows(BANDED, 7, slice(0, 23), "cpu")
    dense = _dense(blocks, BANDED)
    assert np.array_equal(dense, dense.T)
    assert np.array_equal(np.diag(dense), np.arange(1, 23 * 8 + 1))
    off = dense - np.diag(np.diag(dense))
    assert np.abs(off).max() <= 1e-3          # (u - 0.5) * c, doubled on D
    assert (banded.draw_rows(BANDED, 8, slice(0, 23), "cpu")
            != blocks).any()                   # the seed draws the entries
    x = torch.randn(23 * 8, 5, dtype=torch.float64)
    y = banded.reference_apply(blocks, x, chunk_rows=4)
    assert torch.allclose(y, torch.from_numpy(dense) @ x, rtol=0, atol=1e-12)
    # A slab of rows with its neighbours' halo rows (bw * bs each side).
    h = 2 * 8
    y_mid = banded.reference_apply(blocks[5:12], x[40:96], x[40 - h:40],
                                   x[96:96 + h])
    assert torch.allclose(y_mid, (torch.from_numpy(dense) @ x)[40:96],
                          rtol=0, atol=1e-12)
    ref = banded.reference_eigenvalues(blocks, 6)
    assert np.allclose(ref, np.linalg.eigvalsh(dense)[:6], rtol=0,
                       atol=1e-12)


def test_block_cols_are_the_dia_table():
    cols = banded.block_cols(BANDED, slice(0, 23), "cpu")
    assert cols.dtype == torch.int32 and cols.shape == (23, 5)
    assert cols[0].tolist() == [0, 0, 0, 1, 2]
    assert cols[22].tolist() == [20, 21, 22, 22, 22]


def _surrogate_dense(t, rho):
    c, s = np.cos(t), np.sin(t)
    a = rho * (np.outer(c, c) - np.outer(s, s))
    np.fill_diagonal(a, 0.0)
    return a + np.diag(np.arange(1, t.shape[0] + 1, dtype=np.float64))


@pytest.mark.parametrize("n", [600, 601, 1000])
def test_surrogate_reference(n):
    params = {"n": n, "coupling": 1e-4, "dtype": "float64"}
    t = surrogate.phases(params, "cpu")
    dense = _surrogate_dense(t.numpy(), 1e-4)
    x = torch.randn(n, 4, dtype=torch.float64)
    y = surrogate.reference_apply(t, 1e-4, x)
    assert torch.allclose(y, torch.from_numpy(dense) @ x, rtol=0, atol=1e-11)
    ref = surrogate.reference_eigenvalues(t, 1e-4, 20)
    assert np.allclose(ref, np.linalg.eigvalsh(dense)[:20], rtol=0,
                       atol=1e-11)


def test_surrogate_is_the_sources_operator():
    t = surrogate.phases({"n": 1000}, "cpu")
    assert t[0] == 0.0
    assert float(t[500]) == pytest.approx(0.37 * 3.141592653589793)


def test_program_plain_solve_against_the_reference(small_chunks):
    """The program's solve on the CPU (its plain kernel versions) at a
    small n, judged as a run judges the window's solves."""
    import fortran_davidson_tpu_torch as fdtt
    params = dict(BANDED, n_block_rows=40, bandwidth=1)
    blocks = banded.draw_rows(params, 11, slice(0, 40), "cpu")
    op = fdtt.BSROperator(banded.block_cols(params, slice(0, 40), "cpu"),
                          blocks, bandwidth=1)
    res = fdtt.eigensolve(op, 6, method="DPR", tolerance=1e-8,
                          relative_tolerance=True, expansion="lowest-k",
                          dtype="float64", max_dim_sub=24)
    assert res.converged
    x = reference.probe_block(3, 0, 40 * 8, 6, torch.float64, "cpu")
    values = reference.readings(
        [res.eigenvalues.numpy()], banded.reference_eigenvalues(blocks, 6),
        [(res.eigenvalues, res.eigenvectors)],
        lambda v: banded.reference_apply(blocks, v), reference.Comm(),
        probe=(x, op.matmat(x)),
        apply_abs=lambda v: banded.reference_apply(blocks, v, absolute=True))
    assert values["eig_gap"] < 1e-12
    assert values["residual"] <= 1e-8
    assert values["orthonormality"] < 1e-12
    assert values["apply_gap"] < 1e-14
    limits = {"eig_gap": 1e-12, "residual": 1e-8, "orthonormality": 1e-12,
              "apply_gap": 1e-12}
    ok, checks = reference.judge(values, limits, 0)
    assert ok and list(checks)[-1] == "failed_solves"
    assert not reference.judge(values, limits, 1)[0]
    assert not reference.judge(dict(values, apply_gap=None), limits, 0)[0]


def test_absolute_applies_bound_the_magnitudes(small_chunks):
    blocks = banded.draw_rows(BANDED, 7, slice(0, 23), "cpu")
    dense = torch.from_numpy(_dense(blocks, BANDED))
    x = torch.rand(23 * 8, 3, dtype=torch.float64)
    y = banded.reference_apply(blocks, x, chunk_rows=4, absolute=True)
    assert torch.allclose(y, torch.abs(dense) @ x, rtol=1e-14, atol=0)
    t = surrogate.phases({"n": 600}, "cpu")
    dense = torch.from_numpy(_surrogate_dense(t.numpy(), 1e-4))
    x = torch.rand(600, 3, dtype=torch.float64)
    y = surrogate.reference_apply(t, 1e-4, x, absolute=True)
    assert bool(torch.all(y >= torch.abs(dense) @ x * (1 - 1e-14)))
    assert bool(torch.all(y <= torch.abs(dense) @ x + 2e-4 * x.sum(0)))


def test_apply_gap_reads_rounding_and_a_wrong_row(small_chunks):
    blocks = banded.draw_rows(BANDED, 7, slice(0, 23), "cpu")
    dense = torch.from_numpy(_dense(blocks, BANDED))
    x = reference.probe_block(2**40 + 1, 0, 23 * 8, 4, torch.float64, "cpu")
    assert torch.equal(x, reference.probe_block(2**40 + 1, 0, 23 * 8, 4,
                                                torch.float64, "cpu"))
    assert not torch.equal(x, reference.probe_block(2**40 + 1, 1, 23 * 8, 4,
                                                    torch.float64, "cpu"))

    def gap(y):
        return reference.apply_gap(
            x, y, lambda v: banded.reference_apply(blocks, v),
            lambda v: banded.reference_apply(blocks, v, absolute=True),
            reference.Comm())
    assert gap(dense @ x) < 1e-15
    assert 1e-9 < gap((dense @ x).float()) < 1e-6
    wrong = dense @ x
    wrong[150] = 0.0
    assert gap(wrong) > 0.5
    wrong[150, 0] = float("nan")
    assert gap(wrong) == float("inf")
