"""The int8 banded operator and the incremental-H (fused SpMM+Gram) engine
of the port against the JAX package, on numpy-built inputs handed to
both.

Tolerances: operator applies to 1e-5 of max|Y| (float32 sums in another
order); generator and quantizer outputs bit-equal; solves: iterations
within ±1, the same ``converged`` flag, eigenvalues to 1e-5 (relative to
|λ| ≥ 1: the float32 trajectories of the two packages part at roundoff);
at k=128 with a collapse, eigenvalues within the sum of the two solves'
true residuals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu.solver as jax_solver
import fortran_davidson_tpu_torch as fdtt
import fortran_davidson_tpu_torch.solver as torch_solver
from fortran_davidson_tpu.ops import sparse as jsparse
from fortran_davidson_tpu_torch import convert
from tests.torch_parity import to_numpy


def _x(n, m, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(
        np.float32)


def _assert_apply_close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_numpy(out), ref, rtol=1e-5,
                               atol=1e-5 * np.max(np.abs(ref)))


@pytest.mark.parametrize("nbr,bs,bw,seed", [(16, 8, 1, 0), (24, 8, 2, 3),
                                            (9, 5, 3, 7)])
def test_generate_banded_bsr_quantized_bit_equal(nbr, bs, bw, seed):
    j = jsparse.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw,
                                              coupling=1e-2, seed=seed)
    t = fdtt.generate_banded_bsr_quantized(nbr, bs, bandwidth=bw,
                                           coupling=1e-2, seed=seed,
                                           device="cpu")
    for name in ("qblocks", "scale_rows", "diag"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)),
                                      np.asarray(getattr(j, name)))
    assert t.bandwidth == bw and t.qblocks.dtype == torch.int8


def test_quantize_banded_int8_matches_jax():
    base = jsparse.generate_banded_bsr(32, 8, bandwidth=2, coupling=1e-3,
                                       dtype=jnp.float32)
    j = jsparse.quantize_banded_int8(base)
    t = fdtt.quantize_banded_int8(convert.operator(base, device="cpu"))
    for name in ("qblocks", "scale_rows", "diag"):
        np.testing.assert_array_equal(to_numpy(getattr(t, name)),
                                      np.asarray(getattr(j, name)))
    with pytest.raises(fdtt.OperatorError):
        fdtt.quantize_banded_int8(fdtt.BSROperator(
            np.array(base.block_cols), np.array(base.blocks), device="cpu"))


def test_quantized_operator_matches_jax():
    j = jsparse.quantize_banded_int8(jsparse.generate_banded_bsr(
        24, 8, bandwidth=2, coupling=1e-2, seed=5, dtype=jnp.float32))
    t = convert.operator(j, device="cpu")
    assert isinstance(t, fdtt.QuantizedBandedOperator)
    assert t.shape == j.shape and t.dtype == torch.float32
    assert t.device.type == "cpu"
    X = _x(t.shape[0], 6, seed=1)
    _assert_apply_close(t.matmat(torch.from_numpy(X)),
                        j.matmat(jnp.asarray(X)))
    np.testing.assert_array_equal(to_numpy(t.diagonal()),
                                  np.asarray(j.diagonal()))
    _assert_apply_close(t.offdiag().matmat(torch.from_numpy(X)),
                        j.offdiag().matmat(jnp.asarray(X)))
    assert float(torch.max(torch.abs(t.offdiag().diagonal()))) == 0.0
    np.testing.assert_array_equal(to_numpy(t.to_dense()),
                                  np.asarray(j.to_dense()))
    # The compensated apply against the JAX package's on the same hi and
    # lo words, both held to a float64 oracle of the same stored matrix:
    # what is left is each slot's float32 sum of integer products times
    # its scale (~1e-9 at coupling 1e-2), in another order in each.
    Xl = (_x(t.shape[0], 6, seed=5) * 1e-8).astype(np.float32)
    X64 = X.astype(np.float64) + Xl
    for tj, tt in ((j, t), (j.offdiag(), t.offdiag())):
        oracle = np.asarray(tj.to_dense(), np.float64) @ X64
        yh, yl = tj.matmat_ds(jnp.asarray(X), jnp.asarray(Xl))
        th, tl = tt.matmat_ds(torch.from_numpy(X), torch.from_numpy(Xl))
        assert th.dtype == tl.dtype == torch.float32
        err_j = np.abs(np.asarray(yh, np.float64) + np.asarray(yl) - oracle)
        err_t = np.abs(to_numpy(th).astype(np.float64) + to_numpy(tl)
                       - oracle)
        assert err_t.max() < 2e-8 and err_j.max() < 2e-8
        assert err_t.max() <= 2.0 * err_j.max()


def test_convert_recognises_the_int8_operator_before_the_diagonal():
    # The JAX int8 operator has a (nbr, bs) ``diag`` and no ``fn``: it
    # must not become a DiagonalOperator of a 2-D tensor.
    j = jsparse.generate_banded_bsr_quantized(16, 8, bandwidth=1, seed=2)
    t = convert.operator(j, device="cpu")
    assert isinstance(t, fdtt.QuantizedBandedOperator)
    X = _x(t.shape[0], 3, seed=2)
    _assert_apply_close(t.matmat(torch.from_numpy(X)),
                        j.matmat(jnp.asarray(X)))


@pytest.mark.parametrize("bandwidth", [1, None])
def test_bsr_matmat_with_gram_matches_jax(bandwidth):
    # Banded storage takes the fused kernel's plain version, general
    # storage the two-pass composition; both against the JAX package's
    # two-pass composition (same math, f32 gram). G: 1e-5 of |V|ᵀ|Y|.
    base = jsparse.generate_banded_bsr(16, 8, bandwidth=1, seed=4,
                                       dtype=jnp.float32)
    j = base if bandwidth else jsparse.BSROperator(base.block_cols,
                                                   base.blocks)
    t = convert.operator(j, device="cpu")
    n = t.shape[0]
    X, V = _x(n, 5, seed=3), _x(n, 9, seed=4)
    for v in (None, V):
        yj, gj = j.matmat_with_gram(jnp.asarray(X),
                                    None if v is None else jnp.asarray(v))
        yt, gt = t.matmat_with_gram(torch.from_numpy(X),
                                    None if v is None else torch.from_numpy(v))
        _assert_apply_close(yt, yj)
        vv = X if v is None else v
        bound = 1e-5 * (np.abs(vv).T.astype(np.float64)
                        @ np.abs(np.asarray(yj, np.float64)))
        assert gt.dtype == torch.float32
        assert np.all(np.abs(to_numpy(gt) - np.asarray(gj)) <= bound)
        gt_only = t.matmat_with_gram(torch.from_numpy(X),
                                     None if v is None else torch.from_numpy(v),
                                     write_out=False)
        torch.testing.assert_close(gt_only, gt, rtol=0, atol=0)


# -- the fused_gram gate ------------------------------------------------

def _gate_operators():
    base = jsparse.generate_banded_bsr(64, 16, bandwidth=1, seed=0)  # n=1024
    return {
        "dense": np.eye(1024) * np.arange(1.0, 1025.0),
        "banded": base,
        "general": jsparse.BSROperator(base.block_cols, base.blocks),
        "int8": jsparse.generate_banded_bsr_quantized(64, 16, bandwidth=1),
    }


@pytest.mark.parametrize("option", ["auto", "on", "off"])
@pytest.mark.parametrize("kind", ["dense", "banded", "general", "int8"])
def test_fused_gram_gate_resolves_as_jax(monkeypatch, kind, option):
    seen = {}

    def jax_get_engine(cfg):
        seen["jax"] = cfg
        return lambda *args, **kwargs: None

    def torch_engine(cfg, A, B, X0=None):
        seen["torch"] = cfg

    monkeypatch.setattr(jax_solver, "get_engine", jax_get_engine)
    monkeypatch.setattr(torch_solver, "_engine", torch_engine)
    op = _gate_operators()[kind]
    op_t = convert.dense(op, device="cpu") if kind == "dense" else convert.operator(op, device="cpu")
    engaged = 0
    for k in (4, 128):
        for dtype in ("float32", "float64"):
            for expansion in ("doubling", "lowest-k"):
                kw = dict(dtype=dtype, expansion=expansion, fused_gram=option)
                fdt.eigensolve(op, k, **kw)
                fdtt.eigensolve(op_t, k, **kw)
                want = bool(seen["jax"].fused_gram)
                assert seen["torch"].fused_gram == want, (k, dtype, expansion)
                assert seen["torch"].m_max == seen["jax"].m_max
                engaged += want
    # The grid reaches both outcomes where the operator is capable.
    capable = kind != "dense" and option != "off"
    assert (engaged > 0) == capable
    if kind == "banded" and option == "auto":
        assert engaged == 1  # only k=128, float32, lowest-k


# -- the incremental-H engine and the int8 solve against JAX ------------

KW = dict(method="DPR", tolerance=1e-4, relative_tolerance=True,
          dtype="float32", expansion="lowest-k", max_iterations=60)


def _assert_solve_parity(rj, rt):
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               np.asarray(rj.eigenvalues), rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["k4", "collapse"])
def test_fused_engine_matches_jax(monkeypatch, case):
    # The configurations of tests/test_fused_loop.py, forced "on"; the
    # collapse case at coupling 0.1, which needs enough iterations to
    # collapse (dims 6, 9, 6, 9).
    if case == "k4":
        op = jsparse.generate_banded_bsr(128, 16, bandwidth=1, seed=0,
                                         dtype=jnp.float32)
        k, extra = 4, {}
    else:
        op = jsparse.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1,
                                         seed=0, dtype=jnp.float32)
        k, extra = 3, dict(max_dim_sub=8, init_dim=6)
    rj = fdt.eigensolve(op, k, fused_gram="on", **KW, **extra)
    calls = []
    op_t = convert.operator(op, device="cpu")
    real = op_t.matmat_with_gram
    monkeypatch.setattr(op_t, "matmat_with_gram",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rt = fdtt.eigensolve(op_t, k, fused_gram="on", **KW, **extra)
    assert rt.converged and calls, "the fused engine did not run"
    _assert_solve_parity(rj, rt)
    if case == "collapse":
        dims = to_numpy(rt.subspace_dims)[:rt.iterations]
        assert np.any(np.diff(dims) < 0), f"no collapse in {dims}"
    off = fdtt.eigensolve(convert.operator(op, device="cpu"), k, fused_gram="off", **KW,
                          **extra)
    assert abs(off.iterations - rt.iterations) <= 2
    np.testing.assert_allclose(to_numpy(off.eigenvalues),
                               to_numpy(rt.eigenvalues), rtol=1e-5, atol=0)


def _true_residuals(op, X, lam):
    """||A x_j - λ_j x_j|| in float64 with the dense matrix."""
    dense = to_numpy(op.to_dense()).astype(np.float64)
    X = np.asarray(X, np.float64)
    return np.linalg.norm(dense @ X - X * lam, axis=0)


def test_auto_engine_at_k128_matches_jax(monkeypatch):
    # The gate's own case: float32, lowest-k, k=128, m_max=384 (a multiple
    # of 128). Coupling 3 needs two expansions and a collapse (dims 256,
    # ~377, 256, ~377), so the carried H is extended and re-seeded. The
    # two float32 trajectories part at roundoff of H (~eps·diag, 1e-4
    # here), so the eigenvalues are held to what the residuals certify:
    # each Ritz value lies within ||r_j|| of an eigenvalue, so two runs
    # agree within the sum of their true residuals.
    op = jsparse.generate_banded_bsr(16, 128, bandwidth=1, coupling=3.0,
                                     seed=0, dtype=jnp.float32)
    kw = dict(dtype="float32", expansion="lowest-k", tolerance=1e-3,
              relative_tolerance=True, max_dim_sub=256)
    rj = fdt.eigensolve(op, 128, **kw)
    op_t = convert.operator(op, device="cpu")
    calls = []
    real = op_t.matmat_with_gram
    monkeypatch.setattr(op_t, "matmat_with_gram",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rt = fdtt.eigensolve(op_t, 128, **kw)
    assert rt.converged and bool(rj.converged)
    assert len(calls) >= 2, "'auto' did not run the incremental-H engine"
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    dims = to_numpy(rt.subspace_dims)[:rt.iterations]
    assert np.any(np.diff(dims) < 0), f"no collapse in {dims}"
    lam_j = np.asarray(rj.eigenvalues, np.float64)
    lam_t = to_numpy(rt.eigenvalues).astype(np.float64)
    r_j = _true_residuals(op_t, rj.eigenvectors, lam_j)
    r_t = _true_residuals(op_t, to_numpy(rt.eigenvectors), lam_t)
    assert np.all(r_t <= 1e-3 * np.maximum(np.abs(lam_t), 1.0))
    assert np.all(np.abs(lam_t - lam_j) <= r_j + r_t)


def test_auto_engine_on_bf16_storage_matches_jax(monkeypatch):
    # The k128 solve on bf16 storage (the documented mixed-precision mode)
    # in both packages: "auto" takes the incremental-H engine there too,
    # and the port's matmat_with_gram runs kernel 3's bf16 entry (its plain
    # version on the CPU). The true residuals are taken in float64 with the
    # bf16 blocks, which are exact in float64.
    #
    # The tolerance, by the rule chip_smoke.py's phase 7c applies: the
    # port's "off" engine at the k128 test's relative 1e-3 stops with a
    # true relative residual above 1e-3 (bf16 storage rounds x to bf16 on
    # every apply, 2^-9, so the loop's residual is not the true one; the
    # JAX package's default operator stops there too, at 1.11e-3), so both
    # engines are compared at 1e-2: iterations within ±1 of JAX's, the
    # eigenvalues within the sum of the true residuals. At 1e-3 "auto" does
    # not converge: the fused bf16 gram rounds V and Y to bf16, as the TPU
    # kernel does, and the carried H stalls (ROADMAP Queue 3's open fault;
    # this test fails once that is repaired, to bring the entry up to date).
    op = jsparse.generate_banded_bsr(16, 128, bandwidth=1, coupling=3.0,
                                     seed=0, dtype=jnp.float32)
    kw = dict(dtype="float32", expansion="lowest-k", relative_tolerance=True,
              max_dim_sub=256)
    rj = fdt.eigensolve(op.astype(jnp.bfloat16), 128, tolerance=1e-2, **kw)
    op_t = convert.operator(op, device="cpu").astype(torch.bfloat16)
    assert op_t.dtype == torch.bfloat16
    exact = fdtt.BSROperator(op_t.block_cols, op_t.blocks.double(),
                             bandwidth=op_t.bandwidth)

    def true_rel(res):
        lam = to_numpy(res.eigenvalues).astype(np.float64)
        r = _true_residuals(exact, to_numpy(res.eigenvectors), lam)
        return np.max(r / np.maximum(np.abs(lam), 1.0))

    off3 = fdtt.eigensolve(op_t, 128, fused_gram="off", tolerance=1e-3, **kw)
    assert off3.converged and true_rel(off3) > 1e-3
    auto3 = fdtt.eigensolve(op_t, 128, fused_gram="auto", tolerance=1e-3,
                            max_iterations=30, **kw)
    assert not auto3.converged

    calls = []
    real = op_t.matmat_with_gram
    monkeypatch.setattr(op_t, "matmat_with_gram",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rt = fdtt.eigensolve(op_t, 128, tolerance=1e-2, **kw)
    assert rt.converged and bool(rj.converged)
    assert len(calls) >= 2, "'auto' did not run the incremental-H engine"
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    lam_j = np.asarray(rj.eigenvalues, np.float64)
    lam_t = to_numpy(rt.eigenvalues).astype(np.float64)
    r_j = _true_residuals(exact, rj.eigenvectors, lam_j)
    r_t = _true_residuals(exact, to_numpy(rt.eigenvectors), lam_t)
    assert np.all(r_t <= 1e-2 * np.maximum(np.abs(lam_t), 1.0))
    assert np.all(np.abs(lam_t - lam_j) <= r_j + r_t)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_int8_solve_matches_jax(fused):
    # tests/test_quantized.py's bf16-class solve, through both packages.
    q = jsparse.quantize_banded_int8(jsparse.generate_banded_bsr(
        32, 8, bandwidth=1, coupling=1e-3, dtype=jnp.float32))
    kw = dict(tolerance=1e-3, dtype="float32", relative_tolerance=True,
              max_iterations=100, fused_gram=fused)
    rj = fdt.eigensolve(q, 3, **kw)
    rt = fdtt.eigensolve(convert.operator(q, device="cpu"), 3, **kw)
    assert rt.converged
    _assert_solve_parity(rj, rt)
    dense = to_numpy(convert.operator(q, device="cpu").to_dense()).astype(np.float64)
    X = to_numpy(rt.eigenvectors).astype(np.float64)
    lam = to_numpy(rt.eigenvalues).astype(np.float64)
    res = np.linalg.norm(dense @ X - X * lam, axis=0)
    assert np.all(res <= 1e-3 * np.maximum(np.abs(lam), 1.0))


def test_float64_solve_on_int8_storage_matches_jax():
    # The default float64 solve on int8 storage: the apply sums the band
    # into float32 in both packages (the JAX fallback's
    # preferred_element_type=float32), so the solve runs at 1e-6, not
    # 1e-8. Iterations within ±1, eigenvalues within the tolerance.
    q = jsparse.quantize_banded_int8(jsparse.generate_banded_bsr(
        32, 8, bandwidth=1, coupling=1e-3, dtype=jnp.float32))
    rj = fdt.eigensolve(q, 3, tolerance=1e-6)
    qt = convert.operator(q, device="cpu")
    rt = fdtt.eigensolve(qt, 3, tolerance=1e-6)
    assert rt.converged and bool(rj.converged)
    assert rt.eigenvalues.dtype == torch.float64
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    np.testing.assert_allclose(to_numpy(rt.eigenvalues),
                               np.asarray(rj.eigenvalues), rtol=0, atol=1e-6)
    dense = to_numpy(qt.to_dense()).astype(np.float64)
    X = to_numpy(rt.eigenvectors)
    lam = to_numpy(rt.eigenvalues)
    assert np.all(np.linalg.norm(dense @ X - X * lam, axis=0) <= 1e-5)
