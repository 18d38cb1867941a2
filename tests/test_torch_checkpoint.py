"""Checkpoint / resume and the chunked stepper of the port
(``fortran_davidson_tpu_torch/checkpoint.py``, ``core/loop.py``'s
``run_chunked``, ``get_stepper`` and the cache hooks), the analogues of
``tests/test_checkpoint.py``, ``tests/test_chunked_carry.py:132-150``,
``tests/test_warmstart.py:125-140`` and ``tests/test_cache_bound.py``.

The oracle is the port's own one-shot solve: a chunked, checkpointed,
interrupted and resumed solve gives its eigenvalues, residual history,
iterations and operator columns bit for bit. The same numpy inputs also
go through the JAX package, held to ``tests/test_parity.py``'s criteria
(eigenvalues within the tolerance, iterations within ±1). The sharded
checkpoints run in the gloo spawns of ``tests/test_torch_parallel.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.checkpoint import (eigensolve_checkpointed,
                                                   latest_step, restore_state,
                                                   save_state)
from fortran_davidson_tpu_torch.config import (DavidsonOptions,
                                               resolve_options)
from fortran_davidson_tpu_torch.core import loop as tloop
from fortran_davidson_tpu_torch.core.loop import get_stepper, run_chunked
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.utils.errors import InvalidOptionsError
from fortran_davidson_tpu_torch.utils.observability import ConvergenceLogger
from tests.torch_parity import assert_parity, to_numpy


class Crash(RuntimeError):
    """A callback's stand-in for the process dying."""


def crash_once():
    calls = []

    def callback(state):
        calls.append(state["it"])
        if len(calls) == 1:
            raise Crash
    return callback


def assert_same_solve(res, ref):
    """Bit for bit: eigenvalues, residual history, iterations, columns."""
    assert res.iterations == ref.iterations
    assert res.operator_columns == ref.operator_columns
    assert res.converged == ref.converged and res.stalled == ref.stalled
    assert torch.equal(res.eigenvalues, ref.eigenvalues)
    assert torch.equal(res.eigenvectors, ref.eigenvectors)
    assert torch.equal(res.residual_norms, ref.residual_norms)
    torch.testing.assert_close(res.residual_history, ref.residual_history,
                               rtol=0, atol=0, equal_nan=True)
    assert torch.equal(res.subspace_dims, ref.subspace_dims)


@pytest.fixture(scope="module")
def problem():
    """n=80, lowest-3 at 1e-8: the numpy matrix, the JAX package's solve
    and the port's one-shot solve."""
    A = np.asarray(generate_diagonal_dominant(80, 1e-3))
    jref = fdt.eigensolve(A, 3, tolerance=1e-8)
    jref.block_until_ready()
    At = convert.dense(A, device="cpu")
    return A, At, jref, fdtt.eigensolve(At, 3, tolerance=1e-8)


# -- the chunked driver -------------------------------------------------

@pytest.mark.parametrize("every", [1, 2, 5, 1000])
def test_chunked_driver_matches_one_shot(problem, every):
    A, At, jref, ref = problem
    cfg = resolve_options(DavidsonOptions(tolerance=1e-8), 3, 80,
                          generalized=False, device="cpu")
    res = run_chunked(cfg, At, None, every=every)
    assert_same_solve(res, ref)
    assert_parity(jref, res, A, 1e-8)


def test_convergence_logger_callback(problem):
    A, At, _, ref = problem
    cfg = resolve_options(DavidsonOptions(tolerance=1e-8), 3, 80,
                          generalized=False, device="cpu")
    log = ConvergenceLogger()
    res = run_chunked(cfg, At, None, every=1, callbacks=(log,))
    assert len(log.records) == res.iterations
    assert log.records[-1]["converged_pairs"] == 3
    hist = to_numpy(res.residual_history)
    for rec in log.records:
        row = hist[rec["iteration"] - 1]
        assert abs(rec["max_residual"] - row.max()) < 1e-14


def test_stepper_is_plain_functions(problem):
    # init then step to chunk_end: the state stops at the boundary, and
    # stepping on gives the one-shot solve.
    _, At, _, ref = problem
    cfg = resolve_options(DavidsonOptions(tolerance=1e-8), 3, 80,
                          generalized=False, device="cpu")
    init, step = get_stepper(cfg)
    st = init(At, None)
    assert st["it"] == 0 and st["chunk_end"] == cfg.max_iterations
    st["chunk_end"] = 1
    st = step(At, None, st)
    assert st["it"] == 1
    st["chunk_end"] = cfg.max_iterations
    res = tloop.pack_result(tloop.settle(step(At, None, st)))
    assert_same_solve(res, ref)


def test_every_must_be_positive(problem):
    _, At, _, _ = problem
    cfg = resolve_options(DavidsonOptions(), 3, 80, generalized=False,
                          device="cpu")
    with pytest.raises(ValueError, match="every"):
        run_chunked(cfg, At, None, every=0)


# -- checkpoint / resume ------------------------------------------------

def test_save_restore_roundtrip(problem, tmp_path):
    _, At, _, _ = problem
    cfg = resolve_options(DavidsonOptions(), 3, 80, generalized=False,
                          device="cpu")
    init, _ = get_stepper(cfg)
    st = init(At, None)
    path = save_state(tmp_path, st)
    assert latest_step(tmp_path) == 0
    assert sorted(os.listdir(path)) == ["complete", "replicated.pt",
                                        "rows_0-80.pt"]
    restored = restore_state(str(tmp_path), st)
    assert set(restored) == set(st)
    for key, want in st.items():
        got = restored[key]
        if isinstance(want, torch.Tensor):
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True, msg=key)
        else:
            assert got == want and type(got) is type(want), key


def test_checkpointed_solve_matches(problem, tmp_path):
    A, At, jref, ref = problem
    res = eigensolve_checkpointed(At, 3, str(tmp_path), every=2,
                                  tolerance=1e-8)
    assert_same_solve(res, ref)
    assert latest_step(tmp_path) == ref.iterations
    assert_parity(jref, res, A, 1e-8)


def test_resume_after_interrupt(problem, tmp_path):
    A, At, jref, ref = problem
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, 3, str(tmp_path), every=1,
                                tolerance=1e-8, callbacks=(crash_once(),))
    assert latest_step(tmp_path) == 1
    res = eigensolve_checkpointed(At, 3, str(tmp_path), every=1,
                                  tolerance=1e-8)
    assert_same_solve(res, ref)
    assert_parity(jref, res, A, 1e-8)


def test_interrupted_save_is_never_the_latest_step(problem, tmp_path,
                                                   monkeypatch):
    # torch.save dies while writing step 2: step 1 stays the latest, and a
    # resume from it ends bit for bit as the one-shot solve.
    _, At, _, ref = problem
    real = torch.save

    def dying(obj, f, *args, **kwargs):
        if os.path.basename(os.path.dirname(str(f))) == ".step_2.partial":
            raise Crash
        return real(obj, f, *args, **kwargs)
    monkeypatch.setattr(torch, "save", dying)
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, 3, str(tmp_path), every=1,
                                tolerance=1e-8)
    monkeypatch.setattr(torch, "save", real)
    assert latest_step(tmp_path) == 1
    res = eigensolve_checkpointed(At, 3, str(tmp_path), every=1,
                                  tolerance=1e-8)
    assert_same_solve(res, ref)


def test_mismatched_resume_raises_clearly(problem, tmp_path):
    _, At, _, _ = problem
    d = str(tmp_path / "ckpt_fp")
    eigensolve_checkpointed(At, 2, d, every=2, tolerance=1e-8,
                            max_iterations=40)
    with pytest.raises(InvalidOptionsError, match="different solver"):
        eigensolve_checkpointed(At, 2, d, every=2, tolerance=1e-8,
                                max_iterations=77)
    # An explicit width that is not the saved one raises too.
    with pytest.raises(InvalidOptionsError, match="max_dim"):
        eigensolve_checkpointed(At, 2, d, every=2, tolerance=1e-8,
                                max_iterations=40, max_dim_sub=12)
    res = eigensolve_checkpointed(At, 2, d, every=2, tolerance=1e-8,
                                  max_iterations=40)
    assert res.converged


def test_resume_false_starts_over(problem, tmp_path):
    _, At, _, ref = problem
    d = str(tmp_path)
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, 3, d, every=1, tolerance=1e-6,
                                callbacks=(crash_once(),))
    # Other options, resume=False: the old steps go, the solve starts over.
    res = eigensolve_checkpointed(At, 3, d, every=2, tolerance=1e-8,
                                  resume=False)
    assert_same_solve(res, ref)
    steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert steps == sorted(f"step_{i}" for i in
                           sorted({*range(2, ref.iterations, 2),
                                   ref.iterations}))


def _refined(**kw):
    return dict(dict(method="DPR", tolerance=1e-7, dtype="float32",
                     refined=True, final_polish=2, max_iterations=120), **kw)


def test_refined_resume_matches_uninterrupted(tmp_path):
    # The plateau tracker (best_err, no_prog) and the in-solve polish
    # survive the save; the JAX package's refined solve agrees.
    A = np.asarray(generate_diagonal_dominant(150, 1e-3), np.float32)
    At = convert.dense(A, device="cpu")
    ref = fdtt.eigensolve(At, 3, **_refined())
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, 3, str(tmp_path), every=2,
                                callbacks=(crash_once(),), **_refined())
    assert latest_step(tmp_path) >= 1
    res = eigensolve_checkpointed(At, 3, str(tmp_path), every=2,
                                  **_refined())
    assert res.converged
    assert_same_solve(res, ref)
    assert torch.equal(res.eigenvalues_lo, ref.eigenvalues_lo)
    assert float(torch.max(res.residual_norms)) < 1e-7
    jref = fdt.eigensolve(A, 3, **_refined())
    assert abs(res.iterations - int(jref.iterations)) <= 1
    assert bool(jref.converged)
    np.testing.assert_allclose(to_numpy(res.eigenvalues),
                               np.asarray(jref.eigenvalues), rtol=0,
                               atol=1e-6)


def test_chunked_carry_checkpoint_resume(tmp_path):
    # tests/test_chunked_carry.py:132-150: "chunked" resolves to the flat
    # carries; the state round-trips and resumes bit for bit.
    op = tgen.surrogate_hamiltonian(1536, dtype=torch.float32, device="cpu")
    kw = dict(method="DPR", tolerance=1e-6, dtype="float32", refined=True,
              carry_layout="chunked", expansion="lowest-k", max_iterations=40)
    full = eigensolve_checkpointed(op, 2, str(tmp_path / "a"), every=50,
                                   **kw)

    def interrupt(state):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        eigensolve_checkpointed(op, 2, str(tmp_path / "b"), every=1,
                                callbacks=(interrupt,), **kw)
    resumed = eigensolve_checkpointed(op, 2, str(tmp_path / "b"), every=50,
                                      **kw)
    assert_same_solve(resumed, full)


@pytest.fixture(scope="module")
def hard_problem():
    # tests/test_warmstart.py's: weakly dominant, a cold start needs many
    # iterations.
    A = np.asarray(generate_diagonal_dominant(300, 1.0,
                                              key=jax.random.PRNGKey(5)))
    At = convert.dense(A, device="cpu")
    cold = fdtt.eigensolve(At, 4, tolerance=1e-8, max_iterations=400)
    assert cold.converged
    return A, At, cold


def test_checkpointed_fresh_solve_warm_starts(hard_problem, tmp_path):
    A, At, cold = hard_problem
    res = eigensolve_checkpointed(At, 4, str(tmp_path), every=5,
                                  tolerance=1e-8, max_iterations=400,
                                  initial_vectors=cold.eigenvectors)
    assert res.converged and res.iterations <= 2
    np.testing.assert_allclose(to_numpy(res.eigenvalues),
                               to_numpy(cold.eigenvalues), rtol=0,
                               atol=1e-10)
    # Validated on a resume too, and unused there: the restored state
    # carries its basis.
    with pytest.raises(fdtt.OperatorError, match="initial_vectors"):
        eigensolve_checkpointed(At, 4, str(tmp_path), every=5,
                                tolerance=1e-8, max_iterations=400,
                                initial_vectors=np.ones((299, 2)))
    again = eigensolve_checkpointed(At, 4, str(tmp_path), every=5,
                                    tolerance=1e-8, max_iterations=400,
                                    initial_vectors=np.ones((300, 2)))
    assert_same_solve(again, res)


# -- the width on resume -------------------------------------------------

WIDTH_N, WIDTH_K = 2000, 4
# A budget that clamps the default width 40 (m_max 64) to 28 (m_max 32):
# 8 bytes x 2000 rows x (4 x 32 + 32) columns = 2.56 MB fits, 4.6 MB not.
SMALL_BUDGET = "3e6"


@pytest.fixture(scope="module")
def width_problem():
    rng = np.random.default_rng(11)
    off = 1e-3 * rng.standard_normal((WIDTH_N, WIDTH_N))
    A = np.diag(np.arange(1.0, WIDTH_N + 1.0)) + off + off.T
    return convert.dense(A, device="cpu")


def test_resume_adopts_the_saved_default_width(width_problem, tmp_path,
                                               monkeypatch):
    # Written where the budget clamps the default width, resumed where it
    # does not: the saved width fits, so the resume adopts it and ends
    # bit for bit as the uninterrupted solve under the small budget.
    At = width_problem
    monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", SMALL_BUDGET)
    ref = fdtt.eigensolve(At, WIDTH_K, tolerance=1e-8)
    cfg = resolve_options(DavidsonOptions(), WIDTH_K, WIDTH_N, False,
                          device="cpu")
    assert (cfg.max_dim, cfg.m_max) == (28, 32)
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, WIDTH_K, str(tmp_path), every=1,
                                tolerance=1e-8, callbacks=(crash_once(),))
    monkeypatch.delenv("FDT_CARRY_BUDGET_BYTES")
    wide = resolve_options(DavidsonOptions(), WIDTH_K, WIDTH_N, False,
                           device="cpu")
    assert (wide.max_dim, wide.m_max) == (40, 64)
    res = eigensolve_checkpointed(At, WIDTH_K, str(tmp_path), every=1,
                                  tolerance=1e-8)
    assert_same_solve(res, ref)


def test_resume_refuses_a_saved_width_that_does_not_fit(width_problem,
                                                        tmp_path,
                                                        monkeypatch):
    At = width_problem
    with pytest.raises(Crash):
        eigensolve_checkpointed(At, WIDTH_K, str(tmp_path), every=1,
                                tolerance=1e-8, callbacks=(crash_once(),))
    monkeypatch.setenv("FDT_CARRY_BUDGET_BYTES", SMALL_BUDGET)
    with pytest.raises(InvalidOptionsError,
                       match=r"max_dim=40 \(m_max=64\) does not fit.*"
                       r"max_dim=28 \(m_max=32\)"):
        eigensolve_checkpointed(At, WIDTH_K, str(tmp_path), every=1,
                                tolerance=1e-8)


# -- every=1 over the loop's whole state ----------------------------------

def _torture_cases():
    A = np.asarray(generate_diagonal_dominant(
        120, 0.3, key=jax.random.PRNGKey(3)))
    X0 = np.random.default_rng(5).standard_normal((120, 2))
    return {
        # Collapses, Chebyshev-filtered restarts, locking and GJD with its
        # recycled correction block, from a warm start.
        "gjd_filtered_locked": (A, 3, X0, dict(
            method="GJD", gjd_warm_start=True, gjd_preconditioner="dpr",
            cheb_degree="auto", locking=True, expansion="lowest-k",
            max_dim_sub=9, init_dim=6, tolerance=1e-9)),
        # The refined path with doubling collapses, the plateau tracker and
        # the in-solve polish, in float32; at 1e-7 it ends at its plateau
        # (a stall exit), at 1e-6 converged.
        "refined_collapsing": (A.astype(np.float32), 3, None, dict(
            dtype="float32", refined=True, final_polish=2, max_dim_sub=12,
            init_dim=6, tolerance=1e-6)),
        "refined_plateau": (A.astype(np.float32), 3, None, dict(
            dtype="float32", refined=True, final_polish=2, max_dim_sub=12,
            init_dim=6, tolerance=1e-7)),
        # The incremental-H engine carries H in the state.
        "fused": (A.astype(np.float32), 3, None, dict(
            dtype="float32", expansion="lowest-k", fused_gram="on",
            max_dim_sub=9, tolerance=1e-5)),
    }


@pytest.mark.parametrize("name", list(_torture_cases()))
def test_every_iteration_interrupted_and_resumed(tmp_path, name):
    # Saved after every iteration, and interrupted after every save of an
    # unfinished state: each resume runs one iteration from disk. The end
    # is the one-shot solve, bit for bit, with its operator columns:
    # nothing is re-applied.
    A, k, X0, opts = _torture_cases()[name]
    At = convert.dense(A, device="cpu")
    X0 = None if X0 is None else torch.from_numpy(X0).to(At.dtype)
    ref = fdtt.eigensolve(At, k, initial_vectors=X0, **opts)
    assert ref.iterations >= 4 and (ref.converged or ref.stalled)

    def crash_unless_done(state):
        if not (state["all_conv"] or state["stalled"]):
            raise Crash

    for resumes in range(ref.iterations):
        try:
            res = eigensolve_checkpointed(At, k, str(tmp_path), every=1,
                                          initial_vectors=X0,
                                          callbacks=(crash_unless_done,),
                                          **opts)
            break
        except Crash:
            assert latest_step(tmp_path) == resumes + 1
    assert resumes == ref.iterations - 1
    assert_same_solve(res, ref)
    if ref.inner_iterations is not None:
        assert res.inner_iterations == ref.inner_iterations


# -- the compiled-cache hooks ---------------------------------------------

def test_capacity_validation_and_clear_are_no_ops(problem):
    # The port compiles nothing: the hooks keep user code working, the
    # capacity is validated as in the JAX package, and solves are unchanged.
    _, At, _, ref = problem
    with pytest.raises(ValueError):
        fdtt.set_compiled_cache_capacity(0)
    fdtt.set_compiled_cache_capacity(1)
    fdtt.clear_compiled_caches()
    assert_same_solve(fdtt.eigensolve(At, 3, tolerance=1e-8), ref)
    for name in ("eigensolve_checkpointed", "clear_compiled_caches",
                 "set_compiled_cache_capacity"):
        assert name in fdtt.__all__
    assert set(fdt.__all__) <= set(fdtt.__all__)
