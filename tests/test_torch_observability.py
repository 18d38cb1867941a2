"""The port's observability and debugging utilities
(``fortran_davidson_tpu_torch/utils/observability.py``,
``utils/debugging.py``): the analogues of
``tests/test_dense_davidson.py:165-179`` (the profiler trace) and of the
JAX package's logger and NaN switches.

The NaN trap is the loop's: a NaN operator raises ``FloatingPointError``
(what ``jax_debug_nans`` raises) naming the iteration, and a clean solve
under the trap keeps its bits. The convergence logger's records follow
the result's residual history, and its last record's iteration count is
the JAX package's logger's within ±1 on the same numpy matrix.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu_torch as fdtt
from fortran_davidson_tpu.config import DavidsonOptions as JOptions
from fortran_davidson_tpu.config import resolve_options as jresolve
from fortran_davidson_tpu.core.loop import run_chunked as jrun_chunked
from fortran_davidson_tpu.models.generators import generate_diagonal_dominant
from fortran_davidson_tpu.ops.operators import DenseOperator as JDense
from fortran_davidson_tpu.utils.observability import \
    ConvergenceLogger as JLogger
from fortran_davidson_tpu_torch import convert
from fortran_davidson_tpu_torch.config import DavidsonOptions, resolve_options
from fortran_davidson_tpu_torch.core.loop import run_chunked
from fortran_davidson_tpu_torch.utils import debugging
from fortran_davidson_tpu_torch.utils.debugging import (nan_trap,
                                                        strict_numerics)
from fortran_davidson_tpu_torch.utils.observability import (LOGGER,
                                                            ConvergenceLogger,
                                                            annotate,
                                                            profile_trace)
from tests import torch_dist_worker as worker


@pytest.fixture(scope="module")
def matrix():
    return np.asarray(generate_diagonal_dominant(40, 1e-3))


def test_profile_trace_writes_artifacts(matrix, tmp_path):
    A = convert.dense(matrix, device="cpu")
    with profile_trace(str(tmp_path)):
        with annotate("davidson-solve"):
            fdtt.eigensolve(A, 2, tolerance=1e-6).block_until_ready()
    found = [os.path.join(p, f) for p, _, files in os.walk(tmp_path)
             for f in files]
    assert len(found) == 1 and found[0].endswith(".json")
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "davidson-solve" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_convergence_logger_logs_each_chunk(matrix, caplog):
    A = convert.dense(matrix, device="cpu")
    log = ConvergenceLogger()
    assert log.logger is LOGGER and LOGGER.name == "fortran_davidson_tpu_torch"
    cfg = resolve_options(DavidsonOptions(tolerance=1e-8), 3, 40,
                          generalized=False, device="cpu")
    with caplog.at_level(logging.INFO, logger=LOGGER.name):
        res = run_chunked(cfg, A, None, every=1, callbacks=(log,))
    lines = [r.getMessage() for r in caplog.records
             if r.name == LOGGER.name]
    assert len(lines) == len(log.records) == res.iterations
    assert lines[-1].startswith(f"davidson it={res.iterations} ")
    assert lines[-1].endswith("conv=3/3")
    hist = res.residual_history.numpy()
    for rec in log.records:
        assert rec["max_residual"] == hist[rec["iteration"] - 1].max()
        assert rec["min_residual"] == hist[rec["iteration"] - 1].min()
    # The JAX package's logger on the same matrix.
    jlog = JLogger()
    jcfg = jresolve(JOptions(tolerance=1e-8), 3, 40, generalized=False)
    jres = jrun_chunked(jcfg, JDense(matrix), None, every=1,
                        callbacks=(jlog,))
    assert abs(len(jlog.records) - len(log.records)) <= 1
    assert abs(int(jres.iterations) - res.iterations) <= 1
    assert jlog.records[-1]["converged_pairs"] == 3


def _nan_operator(matrix):
    bad = matrix.copy()
    bad[5, 7] = bad[7, 5] = np.nan
    return convert.dense(bad, device="cpu")


def test_nan_trap_raises_on_a_nan_operator(matrix):
    with nan_trap():
        with pytest.raises(FloatingPointError, match="iteration 1"):
            fdtt.eigensolve(_nan_operator(matrix), 3)
    assert not debugging.nans_trapped()


def test_nan_trap_raises_on_a_nan_operator_refined(matrix):
    # The refined path: the NaN reaches the Ritz values and the true
    # residuals through the compensated Grams.
    with nan_trap():
        with pytest.raises(FloatingPointError, match="NaN"):
            fdtt.eigensolve(_nan_operator(matrix.astype(np.float32)), 3,
                            dtype="float32", refined=True)


def test_strict_numerics_is_global_and_keeps_clean_bits(matrix, monkeypatch):
    # The trap is a flag the loop reads; a clean solve under it has the
    # bits of one without it, the refined path's too.
    monkeypatch.setattr(debugging, "_TRAP", {"nans": False})
    A = convert.dense(matrix, device="cpu")
    A32 = convert.dense(matrix.astype(np.float32), device="cpu")
    refined = dict(dtype="float32", refined=True, final_polish=2,
                   tolerance=1e-7)
    plain = (fdtt.eigensolve(A, 3), fdtt.eigensolve(A32, 3, **refined))
    strict_numerics(enable_x64=False)
    assert debugging.nans_trapped()
    trapped = (fdtt.eigensolve(A, 3), fdtt.eigensolve(A32, 3, **refined))
    for a, b in zip(plain, trapped):
        assert a.iterations == b.iterations
        assert torch.equal(a.eigenvalues, b.eigenvalues)
        assert torch.equal(a.eigenvectors, b.eigenvectors)
    with pytest.raises(FloatingPointError):
        fdtt.eigensolve(_nan_operator(matrix), 3)


def test_jax_package_traps_the_same_operator(matrix):
    # The JAX package's switch on the same NaN matrix raises the same
    # exception type (jax_debug_nans: FloatingPointError).
    from fortran_davidson_tpu.utils.debugging import nan_trap as jtrap
    bad = matrix.copy()
    bad[5, 7] = bad[7, 5] = np.nan
    with jtrap():
        with pytest.raises(FloatingPointError):
            fdt.eigensolve(bad, 3).block_until_ready()


# The program's spans (``utils/observability.py``'s list).
PHASES = ("fdt.init", "fdt.apply", "fdt.rayleigh_ritz", "fdt.residual",
          "fdt.host_read", "fdt.correction", "fdt.orthonormalize",
          "fdt.basis_update")


def _traced(solve):
    """``(result, spans)``: ``solve()`` under a recording CPU profiler and
    its ``fdt.*`` spans as ``(start, end, name, parent)`` in start order,
    ``parent`` the innermost ``fdt.*`` span holding the span."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solve()
    found = sorted(((e.start_ns(), -e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().startswith("fdt.")))
    spans, stack = [], []
    for s, neg_f, name in found:
        while stack and stack[-1][1] <= s:
            stack.pop()
        spans.append((s, -neg_f, name, stack[-1][2] if stack else None))
        stack.append((s, -neg_f, name))
    return res, spans


@pytest.fixture(scope="module")
def collapsing():
    """A lowest-4 solve that expands and collapses (width 12): the
    options, and the operator."""
    A = convert.dense(np.asarray(generate_diagonal_dominant(120, 1e-1)),
                      device="cpu")
    return dict(max_dim_sub=12, tolerance=1e-9), A


def test_spans_nest_inside_the_solve(collapsing, matrix):
    opts, A = collapsing
    _, spans = _traced(lambda: fdtt.eigensolve(A, 4, **opts))
    names = [name for _, _, name, _ in spans]
    assert names[0] == "fdt.solve" and names.count("fdt.solve") == 1
    assert set(names) == {"fdt.solve", *PHASES}
    # Every phase inside the solve; the phases themselves nest only for
    # the applies (and the collapse's thin QR inside its basis rewrite).
    for _, _, name, parent in spans[1:]:
        assert parent is not None
        if parent != "fdt.solve":
            assert (name, parent) in {("fdt.apply", "fdt.init"),
                                      ("fdt.orthonormalize",
                                       "fdt.basis_update")}
    assert ("fdt.apply", "fdt.init") in {(n, p) for _, _, n, p in spans}
    # The new block's AQ: an apply right after each expansion's
    # orthonormalization, directly under the solve.
    for i, (_, _, name, parent) in enumerate(spans):
        if name == "fdt.orthonormalize" and parent == "fdt.solve":
            assert spans[i + 1][2:] == ("fdt.apply", "fdt.solve")
    # The refined path's polish, also inside the solve.
    A32 = convert.dense(matrix.astype(np.float32), device="cpu")
    _, spans = _traced(lambda: fdtt.eigensolve(
        A32, 3, dtype="float32", refined=True, final_polish=2,
        tolerance=1e-7))
    polish = [p for _, _, n, p in spans if n == "fdt.polish"]
    assert polish and set(polish) == {"fdt.solve"}


def test_span_counts_follow_the_iterations(collapsing):
    opts, A = collapsing
    res, spans = _traced(lambda: fdtt.eigensolve(A, 4, **opts))
    count = {name: sum(n == name for _, _, n, _ in spans) for name in PHASES}
    cfg = resolve_options(DavidsonOptions(**opts), 4, A.shape[0],
                          generalized=False, device="cpu")
    dims = res.subspace_dims.tolist()[:res.iterations]
    # Every pass but the converged last one expands or collapses.
    expansions = sum(m <= cfg.max_dim for m in dims[:-1])
    collapses = res.iterations - 1 - expansions
    assert res.converged and expansions > 0 and collapses > 0
    assert count["fdt.rayleigh_ritz"] == res.iterations
    assert count["fdt.residual"] == res.iterations
    # The iteration's read, and the result's counts at the end.
    assert count["fdt.host_read"] == res.iterations + 1
    assert count["fdt.correction"] == expansions
    assert count["fdt.orthonormalize"] == expansions + collapses
    assert count["fdt.basis_update"] == expansions + collapses
    # The init's apply and each expansion's.
    assert count["fdt.apply"] == 1 + expansions


def test_a_recorded_solve_keeps_its_bits(collapsing):
    opts, A = collapsing
    plain = fdtt.eigensolve(A, 4, **opts)
    traced, _ = _traced(lambda: fdtt.eigensolve(A, 4, **opts))
    assert traced.iterations == plain.iterations
    assert torch.equal(traced.eigenvalues, plain.eigenvalues)
    assert torch.equal(traced.eigenvectors, plain.eigenvectors)
    assert torch.equal(traced.residual_norms, plain.residual_norms)


def test_a_span_off_the_profiler_is_the_shared_no_op():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Dispatched(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled"), (
        "torch.autograd.profiler._is_profiler_enabled is gone: annotate "
        "now records every span, profiler or not")
    assert not torch.autograd.profiler._is_profiler_enabled
    assert annotate("fdt.solve") is annotate("fdt.apply")
    with Dispatched() as off:
        with annotate("fdt.solve"):
            pass
    assert off.ops == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        span = annotate("fdt.solve")
        with Dispatched() as on:
            with span:
                pass
    assert span is not annotate("fdt.apply")
    assert any("record_function" in op for op in on.ops)


def test_a_span_without_the_gates_flag_is_recorded(monkeypatch):
    from fortran_davidson_tpu_torch.utils import observability
    monkeypatch.setattr(observability, "_GATED", False)
    span = annotate("fdt.solve")
    assert isinstance(span, torch.profiler.record_function)
    with span:
        pass


def test_each_rank_of_a_sharded_solve_records_its_spans(tmp_path):
    ranks = worker.spawn_traced(2, str(tmp_path))
    for rank in ranks:
        names = rank["spans"]
        assert names[0] == "fdt.solve" and names.count("fdt.solve") == 1
        assert names.count("fdt.rayleigh_ritz") == rank["iterations"]
    assert ranks[0] == ranks[1]
