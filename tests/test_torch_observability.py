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
