"""The port's examples (``fortran_davidson_tpu_torch/examples``) against
the JAX package's, each ``main(argv)`` in this process on the CPU.

``demo`` and ``benchmark_free`` run at the JAX package's test sizes
(``tests/test_components.py``) and must print its lines. ``northstar``
runs the matrix-free progressive recipe and the int8 banded one at a few
ten thousand rows through both packages' examples: both converge, and
their eigenvalues (high plus low words of the final polish) agree to
1e-8 relative.
"""

import re

import numpy as np
import pytest
import torch.distributed as dist

import fortran_davidson_tpu as fdt
from fortran_davidson_tpu.examples import northstar as jax_northstar
from fortran_davidson_tpu_torch.__main__ import main as cli_main
from fortran_davidson_tpu_torch.examples import (benchmark_free, demo,
                                                 northstar)
from tests.torch_parity import to_numpy

_NUM = r"[-+0-9.e]+"
# The JAX examples' lines (fortran_davidson_tpu/examples/demo.py and
# benchmark_free.py), numbers left open.
DEMO_LINES = [
    r"GJD algorithm converged in: \d+ iterations!",
    r"DPR algorithm converged in: \d+ iterations!",
    r"Test 1",
    r"Check that eigenvalues norm computed by different methods are the "
    r"same: True",
    r"Test 2",
    r"Check that eigenvalue equation:  H V = l S V  holds!",
    r"DPR method:",
    *(rf"eigenvalue {j}: {_NUM}  \|\|Error\|\|: {_NUM}" for j in (1, 2, 3)),
    r"GJD method:",
    *(rf"eigenvalue {j}: {_NUM}  \|\|Error\|\|: {_NUM}" for j in (1, 2, 3)),
]
BENCHMARK_LINES = [
    rf"cold solve \(incl\. compile\): {_NUM} s",
    rf"warm solve: {_NUM} s, \d+ iterations",
    r"eigenvalues: \['[0-9.]+', '[0-9.]+', '[0-9.]+'\]",
    *(rf"residual {j}: {_NUM}" for j in (1, 2, 3)),
]


def _assert_lines(out: str, patterns) -> None:
    lines = out.strip().splitlines()
    assert len(lines) == len(patterns), lines
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), (line, pattern)


@pytest.mark.parametrize("via_cli", [False, True])
def test_demo_prints_the_jax_lines(capsys, via_cli):
    argv = ["--dim", "60", "--tolerance", "1e-5", "--platform", "cpu"]
    rc = cli_main(["demo", *argv]) if via_cli else demo.main(argv)
    assert rc == 0
    _assert_lines(capsys.readouterr().out, DEMO_LINES)


@pytest.mark.parametrize("via_cli", [False, True])
def test_benchmark_free_prints_the_jax_lines(capsys, via_cli):
    argv = ["--dim", "200", "--platform", "cpu"]
    rc = (cli_main(["benchmark", *argv]) if via_cli
          else benchmark_free.main(argv))
    assert rc == 0
    _assert_lines(capsys.readouterr().out, BENCHMARK_LINES)


def _recording(monkeypatch, module, name):
    """Wrap ``module.name`` so that each call's result is kept."""
    results = []
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(module, name, wrapper)
    return results


def _full_eigenvalues(res) -> np.ndarray:
    """float64 hi + lo words of a final-polish result."""
    assert res.eigenvalues_lo is not None
    return (to_numpy(res.eigenvalues).astype(np.float64)
            + to_numpy(res.eigenvalues_lo).astype(np.float64))


NORTHSTAR_CASES = {
    "free": ["--n", "20000"],
    "banded-int8": ["--mode", "banded", "--quantize", "--n", "16384",
                    "--block-size", "16"],
}


@pytest.mark.parametrize("case", list(NORTHSTAR_CASES))
def test_northstar_progressive_matches_the_jax_example(monkeypatch, capsys,
                                                       case):
    argv = [*NORTHSTAR_CASES[case], "--lowest", "4", "--progressive",
            "--tolerance", "1e-8", "--expansion", "lowest-k"]
    # The JAX example imports eigensolve from the package when it runs.
    jax_runs = _recording(monkeypatch, fdt, "eigensolve")
    assert jax_northstar.main(argv) == 0
    torch_runs = _recording(monkeypatch, northstar, "run")
    assert northstar.main([*argv, "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("warm solve:") == 2
    # Cold and warm: the JAX example's last solve is its warm refined one.
    want, got = jax_runs[-1], torch_runs[-1]
    assert len(torch_runs) == 2 and bool(want.converged)
    assert got.converged and got.eigenvectors.device.type == "cpu"
    lam_j, lam_t = _full_eigenvalues(want), _full_eigenvalues(got)
    rel = np.abs(lam_t - lam_j) / np.maximum(np.abs(lam_j), 1.0)
    assert rel.max() <= 1e-8, rel


@pytest.fixture
def one_rank_group():
    """``--sharded`` starts a one-rank gloo group in this process; end it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_northstar_sharded_on_one_rank(capsys, one_rank_group):
    argv = ["--sharded", "--platform", "cpu", "--mode", "banded",
            "--quantize", "--n", "4096", "--block-size", "16", "--lowest",
            "4", "--tolerance", "1e-3", "--expansion", "lowest-k"]
    assert northstar.main(argv) == 0
    assert "mesh: {'rows': 1}" in capsys.readouterr().out
    # The sharded refined path: the loose stage's rank rows warm-start the
    # refined one, polished in the solve.
    assert northstar.main([*argv, "--progressive"]) == 0
    assert "converged=True" in capsys.readouterr().out


def _polished(out: str) -> tuple:
    """The polished eigenvalues and residuals that ``northstar`` prints."""
    vals = re.search(r"polished eigenvalues: \[(.*)\]", out).group(1)
    errs = re.search(r"polished residuals:\s+\[(.*)\]", out).group(1)
    return (np.array([float(v.strip(" '")) for v in vals.split(",")]),
            np.array([float(v.strip(" '")) for v in errs.split(",")]))


def test_northstar_free_sharded_polish_on_one_rank(capsys, one_rank_group):
    # The matrix-free surrogate through its per-rank callables and the
    # per-rank polish (polish_eigenpairs(mesh=...)): converged, polished
    # residuals under 1e-8, and the polished eigenvalues those of the
    # unsharded example to the 9 printed decimals' last unit (1e-9).
    argv = ["--platform", "cpu", "--mode", "free", "--n", "4096",
            "--lowest", "4", "--progressive", "--tolerance", "1e-8",
            "--expansion", "lowest-k", "--polish", "2"]
    assert northstar.main(argv) == 0
    lam, _ = _polished(capsys.readouterr().out)
    assert northstar.main(["--sharded", *argv]) == 0
    out = capsys.readouterr().out
    assert "mesh: {'rows': 1}" in out and "converged=True" in out
    lam_s, errs = _polished(out)
    assert np.all(errs <= 1e-8), errs
    np.testing.assert_allclose(lam_s, lam, rtol=0, atol=1e-9)
