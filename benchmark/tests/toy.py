"""Toy sizes of every cell, for the CPU tests: the cells' own code at a
size the CPU solves in seconds (a configuration's params and the traffic
overridden, nothing else); and a four-rank cell of config 5, added as
files to a copy of the benchmark, for the rank path."""

import json
import shutil
import time
from pathlib import Path

from benchmark import calibrate as calibration
from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BANDED = {"n_block_rows": 64, "block_size": 16}
OVERRIDES = {
    "cfg5-f64-k20": {"params": BANDED},
    "cfg5-f64-k3": {"params": BANDED},
    "cfg5x4-f64-k20": {"params": BANDED},
    "ci-surrogate-f64-k20": {"params": {"n": 2000}},
}
# The four-rank cell of :func:`four_rank_root`.
FOUR = "cfg5x4-f64-k20"
# The control's float32 solves run to max_iterations at these sizes.
CONTROL_TRAFFIC = {"traffic": {"options": {"max_iterations": 30}}}
SEED = 2**31 + 11


def four_rank_root(tmp: Path) -> Path:
    """A copy of the checkout's benchmark with one cell more, ``FOUR``:
    config 5 row-sharded over 4 ranks, its limits those of
    ``cfg5-f64-k20``, and the two row-sharding metrics (whose readers
    are files of the benchmark already)."""
    root = Path(tmp) / "checkout"
    if root.exists():
        return root
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": FOUR, "config": "cfg5-bsr-10m",
                              "traffic": "f64-k20", "chips": 4,
                              "why": "config 5 over four ranks"})
    spec["per_layer"] += [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": "row sharding", "moves": "solve_s", "workloads": [FOUR]}
        for name, unit, source in (("collective_wait_ms", "ms",
                                    "device_trace"),
                                   ("collective_bytes", "B",
                                    "program_counter"))]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(root / "benchmark/limits/cfg5-f64-k20.json",
                root / f"benchmark/limits/{FOUR}.json")
    return root


def ranks(workload: str, seconds: float = 0.5, trace: bool = False,
          seed: int = SEED, solve_hook=None, overrides=None,
          root=ROOT) -> tuple:
    """``(cell, ranks)``: one run of ``workload`` at its toy size on the
    CPU, every rank's result."""
    over = harness._merged(OVERRIDES[workload], overrides)
    cell = harness.find_cell(workload, root=root, overrides=over)
    return cell, harness.run_ranks(harness.RankArgs(
        workload=workload, seed=seed, seconds=seconds, trace=trace,
        world=cell.chips, device_type="cpu", t_start=time.perf_counter(),
        root=str(root), overrides=over, solve_hook=solve_hook))


def run(workload: str, seconds: float = 0.5, trace: bool = False,
        seed: int = SEED, solve_hook=None, overrides=None,
        root=ROOT) -> dict:
    """One run of ``workload`` at its toy size on the CPU, assembled as
    ``benchmark.run`` prints it."""
    cell, every = ranks(workload, seconds, trace, seed, solve_hook,
                        overrides, root)
    return harness.assemble(cell, every, trace)


def calibrate(workload: str, seeds, control: bool, root=ROOT) -> tuple:
    """``benchmark.calibrate``'s readings of ``workload`` at its toy
    size on the CPU."""
    over = harness._merged(OVERRIDES[workload],
                           CONTROL_TRAFFIC if control else None)
    return calibration.readings(workload, seeds, control, root=root,
                                overrides=over, device_type="cpu")
