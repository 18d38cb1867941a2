"""The processes of a run on more than one card: this process is rank 0
and spawns ranks 1 .. world-1, one a GPU, which meet it over NCCL on
``tcp://127.0.0.1``.

Importing this module loads no torch, so that a run starts its other
ranks first and their imports overlap its own: a four-card run's set-up
otherwise pays the two one after the other.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import socket
import traceback
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class RankArgs:
    """What a rank process needs (picklable: spawned ranks rebuild the
    cell from the files)."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    rank: int = 0
    world: int = 1
    device_type: str = "cuda"
    init_method: Optional[str] = None
    t_start: Optional[float] = None
    root: str = str(ROOT)
    overrides: Optional[dict] = None
    # "module:function" wrapping the solve, ``fn(solve, op, traffic)``
    # (the tests' planted faults).
    solve_hook: Optional[str] = None
    # Solves before the window: the cold one, then warm ones.
    warmup: int = 2


def chips(workload: str, root=ROOT) -> int:
    """The cards ``workload`` asks for in ``root/BENCHMARK.json``."""
    with open(Path(root) / "BENCHMARK.json") as f:
        spec = json.load(f)
    for work in spec["workloads"]:
        if work["name"] == workload:
            return int(work["chips"])
    raise KeyError(f"no workload {workload!r} in {root}/BENCHMARK.json")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(args: RankArgs, queue) -> None:
    """A spawned rank: its result, or its traceback, on ``queue``."""
    from benchmark import harness
    from benchmark.run import process_start
    args = dataclasses.replace(args, t_start=process_start())
    try:
        queue.put((args.rank, harness.rank_main(args), None))
    except BaseException:
        queue.put((args.rank, None, traceback.format_exc()))
        raise


class Ranks:
    """Ranks 1 .. world-1 of a run, spawned at construction; ``args``
    carries the process group's address for rank 0."""

    def __init__(self, args: RankArgs):
        self.args = dataclasses.replace(
            args, init_method=f"tcp://127.0.0.1:{_free_port()}")
        ctx = multiprocessing.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_entry, args=(
            dataclasses.replace(self.args, rank=r), self.queue))
            for r in range(1, args.world)]
        for proc in self.procs:
            proc.start()

    def collect(self, timeout: float) -> dict:
        """Every spawned rank's result by rank, within ``timeout``
        seconds; a rank's failure raises with its traceback."""
        import time
        results = {}
        deadline = time.monotonic() + timeout
        while len(results) < len(self.procs):
            rank, result, error = self.queue.get(
                timeout=max(1.0, deadline - time.monotonic()))
            if error is not None:
                raise RuntimeError(f"rank {rank} failed:\n{error}")
            results[rank] = result
        for proc in self.procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
        return results

    def stop(self) -> None:
        """Stop every rank still running and wait for each to end."""
        for proc in self.procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.queue.close()
