"""One run of one cell of ``BENCHMARK.json`` on the GPUs of this machine.

    python3 -m benchmark.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout. Prints, as its last line on standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, the
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (and with ``--trace
1`` a ``breakdown``), and last ``checks``, each number the correctness
check compared beside its limit; the same numbers are the last lines of
standard error. Exits non-zero and prints no result without the GPUs
the cell needs, on any failure, or when a JAX module or the JAX package
was loaded in this process or in any rank's. Build and compile caches stay in fixed directories of the
checkout: the program's ``fortran_davidson_tpu_torch/_build/`` and
``.bench_cache/``.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".bench_cache"


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (from
    ``/proc/self/stat``, to its 10 ms ticks), or the time this module
    was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        since = (time.clock_gettime(time.CLOCK_BOOTTIME)
                 - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT
    if not 0.0 <= since < 600.0:
        return T_IMPORT
    return time.perf_counter() - since


def set_cache_dirs() -> None:
    """Every compile cache a run may write, at a fixed path of the
    checkout (inherited by spawned ranks)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"
    return "cards: " + "; ".join(line.strip() for line in out.splitlines())


def main(argv=None) -> int:
    start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_cache_dirs()
    from benchmark.ranks import RankArgs, Ranks, chips
    rank_args = RankArgs(workload=args.workload, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         world=chips(args.workload), t_start=start)
    # The other ranks start before this process imports torch.
    others = Ranks(rank_args) if rank_args.world > 1 else None
    try:
        import torch
        from benchmark import harness
        cell = harness.find_cell(args.workload)
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"{have} available", file=sys.stderr)
            return 2
        ranks = harness.run_ranks(rank_args, others)
    finally:
        if others is not None:
            others.stop()
    result = harness.assemble(cell, ranks, bool(args.trace))
    bad = harness.forbidden_in(ranks)
    if bad:
        print("forbidden modules loaded: " + "; ".join(
            f"{where}: {', '.join(names)}" for where, names in bad.items()),
            file=sys.stderr)
        return 3
    print(card_line(), file=sys.stderr)
    for rank in ranks:
        print(f"rank {rank['rank']} set-up stages (s from its start): "
              + ", ".join(f"{name} {at:.2f}" for name, at in rank["stages"]),
              file=sys.stderr)
        trace = rank.get("trace")
        if trace:
            print(f"rank {rank['rank']} trace: " + ", ".join(
                f"{key} {trace[key]!r}" for key in (
                    "solves", "applies", "apply_spans", "device_op_count",
                    "unlinked_ops", "window_s", "busy_s", "apply_s",
                    "subspace_s", "elementwise_s", "collective_s")),
                file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
