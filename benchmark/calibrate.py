"""The readings that the limits of ``correct`` are set from, a cell at
its own size: for each seed, a run of the cell's own path (the window
and its check) with no warm-up and a window of one solve.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \\
        [--control] [--out <file.json>]

Without ``--control`` the program runs as the cell states (the lower
readings); with it, the configuration and the solves in float32 (the
control: the program's own path in the nearest precision below the
configuration's float64), and the largest reading of the program or the
smallest of the control is printed last. The benchmark's runs do not
run this.
"""

import argparse
import json
import sys

from benchmark.run import set_cache_dirs

# The control: the configuration's type and the solves' in float32.
CONTROL = {"params": {"dtype": "float32"},
           "traffic": {"options": {"dtype": "float32"}}}


def readings(workload: str, seeds, control: bool = False, root=None,
             overrides=None, device_type: str = "cuda") -> tuple:
    """``(cell, rows)``: the cell as calibrated and, for each seed, the
    one solve's wall, iterations and convergence and the check's
    numbers."""
    from benchmark import harness
    from benchmark.ranks import ROOT, RankArgs
    root = root or ROOT
    over = harness._merged(overrides or {}, CONTROL if control else None)
    cell = harness.find_cell(workload, root, over)
    rows = []
    for seed in seeds:
        lead = harness.run_ranks(RankArgs(
            workload=workload, seed=seed, seconds=0.0, trace=False,
            world=cell.chips, device_type=device_type, root=str(root),
            overrides=over, warmup=0))[0]
        rows.append({"seed": seed, "wall_s": lead["walls"][0],
                     "iterations": lead["iterations"][0],
                     "converged": lead["converged"] == lead["solves"],
                     **lead["readings"]})
    return cell, rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    set_cache_dirs()
    from benchmark import reference
    seeds = tuple(int(s) for s in args.seeds.split(","))
    _, per_seed = readings(args.workload, seeds, args.control)
    for row in per_seed:
        print(json.dumps(row), flush=True)
    pick = min if args.control else max
    summary = {"workload": args.workload, "control": args.control,
               "seeds": list(seeds),
               **{name: pick(row[name] for row in per_seed)
                  for name in reference.CHECKS}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "per_seed": per_seed}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
