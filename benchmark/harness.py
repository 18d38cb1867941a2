"""The harness: one cell of ``BENCHMARK.json``, run once.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``<configs[].file>`` (``configs/<config>.json``): the configuration's
  sizes; beside it ``configs/<config>.py``, which makes the inputs from
  the seed (``make_inputs``), hands them to the program
  (``build_operator``), counts an apply's bytes and operations
  (``apply_cost``) and holds the plain reference (``reference_apply``,
  ``reference_eigenvalues``);
- ``traffic/<traffic>.json``: the solves a window runs (lowest-k and the
  program's options);
- ``limits/<workload>.json``: the limit of each number ``correct``
  compares (``reference.CHECKS``);
- ``metrics/<metric>.py``: a reader, ``read(run) -> value or None``, of
  each end-to-end and per-layer metric.

A run: set-up (the inputs drawn on the card, the operator, one cold and
one warm solve), then a window of back-to-back complete solves for
``seconds`` (a closed loop with one caller; a solve that starts before
the deadline runs to its end), then, after the peak memory is read, one
apply of the timed operator object to a block drawn from the seed, and,
with the program's state dropped, the reference's check of what the
window's solves and that apply returned. A calibration
(``benchmark.calibrate``) is runs of one solve and no warm-up. On more
than one chip one process a rank: this process is rank 0 and spawns the
others; the ranks meet at a barrier before the window, and rank 0's
clock decides, after every solve, whether another starts (one
all-reduce of a flag, which also tells rank 0 that every rank has
returned the solve). Each rank reports the forbidden modules its
process loaded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Optional

from benchmark import reference, roofline, tracing
from benchmark.ranks import RankArgs, Ranks

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that may not be loaded in a run's processes.
FORBIDDEN = ("jax", "jaxlib", "flax", "fortran_davidson_tpu")
# How long rank 0 waits for the other ranks' results after its own.
RANK_JOIN_S = 300


def forbidden_modules(modules=None) -> list:
    """The names of ``FORBIDDEN`` among the top-level names (the part
    before the first dot, compared whole) of the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(f"no module file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module_name(kind: str, name: str) -> str:
    return f"benchmark_{kind}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    chips: int
    params: dict
    config: object
    traffic: dict
    limits: dict
    metrics: list          # [(spec entry, reader module, kind)]


def _merged(base: dict, extra: Optional[dict]) -> dict:
    out = dict(base)
    for key, value in (extra or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merged(out[key], value)
        else:
            out[key] = value
    return out


def find_cell(name: str, root=ROOT, overrides: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` and its files.
    ``overrides`` (tests at toy sizes) merges into the configuration's
    ``params``, the ``traffic`` and the ``limits``."""
    root = Path(root)
    overrides = overrides or {}
    spec = _json(root / "BENCHMARK.json")
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    conf_file = root / conf["file"]
    bench = conf_file.parent.parent
    params = _merged(_json(conf_file), overrides.get("params"))
    config = load_module(conf_file.with_suffix(".py"),
                         _module_name("config", conf["name"]))
    traffic = _merged(_json(bench / "traffic" / f"{work['traffic']}.json"),
                      overrides.get("traffic"))
    limits = _merged(_json(bench / "limits" / f"{name}.json"),
                     overrides.get("limits"))
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads",
                                                           [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    metrics = [(m, load_module(bench / "metrics" / f"{m['name']}.py",
                               _module_name("metric", m["name"])), kind)
               for kind, group in (("end_to_end", e2e), ("per_layer", layer))
               for m in group]
    return Cell(name=name, chips=int(work["chips"]), params=params,
                config=config, traffic=traffic, limits=limits,
                metrics=metrics)


class _Rank:
    """A rank's device, mesh and the reference's view of the ranks."""

    def __init__(self, args: RankArgs):
        import torch
        self.args = args
        # Set-up's stages: (name, seconds since the process started).
        self.start = (args.t_start if args.t_start is not None
                      else time.perf_counter())
        self.stages = []
        self.mark("imports")
        if args.device_type == "cuda":
            self.device = torch.device("cuda", args.rank)
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        self.mesh = None
        if args.world > 1:
            from fortran_davidson_tpu_torch.parallel import multihost
            self.mesh = multihost.initialize(
                init_method=args.init_method, world_size=args.world,
                rank=args.rank, device=self.device)
        self.comm = reference.Comm(args.rank, args.world)

    def mark(self, stage: str) -> None:
        self.stages.append((stage, time.perf_counter() - self.start))

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        self.sync()
        if self.mesh is not None:
            self.mesh.barrier()

    def peak_bytes(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_name(self) -> str:
        import torch
        if self.device.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(self.device)

    def close(self) -> None:
        import torch.distributed as dist
        if self.mesh is not None and dist.is_initialized():
            self.barrier()
            dist.destroy_process_group()


def make_solve(op, mesh, traffic: dict):
    """The window's call: the program's entry (``eigensolve`` on one
    chip, ``parallel.eigensolve_sharded`` on more) with the traffic's
    options."""
    import fortran_davidson_tpu_torch as fdtt
    opts = dict(traffic["options"])
    k = int(traffic["lowest"])
    if mesh is None:
        return lambda: fdtt.eigensolve(op, k, **opts)
    from fortran_davidson_tpu_torch.parallel import eigensolve_sharded
    return lambda: eigensolve_sharded(op, k, mesh, **opts)


def _hooked(solve, op, traffic: dict, hook: Optional[str]):
    if not hook:
        return solve
    module, fn = hook.split(":")
    return getattr(importlib.import_module(module), fn)(solve, op, traffic)


@contextlib.contextmanager
def _recorded_applies(op):
    """Every apply of ``op``'s class inside a ``tracing.APPLY_SPAN``
    span, its width recorded (the ``--trace 1`` run only)."""
    import torch
    cls = type(op)
    matmat = cls.matmat
    widths = []

    def recorded(self, block):
        widths.append(int(block.shape[1]))
        with torch.profiler.record_function(tracing.APPLY_SPAN):
            return matmat(self, block)

    cls.matmat = recorded
    try:
        yield widths
    finally:
        cls.matmat = matmat


@contextlib.contextmanager
def _recorded_collectives(mesh):
    if mesh is None:
        yield None
        return
    from fortran_davidson_tpu_torch.parallel.scaling import \
        record_collectives
    with record_collectives() as records:
        yield records


def _window(rk: _Rank, solve, seconds: float, sample: int) -> dict:
    """Back-to-back solves until ``seconds`` have passed; every solve's
    wall, eigenvalues, convergence and iterations, and the results of
    solve ``sample`` and of the last kept for the check."""
    import torch
    walls, evals, converged, iterations = [], [], [], []
    kept, last = None, None
    flag = (torch.zeros(1, device=rk.device) if rk.mesh is not None
            else None)
    t_open = time.perf_counter()
    deadline = t_open + seconds
    while True:
        t0 = time.perf_counter()
        res = solve()
        rk.sync()
        if flag is None:
            more = time.perf_counter() < deadline
        else:
            # Rank 0's clock decides; the sum also waits for every rank.
            # Plain torch.distributed: the program's collective inventory
            # (``collective_bytes``) records only the program's calls.
            flag.fill_(float(rk.args.rank == 0
                             and time.perf_counter() < deadline))
            rk.comm.all_reduce(flag)
            more = bool(flag.item() > 0)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        evals.append(res.eigenvalues.detach().cpu().double().numpy())
        converged.append(bool(res.converged))
        iterations.append(int(res.iterations))
        if len(walls) - 1 == sample:
            kept = res
        last = res
        if not more:
            break
    return {"t_open": t_open, "window_s": t1 - t_open, "walls": walls,
            "evals": evals, "converged": converged,
            "iterations": iterations,
            "samples": [r for r in (kept, last) if r is not None]}


def _probe(rk: _Rank, cell: Cell, op) -> tuple:
    """``(x, y)``: the timed operator object's apply ``y`` of a block
    ``x`` drawn from the seed over this rank's rows, as wide as the
    wanted pairs, in the type the window's solves hand it."""
    import torch
    x = reference.probe_block(
        rk.args.seed, rk.args.rank, int(op.diagonal().shape[0]),
        int(cell.traffic["lowest"]),
        getattr(torch, cell.traffic["options"]["dtype"]), rk.device)
    y = op.matmat(x)
    rk.sync()
    return x, y


def _check(rk: _Rank, cell: Cell, inputs: dict, evals: list,
           samples: list, probe: tuple) -> dict:
    """The reference's readings (every rank takes part; ``eig_gap`` is
    rank 0's)."""
    ref = None
    if rk.args.rank == 0:
        ref = cell.config.reference_eigenvalues(
            inputs, cell.params, int(cell.traffic["lowest"]))

    def apply(x, absolute=False):
        return cell.config.reference_apply(inputs, cell.params, x, rk.comm,
                                           absolute=absolute)

    pairs = [(res.eigenvalues, res.eigenvectors) for res in samples]
    return reference.readings(
        evals if ref is not None else [], ref, pairs, apply, rk.comm,
        probe=probe, apply_abs=lambda x: apply(x, absolute=True))


def _trace_numbers(rk: _Rank, cell: Cell, events, widths: list,
                   records, solves: int, iterations: int) -> dict:
    digest = tracing.digest(events)
    dtype = cell.params["dtype"]
    least = sum(roofline.least_seconds(
        *cell.config.apply_cost(cell.params, m, rk.args.world), dtype)
        for m in widths)
    digest.update(solves=solves, iterations=iterations,
                  applies=len(widths), apply_least_s=least,
                  collective_bytes=(None if records is None
                                    else sum(r.bytes for r in records)))
    return digest


def _window_rank(rk: _Rank, cell: Cell) -> dict:
    import torch
    args = rk.args
    rk.mark("mesh")
    inputs = cell.config.make_inputs(cell.params, args.seed, rk.device,
                                     args.rank, args.world)
    rk.sync()
    rk.mark("inputs")
    op = cell.config.build_operator(inputs, cell.params, rk.mesh,
                                    getattr(torch, cell.params["dtype"]))
    rk.mark("operator")
    solve = _hooked(make_solve(op, rk.mesh, cell.traffic), op, cell.traffic,
                    args.solve_hook)
    for i in range(args.warmup):
        solve()
        rk.sync()
        rk.mark("cold" if i == 0 else "warm")
    rk.barrier()
    rk.mark("barrier")
    sample = random.Random(f"sample:{args.seed}").randrange(
        int(cell.traffic.get("sample_first", 64)))
    trace = None
    if args.trace:
        with contextlib.ExitStack() as stack:
            widths = stack.enter_context(_recorded_applies(op))
            records = stack.enter_context(_recorded_collectives(rk.mesh))
            holder = stack.enter_context(tracing.traced_window(
                rk.barrier if rk.mesh is not None else None))
            win = _window(rk, solve, args.seconds, sample)
        trace = _trace_numbers(rk, cell, holder.pop("events"), widths,
                               records, len(win["walls"]),
                               sum(win["iterations"]))
    else:
        win = _window(rk, solve, args.seconds, sample)
    peak = rk.peak_bytes()
    samples = win.pop("samples")
    probe = _probe(rk, cell, op)
    del op, solve
    gc.collect()
    readings = _check(rk, cell, inputs, win["evals"], samples, probe)
    del samples, inputs, probe
    out = {"rank": args.rank, "peak_bytes": peak, "readings": readings,
           "device": rk.device_name(), "trace": trace, "stages": rk.stages,
           "solves": len(win["walls"]), "converged": sum(win["converged"]),
           "iterations": win["iterations"]}
    if args.rank == 0:
        out.update(walls=win["walls"], window_s=win["window_s"],
                   setup_s=(win["t_open"] - args.t_start
                            if args.t_start is not None else None))
    return out


def rank_main(args: RankArgs) -> dict:
    """One rank of a run, with the forbidden modules its process loaded
    (``forbidden``) once its window and check are done."""
    cell = find_cell(args.workload, args.root, args.overrides)
    rk = _Rank(args)
    out = _window_rank(rk, cell)
    # Only after a rank's success: a failed rank leaves without waiting
    # for the others, whom rank 0's process stops.
    rk.close()
    out["forbidden"] = forbidden_modules()
    return out


def forbidden_in(ranks: list) -> dict:
    """``{where: names}`` of the forbidden modules loaded in this process
    (``"this process"``) and in each rank's (``"rank <r>"``), where
    any."""
    found = {"this process": forbidden_modules()}
    found.update((f"rank {r['rank']}", r.get("forbidden", []))
                 for r in ranks)
    return {where: names for where, names in found.items() if names}


def run_ranks(args: RankArgs, others: Optional[Ranks] = None) -> list:
    """Every rank's result, in rank order: rank 0 in this process, the
    others spawned (``others``, where the caller started them already),
    stopped and waited for before this returns."""
    if args.world == 1:
        return [rank_main(args)]
    others = others or Ranks(args)
    try:
        if args.device_type == "cuda":
            # Built once, before any rank loads it: the others wait for
            # rank 0 in the process group's start.
            from fortran_davidson_tpu_torch.ops import kernels
            kernels.build()
        results = {0: rank_main(dataclasses.replace(
            args, init_method=others.args.init_method))}
        results.update(others.collect(RANK_JOIN_S))
        return [results[r] for r in range(args.world)]
    finally:
        others.stop()


@dataclasses.dataclass
class RunView:
    """What a metric reader reads: every rank's result of one run."""

    ranks: list
    world: int

    @property
    def lead(self) -> dict:
        return self.ranks[0]

    @property
    def traces(self) -> list:
        return [r["trace"] for r in self.ranks if r.get("trace")]


def assemble(cell: Cell, ranks: list, trace: bool) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the
    metrics of this kind of run, ``device``, the breakdown of a traced
    run, and last the checks, each number beside its limit."""
    lead = ranks[0]
    attempted = lead["solves"]
    failed = attempted - lead["converged"]
    correct, checks = reference.judge(lead["readings"], cell.limits, failed)
    view = RunView(ranks=ranks, world=len(ranks))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for entry, module, metric_kind in cell.metrics:
        if metric_kind != kind:
            continue
        value = module.read(view)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": lead["device"], "count": len(ranks),
              "memory_peak_bytes": max(r["peak_bytes"] for r in ranks)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if trace and view.traces:
        device["busy_s"] = (sum(t["busy_s"] for t in view.traces)
                            / len(view.traces))
        device["window_s"] = view.traces[0]["window_s"]
        out["breakdown"] = {"device_ops": view.traces[0]["device_ops"],
                            "idle_gaps": view.traces[0]["idle_gaps"]}
    out["checks"] = checks
    return out
