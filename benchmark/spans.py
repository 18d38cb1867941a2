"""The ``--trace 1`` run's reading of the program's own spans.

The port marks each solve and each phase of its Davidson loop with a
``torch.profiler.record_function`` span named ``fdt.<phase>``
(``fortran_davidson_tpu_torch/utils/observability.py`` lists them). The
spans sit in the same kineto trace as the CUPTI activity, so
:func:`digest` sets every device operation, idle gap and host wait of
the window against them:

- ``span_s``: seconds of device operations by the innermost ``fdt.*``
  span open at their launch, found through the CUDA runtime or driver
  call that shares the operation's correlation id (kernels launched
  through ``ctypes`` too), else through the host operation it links to;
  ``unattributed_s``: those launched inside ``fdt.solve`` but in no
  phase of it; ``solve_busy_s``: the union of both; ``span_ops``: the
  largest device operations by span and name, ``[span, name, seconds]``;
- ``solve_idle_s``: seconds inside ``fdt.solve`` spans in which no
  operation ran on the device, and ``idle_by_span``: that idle by the
  innermost span the host was in at each gap's midpoint (the harness's
  own gaps between solves are outside every solve span);
- ``host_syncs`` and ``syncs_by_span``: the host's blocking waits on
  the device inside ``fdt.solve``: stream, device or event synchronize
  calls, synchronous copies, and copies from the device into pageable
  host memory. A wait is counted once: a synchronize that follows
  another wait with no device work launched between them (PyTorch's
  read of a value is a copy and a stream synchronize) is the same wait;
- ``clock_skew_ops``: device operations that start before their launch
  call, which reads 0 while the device's timestamps and the host's
  agree, and ``clock_skew_max_s``, the most by which one does;
- ``solve_spans``: the ``fdt.solve`` spans in the window.

The attribution of device time rests on the host's clock alone (each
launch call's start against the spans). The idle's placement sets the
device's times against the host's spans, so it first moves the device's
times onto the host's clock, solve by solve (:func:`clock_shifts`): on
an H100 the device's timestamps were seen to wander against the host's
after ~20 s of tracing, from 6.4 ms ahead to 0.13 ms behind.

Only ``fdt.*`` spans inside the window span count. A program without
spans reads ``solve_spans`` 0, and the metrics that read these keys
report nothing.

The harness digests a trace with ``tracing.digest`` alone. Importing
this module extends that function with these keys (:func:`install`) and
leaves every key it had as it was; the readers of these keys import it,
and the harness loads every reader of a cell before its window. The
device's busy time and gaps are computed here again because the idle is
placed on the moved device times.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs a traced run of a cell, as ``benchmark.run --trace 1`` does, and
prints each rank's split by span (:func:`table`): device, idle and host
waits a solve, the check sums and the largest (span, operation).
"""

from __future__ import annotations

import argparse
import bisect
import functools
import sys
from collections import defaultdict

from benchmark import tracing

PREFIX = "fdt."
SOLVE_SPAN = "fdt.solve"
# CUDA runtime and driver calls that block the host until the device
# reaches them.
WAIT_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"))


def _pageable_copy_out(name: str) -> bool:
    """A device-to-host copy into pageable memory (kineto's name for it:
    ``Memcpy DtoH (Device -> Pageable)``), which the host waits for."""
    return "DtoH" in name and "Pageable" in name


class Timeline:
    """The innermost of properly nested spans at a time: the spans cut
    into segments, each labelled with the span open innermost on it."""

    def __init__(self, spans):
        self.bounds, self.labels = [], []
        stack = []
        for s, f, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][0] <= s:
                self._close(stack)
            stack.append((f, name))
            self.bounds.append(s)
            self.labels.append(name)
        while stack:
            self._close(stack)

    def _close(self, stack) -> None:
        end, _ = stack.pop()
        self.bounds.append(end)
        self.labels.append(stack[-1][1] if stack else None)

    def at(self, t: float):
        """The innermost span's name at ``t``, or ``None``."""
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.labels[i] if i >= 0 else None


def _busy_and_gaps(intervals, lo: float, hi: float) -> tuple:
    """``(busy, gaps)`` of intervals inside ``[lo, hi]``: the length of
    their union and the pieces of ``[lo, hi]`` they leave out."""
    busy, end, gaps = 0.0, lo, []
    for s, f in sorted(intervals):
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def clock_shifts(starts: list, launched) -> list:
    """The seconds to add to the device's times from each solve's start
    to the next's (the first solve's also before it): so much that the
    least lag there of an operation's start behind its launch call is 0.

    ``launched`` holds ``(call start, device start)`` pairs. A solve
    starts on an idle device (its caller waited for the last one), and
    each of the loop's host reads leaves the device idle again, so where
    the two clocks agree a solve's least lag is a launch's latency (3-5
    us on an H100); what it reads beyond that, or short of it, is the
    clocks' offset, which the shift takes out (with the latency).
    """
    if not starts:
        return []
    least = [None] * len(starts)
    for at, s in launched:
        i = max(bisect.bisect_right(starts, at) - 1, 0)
        if least[i] is None or s - at < least[i]:
            least[i] = s - at
    return [0.0 if lag is None else -lag for lag in least]


def digest(events) -> dict:
    """The keys of the module docstring, or ``{}`` without a window span."""
    from torch.autograd import DeviceType
    spans, window, calls, host_ops, device = [], None, {}, {}, []
    for e in events:
        name = e.name()
        s, f = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                link = getattr(e, "linked_correlation_id", None)
                device.append((s, f, name, e.correlation_id(),
                               link() if link is not None else 0))
        elif e.is_user_annotation():
            if name.startswith(PREFIX):
                spans.append((s, f, name))
            elif name == tracing.WINDOW_SPAN and window is None:
                window = (s, f)
        elif tracing._cuda_api(e, name):
            calls[e.correlation_id()] = (s, name)
        else:
            host_ops[e.correlation_id()] = s
    if window is None:
        return {}
    lo, hi = window
    spans = [x for x in spans if lo <= x[0] and x[1] <= hi]
    inner = Timeline(spans)
    solves = Timeline(x for x in spans if x[2] == SOLVE_SPAN)
    solve_spans = sorted((x0, x1) for x0, x1, name in spans
                         if name == SOLVE_SPAN)
    starts = [x0 for x0, _ in solve_spans]

    # (device start, end, name, launch time, whether through its call)
    ops, copies_out = [], set()
    for s, f, name, corr, link in device:
        call = calls.get(corr)
        if call is not None and _pageable_copy_out(name):
            copies_out.add(corr)
        if f <= lo or s >= hi:
            continue
        at = call[0] if call is not None else host_ops.get(link)
        ops.append((s, f, name, at, call is not None))
    skews = [at - s for s, _, _, at, by_call in ops if by_call and s < at]
    shifts = clock_shifts(starts, ((at, s) for s, _, _, at, by_call in ops
                                   if by_call))

    span_s = defaultdict(float)
    by_op = defaultdict(float)
    in_solve, every = [], []
    for s, f, name, at, _ in ops:
        if shifts:
            i = max(bisect.bisect_right(
                starts, s if at is None else at) - 1, 0)
            s, f = s + shifts[i], f + shifts[i]
        s, f = max(s, lo), min(f, hi)
        if f <= s:
            continue
        every.append((s, f))
        if at is None or solves.at(at) is None:
            continue
        span_s[inner.at(at)] += f - s
        by_op[inner.at(at), name[:tracing.NAME_CHARS]] += f - s
        in_solve.append((s, f))
    solve_busy, _ = _busy_and_gaps(in_solve, lo, hi)
    _, gaps = _busy_and_gaps(every, lo, hi)

    idle_by = defaultdict(float)
    ends = [x1 for _, x1 in solve_spans]
    for g0, g1 in gaps:
        i = bisect.bisect_right(ends, g0)
        while i < len(solve_spans) and solve_spans[i][0] < g1:
            a, b = max(g0, solve_spans[i][0]), min(g1, solve_spans[i][1])
            if b > a:
                # A midpoint that rounds onto the solve's end is the solve's.
                idle_by[inner.at(0.5 * (a + b)) or SOLVE_SPAN] += b - a
            i += 1

    # A blocking call that launches work of its own (a copy) starts a
    # wait; a synchronize starts one only after work launched since the
    # last wait.
    launches = {corr for _, _, _, corr, _ in device}
    syncs = defaultdict(int)
    launched = True
    for corr, (at, name) in sorted(calls.items(), key=lambda kv: kv[1][0]):
        if not lo <= at <= hi:
            continue
        if corr in copies_out or name in WAIT_CALLS:
            if launched or corr in launches:
                launched = False
                if solves.at(at) is not None:
                    syncs[inner.at(at)] += 1
        elif corr in launches:
            launched = True
    return {
        "span_s": {k: v for k, v in span_s.items() if k != SOLVE_SPAN},
        "unattributed_s": span_s.get(SOLVE_SPAN, 0.0),
        "solve_busy_s": solve_busy,
        "span_ops": [[span, name, v] for (span, name), v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:4 * tracing.TOP]],
        "solve_idle_s": sum(idle_by.values()),
        "idle_by_span": dict(idle_by),
        "host_syncs": sum(syncs.values()),
        "syncs_by_span": dict(syncs),
        "clock_skew_ops": len(skews),
        "clock_skew_max_s": max(skews, default=0.0),
        "solve_spans": len(solve_spans),
    }


def install() -> None:
    """Extend ``tracing.digest`` with :func:`digest`'s keys (once)."""
    base = tracing.digest
    if hasattr(base, "__wrapped__"):
        return

    @functools.wraps(base)
    def with_spans(events) -> dict:
        out = base(events)
        if out:
            out.update(digest(events))
        return out

    tracing.digest = with_spans


install()


def per_solve(run, value):
    """``value(trace)`` a solve, the mean over the ranks whose trace
    holds the program's solve spans; ``None`` where none does."""
    traces = [t for t in run.traces if t.get("solve_spans")]
    if not traces:
        return None
    return sum(value(t) / t["solve_spans"] for t in traces) / len(traces)


def span_ms(run, span: str):
    """Device milliseconds a solve launched inside ``span``."""
    return per_solve(run, lambda t: 1e3 * t["span_s"].get(span, 0.0))


def table(trace: dict) -> str:
    """One rank's digest as text: a solve's device ms, idle ms and host
    waits by span (``(no phase)``: inside ``fdt.solve``, in no phase of
    it), the check sums, the clocks, and the largest (span, operation)."""
    n = trace.get("solve_spans", 0)
    if not n:
        return "no fdt.solve span in the window"
    device = dict(trace["span_s"], **{SOLVE_SPAN: trace["unattributed_s"]})
    idle, waits = trace["idle_by_span"], trace["syncs_by_span"]
    names = sorted((set(device) | set(idle) | set(waits))
                   - {SOLVE_SPAN}) + [SOLVE_SPAN]
    lines = [f"{n} solves; a solve's ms and waits by the innermost span",
             f"{'span':<20}{'device_ms':>12}{'idle_ms':>12}{'waits':>9}"]
    for name in names:
        label = "(no phase)" if name == SOLVE_SPAN else name
        lines.append(f"{label:<20}{1e3 * device.get(name, 0.0) / n:>12.3f}"
                     f"{1e3 * idle.get(name, 0.0) / n:>12.3f}"
                     f"{waits.get(name, 0) / n:>9.2f}")
    spans_ms = 1e3 * sum(trace["span_s"].values()) / n
    lines += [
        f"busy in the solves {1e3 * trace['solve_busy_s'] / n:.3f} ms: "
        f"spans {spans_ms:.3f} + unattributed "
        f"{1e3 * trace['unattributed_s'] / n:.3f}; idle in the solves "
        f"{1e3 * trace['solve_idle_s'] / n:.3f} ms; waits "
        f"{trace['host_syncs'] / n:.2f}",
        f"clock: {trace['clock_skew_ops']} operations started before their "
        f"launch call, by at most {1e3 * trace['clock_skew_max_s']:.3f} ms "
        "(the idle is placed on the device's times moved onto the host's)",
        "largest (span, operation), ms a solve:"]
    lines += [f"  {span:<20}{1e3 * v / n:>10.3f}  {name}"
              for span, name, v in trace["span_ops"]]
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="A traced run of a cell, split by the program's spans.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    from benchmark import harness
    from benchmark.ranks import RankArgs, chips
    from benchmark.run import set_cache_dirs
    set_cache_dirs()
    ranks = harness.run_ranks(RankArgs(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=True, world=chips(args.workload)))
    for rank in ranks:
        print(f"rank {rank['rank']} ({args.workload}, seed {args.seed}):")
        print(table(rank["trace"] or {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
