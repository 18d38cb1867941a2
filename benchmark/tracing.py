"""The ``--trace 1`` run's reading of the device trace.

``torch.profiler`` (CUPTI) records the window; the benchmark marks it
with one span (``WINDOW_SPAN``) and every operator apply with another
(``APPLY_SPAN``), from its own code, around the program's calls. What
the digest reads, inside the window span:

- busy: the union of the device operations' intervals (kernels, copies,
  sets), as ``chip_smoke.py``'s ``_traced`` counts it; idle is the rest;
- apply: device operations launched inside an apply span (a kernel's
  launch is found by its link to the host operation that issued it),
  and the program's sparse products by name (``spmm``), whatever their
  link: a kernel launched through ``ctypes`` may link to no host
  operation, or to one outside the span (kernel 8p, four cards);
- collective: NCCL kernels;
- subspace: outside the apply, GEMMs and the dense solvers' kernels, by
  name (``SUBSPACE_NAMES``): the orthonormalization, the Rayleigh-Ritz
  products and the small eigenproblem;
- elementwise: every other device operation (the residual, the
  correction, norms, copies).

The split by name is the benchmark's until the program carries spans of
its own at those boundaries.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

APPLY_SPAN = "benchmark.apply"
WINDOW_SPAN = "benchmark.window"
SUBSPACE_NAMES = ("gemm", "gemv", "cutlass", "xmma", "syrk", "dot_kernel",
                  "syevd", "syevj", "sytrd", "stedc", "ormtr", "orgtr",
                  "potrf", "trsm", "trsv", "getrf", "geqrf", "orgqr",
                  "cusolver", "magma", "lansy", "steqr", "larfb")
TOP = 10
NAME_CHARS = 160


def classify(name: str, in_apply: bool) -> str:
    low = name.lower()
    if in_apply or "spmm" in low:
        return "apply"
    if "nccl" in low:
        return "collective"
    if any(key in low for key in SUBSPACE_NAMES):
        return "subspace"
    return "elementwise"


@contextlib.contextmanager
def traced_window(barrier=None):
    """Profile the ``with`` block, marked by ``WINDOW_SPAN``; yields a
    holder whose ``events`` are the kineto events once the block ends.
    The ranks of a mesh pass their ``barrier``, met once every rank's
    profiler runs and before the span, so that no rank's span starts
    waiting in a collective for another's profiler to start."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    holder = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if barrier is not None:
            barrier()
        with torch.profiler.record_function(WINDOW_SPAN):
            yield holder
    holder["events"] = list(prof.profiler.kineto_results.events())


def _cuda_api(event, name: str) -> bool:
    """Whether a host event is a CUDA runtime or driver call (by its
    activity type where the profiler gives one, else by its name)."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    return name.startswith("cuda") or (name.startswith("cu") and len(name) > 2
                                       and name[2].isupper())


def _innermost(starts: list, cpu: list, at: float, reach: int = 400) -> str:
    """The host operation running at ``at`` that began last (the
    innermost), or ``"host (no operation)"``."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(i - reach, -1), -1):
        s, f, name = cpu[j]
        if f >= at:
            return name[:NAME_CHARS]
    return "host (no operation)"


def digest(events) -> dict:
    """Seconds of the window by class (module docstring), busy and idle,
    and the breakdown's top device operations and idle gaps by what the
    host was doing."""
    from torch.autograd import DeviceType
    cpu, spans, windows, launched = [], [], [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        s, f = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if not _cuda_api(e, name):
            # A device operation links to the innermost operation or span
            # that was open when it was issued (CUDA API calls have ids of
            # their own, which are not kept here).
            launched[e.correlation_id()] = s
        if e.is_user_annotation():
            if name == APPLY_SPAN:
                spans.append((s, f))
            elif name == WINDOW_SPAN:
                windows.append((s, f))
            continue
        cpu.append((s, f, name))
    if not windows:
        return {}
    lo, hi = windows[0]
    spans.sort()
    span_starts = [s for s, _ in spans]

    def in_apply(link: int):
        at = launched.get(link)
        if at is None:
            return None
        i = bisect.bisect_right(span_starts, at) - 1
        return i >= 0 and at <= spans[i][1]

    by_class = defaultdict(float)
    by_name = defaultdict(float)
    intervals, unlinked = [], 0
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()):
            continue
        s, f = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if f <= lo or s >= hi:
            continue
        s, f = max(s, lo), min(f, hi)
        name = e.name()
        link = getattr(e, "linked_correlation_id", None)
        where = in_apply(link() if link is not None else 0)
        unlinked += where is None
        by_class[classify(name, where)] += f - s
        by_name[name[:NAME_CHARS]] += f - s
        intervals.append((s, f))
    intervals.sort()
    busy, end, gaps = 0.0, lo, []
    for s, f in intervals:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    if hi > end:
        gaps.append((end, hi))
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    idle_by = defaultdict(float)
    for g0, g1 in gaps:
        idle_by[_innermost(starts, cpu, 0.5 * (g0 + g1))] += g1 - g0
    return {
        "window_s": hi - lo, "busy_s": busy,
        "apply_s": by_class["apply"], "subspace_s": by_class["subspace"],
        "elementwise_s": by_class["elementwise"],
        "collective_s": by_class["collective"],
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle_by.items()),
                            key=lambda kv: -kv[1])[:TOP],
        "apply_spans": len(spans), "device_op_count": len(intervals),
        "unlinked_ops": unlinked,
    }
