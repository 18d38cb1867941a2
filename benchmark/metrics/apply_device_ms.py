"""``apply_device_ms``: device milliseconds a solve of the operations
launched inside the benchmark's apply spans, the mean over ranks."""


def read(run):
    traces = run.traces
    if not traces or not any(t["apply_s"] for t in traces):
        return None
    return 1e3 * sum(t["apply_s"] / t["solves"] for t in traces) / len(traces)
