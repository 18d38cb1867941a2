"""``elementwise_device_ms``: device milliseconds a solve of every other
device operation outside the apply spans and NCCL (the residual, the
correction, norms, copies), the mean over ranks."""


def read(run):
    traces = run.traces
    if not traces or not any(t["elementwise_s"] for t in traces):
        return None
    return (1e3 * sum(t["elementwise_s"] / t["solves"] for t in traces)
            / len(traces))
