"""``device_idle_share``: the share of the traced window in which no
operation ran on the device, the mean over ranks, in %."""


def read(run):
    traces = [t for t in run.traces if t["window_s"] > 0]
    if not traces:
        return None
    return 100.0 * sum(1.0 - t["busy_s"] / t["window_s"]
                       for t in traces) / len(traces)
