"""``clock_skew_ops``: device operations of the traced window that start
before their launch call on the host, the mean over ranks
(``benchmark/spans.py``). 0 while the device's timestamps and the
host's agree; where they do not, ``solve_idle_ms`` is placed on device
times moved onto the host's clock."""

from benchmark import spans


def read(run):
    traces = run.traces
    if not traces or "clock_skew_ops" not in traces[0]:
        return None
    return sum(t["clock_skew_ops"] for t in traces) / len(traces)
