"""``collective_wait_ms``: NCCL kernels' device milliseconds an
iteration, of the slowest rank (nothing to read on one rank)."""


def read(run):
    traces = run.traces
    if run.world < 2 or not traces:
        return None
    return max(1e3 * t["collective_s"] / max(t["iterations"], 1)
               for t in traces)
