"""``solve_busy_ms``: milliseconds a solve in which the device ran an
operation launched inside the program's ``fdt.solve`` spans (the union
of their intervals), the mean over ranks (``benchmark/spans.py``): what
the phase metrics and ``unattributed_span_ms`` add up to where no two
operations of a solve overlap."""

from benchmark import spans


def read(run):
    return spans.per_solve(run, lambda t: 1e3 * t["solve_busy_s"])
