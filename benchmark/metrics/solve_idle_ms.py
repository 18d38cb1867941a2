"""``solve_idle_ms``: milliseconds a solve inside the program's
``fdt.solve`` spans in which no operation ran on the device, the mean
over ranks (``benchmark/spans.py``): the idle the program can remove,
without the harness's gaps between solves."""

from benchmark import spans


def read(run):
    return spans.per_solve(run, lambda t: 1e3 * t["solve_idle_s"])
