"""``solve_p90_s``: the 90th percentile of the walls of every solve of
the window (host clock, rank 0), inclusive quantiles of Python's
``statistics``."""

import statistics


def read(run):
    walls = run.lead["walls"]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[-1]
