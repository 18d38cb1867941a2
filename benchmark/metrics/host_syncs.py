"""``host_syncs``: the host's blocking waits on the device a solve inside
the program's ``fdt.solve`` spans (synchronize calls, synchronous copies
and copies into pageable host memory, each wait once), the mean over
ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.per_solve(run, lambda t: t["host_syncs"])
