"""``unattributed_span_ms``: device milliseconds a solve of the
operations the program launched inside ``fdt.solve`` but in none of its
phase spans, the mean over ranks (``benchmark/spans.py``): the device
time the phase metrics leave out."""

from benchmark import spans


def read(run):
    return spans.per_solve(run, lambda t: 1e3 * t["unattributed_s"])
