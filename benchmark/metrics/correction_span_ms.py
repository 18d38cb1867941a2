"""``correction_span_ms``: device milliseconds a solve of the operations
the program launched inside its ``fdt.correction`` spans (the DPR, Olsen
or GJD correction block, GJD's inner applies excepted), the mean over
ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.correction")
