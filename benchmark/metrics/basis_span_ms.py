"""``basis_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.basis_update`` spans (the writes of Q,
AQ and ``col_ok`` into the carried V and AV, and a collapse's rewrite of
them), the mean over ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.basis_update")
