"""``apply_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.apply`` spans (every operator apply:
the operations ``apply_device_ms`` times from the benchmark's own apply
spans), the mean over ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.apply")
