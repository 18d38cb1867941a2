"""``ortho_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.orthonormalize`` spans (CGS2 and
CholQR2 of the correction block against the basis), the mean over ranks
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.orthonormalize")
