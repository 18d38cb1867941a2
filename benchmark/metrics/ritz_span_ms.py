"""``ritz_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.rayleigh_ritz`` spans (the projection
H = VᵀAV and the masked eigh), the mean over ranks
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.rayleigh_ritz")
