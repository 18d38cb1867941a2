"""``residual_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.residual`` spans (the Ritz vectors X =
VW and AVW, the residual R, its norms and the convergence test), the
mean over ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.residual")
