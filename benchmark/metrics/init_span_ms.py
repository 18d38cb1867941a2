"""``init_span_ms``: device milliseconds a solve of the operations the
program launched inside its ``fdt.init`` spans (the entry's options and
the loop state's set-up: the diagonal, the initial subspace and its
argsort, the zeroed carried buffers; not the first apply, which is
``fdt.apply``'s), the mean over ranks (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fdt.init")
