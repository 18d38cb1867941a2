"""``apply_roofline``: the least time of the window's counted applies
(each the larger of its bytes over HBM's 3.35 TB/s and its operations
over the type's peak, from the shapes: ``apply_cost`` of the cell's
configuration) over their device time, summed over ranks, in %."""


def read(run):
    traces = run.traces
    spent = sum(t["apply_s"] for t in traces)
    if not spent:
        return None
    return 100.0 * sum(t["apply_least_s"] for t in traces) / spent
