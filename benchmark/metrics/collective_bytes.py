"""``collective_bytes``: the bytes a solve of the collectives that the
program's ``parallel.scaling.record_collectives`` records on rank 0
(nothing to read on one rank)."""


def read(run):
    trace = run.traces[0] if run.traces else None
    if run.world < 2 or not trace or trace["collective_bytes"] is None:
        return None
    return trace["collective_bytes"] / trace["solves"]
