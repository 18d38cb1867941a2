"""``setup_s``: from the start of the run's process to the window's
opening (host clock): imports, the kernels' load (their build on a
checkout's first run), the inputs drawn on the card, the operator, one
cold and one warm solve; on four chips also the ranks' spawn, NCCL's
start and the barrier."""


def read(run):
    return run.lead["setup_s"]
