"""``peak_mem_gb``: the CUDA caching allocator's peak of allocated bytes
over set-up and the window (``torch.cuda.max_memory_allocated``, read
before the check), of the fullest rank, in 1e9 bytes."""


def read(run):
    peak = max(r["peak_bytes"] for r in run.ranks)
    return peak / 1e9 if peak else None
