"""Runnable drivers (counterpart of ``fortran_davidson_tpu/examples``):
``demo`` and ``benchmark_free`` mirror the reference's two executables,
``northstar`` runs the 10M-row lowest-k workload. Each has a
``main(argv) -> int`` that ``python -m fortran_davidson_tpu_torch
{demo,benchmark,northstar}`` calls; each runs on the GPU unless given
``--platform cpu``."""
