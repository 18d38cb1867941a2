"""Observability: convergence logging and profiler hooks (counterpart of
``fortran_davidson_tpu/utils/observability.py``).

- every solve returns machine-readable convergence telemetry
  (``DavidsonResult.residual_history`` / ``subspace_dims``);
- :class:`ConvergenceLogger` is a chunk callback for
  :func:`~fortran_davidson_tpu_torch.core.loop.run_chunked` and
  ``eigensolve_checkpointed`` that logs a residual summary a chunk;
- :func:`profile_trace` wraps ``torch.profiler`` so that a solve is
  captured, with the card's kernels when there is one, as a Chrome trace
  (``chrome://tracing``, Perfetto); :func:`annotate` names a span in it.

The solver marks its own phases with :func:`annotate`, so a trace of a
solve shows where each kernel, copy and host wait belongs. Each device
operation belongs to the innermost span open when the host launched it:

- ``fdt.solve``: one ``eigensolve`` or ``parallel.eigensolve_sharded``
  call, whole; every span below lies inside it;
- ``fdt.init``: the entry's option resolution (the carry-budget query)
  and the loop state's set-up (the operator's diagonal, the initial
  subspace with its argsort, the zeroed carried buffers; the first
  apply nests in it as ``fdt.apply``);
- ``fdt.apply``: one apply of the operator (or of B), wherever it runs;
  the applies of the initial basis, of a filter or of GJD's inner solve
  nest inside the phase that asked for them;
- ``fdt.rayleigh_ritz``: an iteration's projection H = VᵀAV (or the
  carried H) and the masked eigh;
- ``fdt.residual``: the Ritz vectors, AXW, R, its norms and the
  convergence test;
- ``fdt.host_read``: the loop's own device-to-host reads (an iteration's
  one read, ``settle``, the result's counts) and the bookkeeping of what
  they return;
- ``fdt.correction``: the DPR, Olsen or GJD correction block;
- ``fdt.orthonormalize``: CGS2 with CholQR2 or SVQB, and a collapse's
  thin QR;
- ``fdt.basis_update``: the writes of Q, AQ, BQ and ``col_ok`` into the
  carried buffers, and a collapse's rewrite of them;
- ``fdt.polish``: the refined path's trial and final polish.

A span costs two boolean checks while no profiler records (the
``_is_profiler_enabled`` flag that ``torch.profiler`` sets; a PyTorch
without that private flag records every span instead): then
:func:`annotate` hands out one shared no-op context and calls nothing
in PyTorch's dispatcher. It adds no synchronisation and no allocation,
and changes no value.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

LOGGER = logging.getLogger("fortran_davidson_tpu_torch")


class ConvergenceLogger:
    """Chunk callback: logs the iteration, the subspace width, the
    residual extrema and the converged pairs.

    Keeps a host-side list of the records (the result's
    ``residual_history`` is the authoritative record).
    """

    def __init__(self, logger: Optional[logging.Logger] = None,
                 level: int = logging.INFO):
        self.logger = logger or LOGGER
        self.level = level
        self.records = []

    def __call__(self, state: dict) -> None:
        it = int(state["it"])
        m = int(state["m"])
        errors = state["errors"].double().cpu()
        n_conv = int(torch.sum(state["has_conv"]))
        rec = dict(iteration=it, subspace_dim=m,
                   max_residual=float(errors.max()),
                   min_residual=float(errors.min()),
                   converged_pairs=n_conv)
        self.records.append(rec)
        self.logger.log(self.level,
                        "davidson it=%d dim=%d resid=[%.3e, %.3e] conv=%d/%d",
                        it, m, rec["min_residual"], rec["max_residual"],
                        n_conv, errors.shape[0])


@contextlib.contextmanager
def profile_trace(logdir: str, host_tracer_level: int = 2):
    """Profile the enclosed solve with ``torch.profiler`` (CPU activity,
    and CUDA activity when a card is present) and write a Chrome trace,
    ``trace_<time>_<pid>.json``, into ``logdir`` on exit. Yields
    ``logdir``, as the JAX package's does.

    ``host_tracer_level`` keeps the JAX package's levels: 3 also records
    the ops' input shapes and Python stacks; 1 and 2 record the ops.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    verbose = host_tracer_level >= 3
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=verbose,
                                with_stack=verbose) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


_NO_SPAN = contextlib.nullcontext()
# Whether this PyTorch has the flag the gate reads (a private one); where
# it has not, every span goes to ``record_function`` and no solve fails.
_GATED = hasattr(_autograd_profiler, "_is_profiler_enabled")


def annotate(name: str):
    """Named span on the profiler's timeline
    (``torch.profiler.record_function``) while a profiler records; the
    shared no-op context otherwise."""
    if _GATED and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)
