"""Checkpoint / resume for long solves (counterpart of
``fortran_davidson_tpu/checkpoint.py``).

The loop state is explicit (``core.loop.init_state``), so a solve saved
every ``every`` iterations and restored continues exactly where it
stopped: the same iterates, the same iteration count, no operator applied
again. Every key the loop reads is saved and restored, none is derived
anew: the basis and its caches, the carried H of the fused engine, the
Chebyshev bound, GJD's inner count and warm-start block, the refined
path's plateau tracker, and the host values (``it``, ``m``, ``m_hi``,
``all_conv``, ``stalled``, ``no_prog``).

**Format** (a deliberate difference: the JAX package writes orbax
checkpoints, the port ``torch.save`` files; neither reads the other's).
``directory`` holds ``solver_config.json`` (the configuration's
fingerprint) and one folder ``step_<it>`` a save:

- ``rows_<start>-<stop>.pt``: the row-sharded keys (``V``, ``AV``,
  ``BV``, ``evecs``, ``corr_prev``) for global rows ``[start, stop)``, one
  file a rank (one file on one device);
- ``replicated.pt``: every other key, and the global row count, written
  once (by rank 0);
- ``complete``: the marker, written last.

A step is written under a temporary name (``.step_<it>.partial``) and
renamed to ``step_<it>`` once the marker is in, after a barrier of the
ranks: an interrupted save never becomes the :func:`latest_step`. The
ranks of a sharded solve must share ``directory``. A resume on another
world size reads, on each rank, the rows it now owns from the files that
overlap them (memory-mapped), so no rank holds all n rows of a tall
array. Files load with ``weights_only=True`` and ``map_location``: a
checkpoint saved on the card resumes on the CPU and the other way round.

**The width on resume** (a port-only rule). The default width is clamped
by the card's free memory at call time (``config._carry_budget_bytes``),
so a resume on a card with more or less free memory could resolve
another ``m_max`` from the same options. When ``max_dim_sub`` is left to
the default, the resume adopts the saved width if it fits today's budget
(as the JAX package adopts a saved ``carry_layout`` under ``"auto"``,
``fortran_davidson_tpu/checkpoint.py:183-202``); otherwise it raises the
fingerprint error with both widths. An explicit ``max_dim_sub`` that
differs raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Optional

import torch

from fortran_davidson_tpu_torch.config import (DavidsonOptions, DavidsonResult,
                                               merge_options,
                                               validate_initial_vectors,
                                               width_fits)
from fortran_davidson_tpu_torch.core.loop import run_chunked
from fortran_davidson_tpu_torch.core.rows import LOCAL, Rows
from fortran_davidson_tpu_torch.parallel.mesh import ROWS_AXIS
from fortran_davidson_tpu_torch.parallel.sharded import (
    SHARDED_STATE_KEYS, local_initial_vectors, prepare_sharded)
from fortran_davidson_tpu_torch.solver import prepare
from fortran_davidson_tpu_torch.utils.dtypes import canonical_dtype
from fortran_davidson_tpu_torch.utils.errors import (InvalidOptionsError,
                                                     OperatorError, require)

_STEP_RE = re.compile(r"^step_(\d+)$")
_ROWS_RE = re.compile(r"^rows_(\d+)-(\d+)\.pt$")
_CONFIG_FILE = "solver_config.json"
_REPLICATED = "replicated.pt"
_MARKER = "complete"


def _config_fingerprint(cfg, n: int) -> dict:
    fp = dataclasses.asdict(cfg)
    fp["n"] = int(n)
    return fp


def write_config_fingerprint(directory: str, cfg, n: int) -> None:
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    path = os.path.join(os.path.abspath(directory), _CONFIG_FILE)
    with open(path, "w") as f:
        json.dump(_config_fingerprint(cfg, n), f, indent=1, sort_keys=True)


def _saved_fingerprint(directory: str) -> Optional[dict]:
    path = os.path.join(os.path.abspath(directory), _CONFIG_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def check_config_fingerprint(directory: str, cfg, n: int) -> None:
    """Raise a clear ``InvalidOptionsError`` when resuming with another
    configuration: the saved shapes are bound to it (the history buffers
    to ``max_iterations``, the basis to the schedule's width), and a
    different tolerance would silently change what the solve means."""
    saved = _saved_fingerprint(directory)
    if saved is None:
        return
    now = _config_fingerprint(cfg, n)
    diffs = {key: (saved.get(key), now[key]) for key in now
             if saved.get(key) != now[key]}
    require(not diffs, InvalidOptionsError,
            "checkpoint was written with a different solver configuration; "
            "resume with the SAME options or point at a fresh directory. "
            f"Mismatched (saved, requested): {diffs}")


def _step_dirs(directory: str):
    """``(it, path)`` of every complete step, ascending."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        path = os.path.join(directory, name)
        if m and os.path.exists(os.path.join(path, _MARKER)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = _step_dirs(directory)
    return steps[-1][0] if steps else None


def _own_storage(t):
    """``t`` alone: ``torch.save`` writes a view's whole storage."""
    if isinstance(t, torch.Tensor) and (
            not t.is_contiguous()
            or t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def save_state(directory: str, state: dict, rows: Rows = LOCAL) -> str:
    """Write the loop state as ``step_<it>`` under ``directory``; every
    rank of a sharded solve calls it with its ``rows`` hook. Returns the
    step's path."""
    directory = os.path.abspath(directory)
    step = int(state["it"])
    final = os.path.join(directory, f"step_{step}")
    partial = os.path.join(directory, f".step_{step}.partial")
    start = rows.offset
    stop = start + state["V"].shape[0]
    n = rows.size * state["V"].shape[0]
    if rows.rank == 0:
        shutil.rmtree(partial, ignore_errors=True)
        os.makedirs(partial)
    rows.barrier()
    torch.save({key: _own_storage(state[key]) for key in SHARDED_STATE_KEYS
                if key in state},
               os.path.join(partial, f"rows_{start}-{stop}.pt"))
    rows.barrier()
    if rows.rank == 0:
        torch.save({"n": n, "state": {
            key: _own_storage(v) for key, v in state.items()
            if key not in SHARDED_STATE_KEYS}},
            os.path.join(partial, _REPLICATED))
        with open(os.path.join(partial, _MARKER), "w") as f:
            f.write(f"{rows.size}\n")
        if os.path.isdir(final):
            # A save of the same iteration (a resumed solve that was
            # complete): the old step stays whole until the new one is in.
            old = os.path.join(directory, f".step_{step}.old")
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            os.replace(partial, final)
            shutil.rmtree(old)
        else:
            os.replace(partial, final)
    rows.barrier()
    return final


def restore_state(directory: str, template: Optional[dict] = None,
                  step: Optional[int] = None, rows: Rows = LOCAL,
                  device=None) -> Optional[dict]:
    """Restore the latest (or given) ``step_*`` checkpoint; None if there
    is none.

    Each rank reads the replicated keys and its own rows of the row-sharded
    ones (``rows``), whatever world size wrote them. Tensors go to
    ``device`` (default: the CPU). ``template`` (for example a stepper's
    ``init(A, B)`` output) is optional: when given, the restored state must
    have its keys and its tensors' shapes and dtypes, and takes its
    tensors' devices.
    """
    steps = _step_dirs(directory)
    if not steps:
        return None
    if step is not None:
        match = [p for s, p in steps if s == step]
        require(match, OperatorError, f"no checkpoint step_{step} found")
        path = match[0]
    else:
        path = steps[-1][1]
    device = torch.device("cpu" if device is None else device)
    rep = torch.load(os.path.join(path, _REPLICATED), map_location=device,
                     weights_only=True)
    state = rep["state"]
    start = rows.offset
    stop = start + int(rep["n"]) // rows.size
    files = sorted((int(m.group(1)), int(m.group(2)), name)
                   for name in os.listdir(path)
                   if (m := _ROWS_RE.match(name)))
    pieces, covered = {}, start
    for a, b, name in files:
        if b <= start or a >= stop:
            continue
        require(a <= covered, OperatorError,
                f"{path}: rows [{covered}, {a}) are in no file")
        part = torch.load(os.path.join(path, name), map_location="cpu",
                          mmap=True, weights_only=True)
        for key, t in part.items():
            pieces.setdefault(key, []).append(
                t[max(a, covered) - a:min(b, stop) - a])
        covered = min(b, stop)
    require(covered == stop, OperatorError,
            f"{path}: rows [{covered}, {stop}) are in no file")
    for key, parts in pieces.items():
        state[key] = torch.cat(parts).to(device)
    if template is not None:
        require(set(state) == set(template), OperatorError,
                f"checkpoint keys {sorted(state)} are not the template's "
                f"{sorted(template)}")
        for key, want in template.items():
            if isinstance(want, torch.Tensor):
                got = state[key]
                require(got.shape == want.shape and got.dtype == want.dtype,
                        OperatorError,
                        f"checkpoint {key}: {tuple(got.shape)} {got.dtype}, "
                        f"template {tuple(want.shape)} {want.dtype}")
                state[key] = got.to(want.device)
    return state


def eigensolve_checkpointed(matrix, lowest: int, directory: str,
                            every: int = 10, second_matrix=None,
                            resume: bool = True, mesh=None,
                            options: Optional[DavidsonOptions] = None,
                            callbacks=(), initial_vectors=None, device=None,
                            **overrides) -> DavidsonResult:
    """Davidson solve that checkpoints every ``every`` iterations.

    Same contract as :func:`fortran_davidson_tpu_torch.eigensolve`. When
    ``resume`` and ``directory`` holds a complete ``step_*``, the solve
    continues from it instead of starting over (resume with the options
    that wrote it: the fingerprint check raises otherwise); with
    ``resume=False`` the directory's earlier steps are removed and the
    solve starts over. ``callbacks`` run after each save, with the state.
    ``initial_vectors`` are validated on every call and used only by a
    fresh solve: a restored state carries its basis.

    Numpy input is built on ``device``, by default the GPU (with none it
    raises ``DeviceUnavailableError``); tensors and operators stay on
    theirs unless ``device`` is given. With ``mesh`` (a ``RowMesh``; every
    rank calls this function), the solve runs row-sharded
    (:func:`~fortran_davidson_tpu_torch.parallel.eigensolve_sharded`'s
    set-up) on the mesh's device, and each rank saves and restores its
    rows.
    """
    opts = merge_options(options, overrides)
    dt = canonical_dtype(opts.dtype)
    if mesh is not None:
        require(device is None or torch.device(device) == mesh.device,
                OperatorError, f"device {device} is not the mesh's "
                f"{mesh.device}")

        def setup(o):
            return prepare_sharded(matrix, lowest, mesh, second_matrix,
                                   ROWS_AXIS, o)
        width_kw = dict(device=mesh.device, sharded=True,
                        shard_row_divisor=mesh.size)
    else:
        def setup(o):
            return (*prepare(matrix, lowest, second_matrix, o,
                             device=device), LOCAL)
        width_kw = {}
    A, B, cfg, rows = setup(opts)
    n = A.shape[0]
    if mesh is None:
        width_kw["device"] = A.device

    saved_step = latest_step(directory)
    if resume and saved_step is not None:
        saved = _saved_fingerprint(directory) or {}
        if (opts.max_dim_sub is None and isinstance(saved.get("max_dim"), int)
                and saved["max_dim"] != cfg.max_dim):
            # The default width was resolved from the free memory of its
            # day: adopt the saved one if it fits today's budget.
            A, B, adopted, rows = setup(dataclasses.replace(
                opts, max_dim_sub=saved["max_dim"]))
            require(width_fits(adopted, opts, n, **width_kw),
                    InvalidOptionsError,
                    "checkpoint was written with a different solver "
                    f"configuration: its width max_dim={saved['max_dim']} "
                    f"(m_max={saved.get('m_max')}) does not fit today's "
                    f"device-memory budget, which resolves max_dim="
                    f"{cfg.max_dim} (m_max={cfg.m_max}); free device memory "
                    "or point at a fresh directory")
            cfg = adopted
        check_config_fingerprint(directory, cfg, n)
    X0 = (local_initial_vectors(initial_vectors, n, cfg, mesh, dt)
          if mesh is not None
          else validate_initial_vectors(initial_vectors, n, cfg.init_dim, dt,
                                        device=A.device))
    state = None
    if resume and saved_step is not None:
        state = restore_state(directory, rows=rows, device=A.device)
        X0 = None
    rows.barrier()
    if rows.rank == 0:
        if not resume:
            for _, path in _step_dirs(directory):
                shutil.rmtree(path)
        write_config_fingerprint(directory, cfg, n)

    def save(st):
        save_state(directory, st, rows)

    return run_chunked(cfg, A, B, every=every, callbacks=(save, *callbacks),
                       state=state, rows=rows, X0=X0)
