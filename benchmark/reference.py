"""The comparison that decides ``correct``: what the timed solves returned,
held to a plain reference in float64.

Four numbers, each against a limit of its cell (``limits/<cell>.json``):

- ``eig_gap``: over every solve of the window and every wanted pair, the
  largest |lambda - lambda_ref| / max(|lambda_ref|, 1), lambda_ref the
  configuration's reference eigenvalues (worked out without any
  eigensolver of the program);
- ``residual``: over the sampled solves, the largest
  ‖A x_j - lambda_j x_j‖ / (max(|lambda_j|, 1) ‖x_j‖), A applied by the
  configuration's plain reference apply to every row the solve returned
  (on more than one chip every rank's rows, with its neighbours' edge
  rows);
- ``orthonormality``: over the sampled solves, the largest entry of
  |XᵀX - I|;
- ``apply_gap``: the timed operator object itself, once the window has
  closed, applied to a block drawn from the seed over every row of
  every rank (:func:`probe_block`): the largest |y - y_ref| / (|A| |x|)
  over every entry, y_ref = A x and |A| |x| by the reference apply.
  The lowest eigenvectors of these diagonal-dominant matrices fall to
  zero, or near it, past their first rows, so the solves' answers do
  not see the apply's further rows, another rank's rows or the
  exchange between ranks; this number reads all of them.

The residual and the eigenvalue gap together pin each returned pair to
the reference's: a pair within ``residual`` of an eigenpair whose
eigenvalue is the j-th lowest, in a spectrum whose wanted eigenvalues
lie apart by far more than either number. A solve that did not converge
counts as failed.

This module imports nothing of the program: it reads the program's
results only to judge them.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist

CHECKS = ("eig_gap", "residual", "orthonormality", "apply_gap")


class Comm:
    """The ranks of a run as the reference sees them: plain
    ``torch.distributed`` over the run's process group (nothing at one
    rank)."""

    def __init__(self, rank: int = 0, world: int = 1):
        self.rank, self.world = rank, world

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if self.world > 1:
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op])
        return t

    def neighbour_rows(self, x: torch.Tensor, halo: int):
        """``(prev, nxt)``: the last ``halo`` rows of the preceding rank's
        ``x`` and the first ``halo`` rows of the following rank's (None at
        the matrix's two ends), from one all-gather of every rank's two
        edges."""
        if self.world == 1:
            return None, None
        edges = torch.stack([x[:halo], x[-halo:]]).contiguous()
        every = torch.empty((self.world * 2, *edges.shape[1:]),
                            dtype=x.dtype, device=x.device)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(every, edges)
        every = every.view(self.world, *edges.shape)
        prev = every[self.rank - 1, 1] if self.rank > 0 else None
        nxt = every[self.rank + 1, 0] if self.rank < self.world - 1 else None
        return prev, nxt


def probe_block(seed: int, rank: int, rows: int, cols: int, dtype,
                device) -> torch.Tensor:
    """The block that :func:`apply_gap` applies: this rank's ``rows`` of
    ``cols`` standard normal columns, from a ``torch.Generator`` on
    ``device`` seeded by a hash of the seed and the rank."""
    digest = hashlib.sha256(f"probe:{seed}:{rank}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))
    return torch.randn((rows, cols), generator=gen, dtype=dtype,
                       device=device)


def apply_gap(x: torch.Tensor, y: torch.Tensor, apply, apply_abs,
              comm: Comm) -> float:
    """Largest |y - A x| / (|A| |x|) over every entry of every rank's
    rows: ``y`` the program's apply of ``x``, ``apply`` and
    ``apply_abs`` the reference's A @ and |A| @ on this rank's rows, in
    float64. An entry whose scale is zero reads infinite where y is not
    zero there."""
    x = x.to(torch.float64)
    diff = torch.abs(y.to(torch.float64) - apply(x))
    scale = apply_abs(torch.abs(x))
    gap = torch.where(scale > 0, diff / torch.where(scale > 0, scale, 1.0),
                      torch.where(diff > 0, float("inf"), 0.0))
    worst = torch.nan_to_num(torch.max(gap).reshape(1), nan=float("inf"))
    return float(comm.all_reduce(worst, op="max")[0])


def eig_gap(eigenvalues: list, ref: np.ndarray) -> float:
    """Largest relative gap of every solve's eigenvalues from ``ref`` (a
    solve that returned another number of them reads infinite)."""
    ref = np.asarray(ref, np.float64)
    scale = np.maximum(np.abs(ref), 1.0)
    gaps = [float(np.max(np.abs(ev - ref) / scale)) if ev.shape == ref.shape
            else float("inf")
            for ev in (np.asarray(e, np.float64) for e in eigenvalues)]
    return max(gaps)


def residual_and_orthonormality(apply, evals: torch.Tensor,
                                X: torch.Tensor, comm: Comm) -> tuple:
    """``(residual, orthonormality, rayleigh)`` of one solve's pairs:
    ``apply(X)`` the reference's A @ X on this rank's rows, every sum
    over rows taken over all ranks, in float64; ``rayleigh`` the
    reference's Rayleigh quotients of the returned vectors."""
    X = X.to(torch.float64)
    lam = evals.to(X.device, torch.float64)
    R = apply(X) - X * lam[None, :]
    sums = comm.all_reduce(torch.stack([torch.sum(R * R, dim=0),
                                        torch.sum(X * X, dim=0),
                                        torch.sum(X * R, dim=0)]))
    gram = comm.all_reduce(X.T @ X)
    res = torch.sqrt(sums[0] / sums[1]) / torch.clamp(torch.abs(lam), min=1.0)
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    return (float(torch.max(res)), float(torch.max(torch.abs(gram - eye))),
            (lam + sums[2] / sums[1]).cpu().numpy())


def readings(eigenvalues: list, ref: np.ndarray, samples: list, apply,
             comm: Comm, probe=None, apply_abs=None) -> dict:
    """The numbers of a run: ``eigenvalues`` every solve's (host
    arrays), ``samples`` the sampled solves' ``(evals, X)`` (this rank's
    rows), ``apply`` and ``apply_abs`` the reference's A @ and |A| @ of
    this rank's rows, ``probe`` the program's ``(x, A x)`` of
    :func:`apply_gap` on this rank's rows."""
    out = {"eig_gap": eig_gap(eigenvalues, ref) if eigenvalues else None,
           "residual": None, "orthonormality": None,
           "apply_gap": (None if probe is None
                         else apply_gap(*probe, apply, apply_abs, comm)),
           "rayleigh_gap": None}
    for evals, X in samples:
        res, orth, rayleigh = residual_and_orthonormality(apply, evals, X,
                                                          comm)
        out["residual"] = max(res, out["residual"] or 0.0)
        out["orthonormality"] = max(orth, out["orthonormality"] or 0.0)
        if ref is not None:
            # Not compared: where the returned eigenvalues stand off the
            # reference's, whether their own vectors' Rayleigh quotients
            # do too (PERF.md).
            out["rayleigh_gap"] = max(eig_gap([rayleigh], ref),
                                      out["rayleigh_gap"] or 0.0)
    return out


def judge(values: dict, limits: dict, failed: int) -> tuple:
    """``(correct, checks)``: each number beside its limit, in CHECKS'
    order, and whether every one is present and within it with no solve
    failed. A number that could not be read fails."""
    checks = {}
    ok = failed == 0
    for name in CHECKS:
        value, limit = values.get(name), float(limits[name])
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and np.isfinite(value) and value <= limit
    checks["failed_solves"] = {"value": failed, "limit": 0}
    return ok, checks
