"""Faults planted under a run's timed path (``RankArgs.solve_hook``):
each wraps the program's solve as ``fn(solve, op, traffic)``."""

from types import SimpleNamespace

import torch


def unchanged(solve, op, traffic):
    """Every step returns its state unchanged: the solve hands back its
    starting subspace (the unit vectors of the smallest diagonal
    entries, their diagonal entries as eigenvalues), marked converged."""
    k = int(traffic["lowest"])

    def run():
        d = op.diagonal()
        idx = torch.argsort(d)[:k]
        X = torch.zeros((d.shape[0], k), dtype=d.dtype, device=d.device)
        X[idx, torch.arange(k)] = 1.0
        return SimpleNamespace(eigenvalues=d[idx].clone(), eigenvectors=X,
                               converged=True, iterations=1)
    return run


def half_batch(solve, op, traffic):
    """Half of the batch left out: the lowest k/2 pairs solved, and
    returned twice in place of the k wanted."""
    import fortran_davidson_tpu_torch as fdtt
    k = int(traffic["lowest"])

    def run():
        res = fdtt.eigensolve(op, k // 2, **traffic["options"])
        again = torch.arange(k) % (k // 2)
        return SimpleNamespace(eigenvalues=res.eigenvalues[again],
                               eigenvectors=res.eigenvectors[:, again],
                               converged=res.converged,
                               iterations=res.iterations)
    return run


def altered(solve, op, traffic):
    """An answer altered where it is produced: one eigenvalue of every
    solve moved by a relative 1e-7."""
    k = int(traffic["lowest"])

    def run():
        res = solve()
        res.eigenvalues[k // 2] *= 1.0 + 1e-7
        return res
    return run


def far_rows(solve, op, traffic):
    """The apply's further rows left out: the timed operator object
    returns zeros in the second half of its rows, as a kernel that
    skipped its later block rows would. The solves' answers do not see
    it (their vectors vanish there); the check's own apply does."""
    matmat = op.matmat

    def apply(block):
        y = matmat(block)
        y[y.shape[0] // 2:] = 0
        return y
    op.matmat = apply
    return solve


def lost_halo(solve, op, traffic):
    """The exchange between chips left out: every rank's halos are zero
    rows, and nothing is sent."""
    def no_exchange(x, halo):
        zero = torch.zeros((halo, *x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        return zero, zero.clone(), []
    # The run's own mesh instance (a frozen dataclass) alone.
    object.__setattr__(op.mesh, "ring_exchange", no_exchange)
    return solve


def skipped_apply(solve, op, traffic):
    """A rank that skips its apply: every rank but rank 0 takes part in
    the exchange and returns zeros for its rows."""
    matmat = op.matmat

    def apply(block):
        y = matmat(block)
        return y if op.mesh.rank == 0 else torch.zeros_like(y)
    op.matmat = apply
    return solve


def foreign_module(solve, op, traffic):
    """Rank 2's process loads a module named ``flax``."""
    import sys
    from types import ModuleType
    if op.mesh.rank == 2:
        sys.modules.setdefault("flax", ModuleType("flax"))
    return solve
