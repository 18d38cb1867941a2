"""``solve_s``: the window's seconds over the converged solves completed
in it (host clock, rank 0; each solve ends with a synchronisation, and
on four chips with every rank's return)."""


def read(run):
    done = run.lead["converged"]
    return run.lead["window_s"] / done if done else None
