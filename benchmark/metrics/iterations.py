"""``iterations``: the Davidson iterations of a solve, the mean over the
window's solves (``DavidsonResult.iterations``, a count the program
makes)."""


def read(run):
    its = run.lead["iterations"]
    return sum(its) / len(its) if its else None
