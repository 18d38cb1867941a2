"""Matrix-free benchmark — the reference's ``benchmark_free`` executable.

Mirrors ``src/benchmark_free.f90:80-112``: dim-1000 generalized
matrix-free problem, lowest-3, DPR, tol 1e-8, max subspace 20; verifies
the residual norms afterwards. Unlike the reference (which has no timing
code — "benchmark" by external ``time``), this prints the wall clock of
the first solve (on the GPU it pays the allocator's growth and the
solver libraries' handles; the line keeps the JAX package's wording) and
of a warm re-solve, each ending in a device synchronisation.

Run: ``python -m fortran_davidson_tpu_torch.examples.benchmark_free
[--dim 1000] [--platform cpu]``
"""

from __future__ import annotations

import argparse
import time

import torch

from fortran_davidson_tpu_torch.models.generators import (
    surrogate_hamiltonian, surrogate_overlap)
from fortran_davidson_tpu_torch.solver import eigensolve
from fortran_davidson_tpu_torch.utils.dtypes import default_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=1000)
    parser.add_argument("--lowest", type=int, default=3)
    parser.add_argument("--tolerance", type=float, default=1e-8)
    parser.add_argument("--platform", choices=["cpu", "cuda"],
                        help="device (default: the GPU)")
    args = parser.parse_args(argv)

    device = default_device(args.platform)
    A = surrogate_hamiltonian(args.dim, device=device)
    B = surrogate_overlap(args.dim, device=device)

    def solve():
        return eigensolve(A, args.lowest, second_matrix=B, method="DPR",
                          tolerance=args.tolerance, max_iterations=1000,
                          max_dim_sub=20).block_until_ready()

    t0 = time.perf_counter()
    res = solve()
    print(f"cold solve (incl. compile): {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    res = solve()
    iters = int(res.iterations)
    print(f"warm solve: {time.perf_counter() - t0:.3f} s, {iters} iterations")

    print("eigenvalues:", [f"{float(v):.10f}" for v in res.eigenvalues])
    ok = True
    for j in range(args.lowest):
        v = res.eigenvectors[:, j]
        lam = float(res.eigenvalues[j])
        err = float(torch.linalg.vector_norm(A @ v - lam * (B @ v)))
        print(f"residual {j + 1}: {err:.3e}")
        ok = ok and err < 10 * args.tolerance
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
