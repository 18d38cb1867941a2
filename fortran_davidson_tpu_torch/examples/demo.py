"""Demo driver — the reference's ``main`` executable, on the GPU.

Mirrors ``src/main.f90:31-75``: a dim-100 generalized problem solved with
GJD then DPR at tol 1e-5 / max subspace 10, followed by the same two
checks (eigenvalue agreement between methods; per-pair residual norms
``||A v - lambda B v||``), in float64 as the reference computes.

Run: ``python -m fortran_davidson_tpu_torch.examples.demo [--dim 100]
[--platform cpu]``. The matrices draw from numpy seeds 0 and 1, so their
values are not the JAX package's.
"""

from __future__ import annotations

import argparse

import torch

from fortran_davidson_tpu_torch.models.generators import \
    generate_diagonal_dominant
from fortran_davidson_tpu_torch.solver import generalized_eigensolver
from fortran_davidson_tpu_torch.utils.dtypes import default_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--lowest", type=int, default=3)
    parser.add_argument("--tolerance", type=float, default=1e-5)
    parser.add_argument("--platform", choices=["cpu", "cuda"],
                        help="device (default: the GPU)")
    args = parser.parse_args(argv)

    device = default_device(args.platform)
    k = args.lowest
    mtx = generate_diagonal_dominant(args.dim, 1e-3, device=device)
    stx = generate_diagonal_dominant(args.dim, 1e-3, diag_val=1.0, seed=1,
                                     device=device)

    res_gjd = generalized_eigensolver(mtx, k, method="GJD",
                                      max_iterations=100,
                                      tolerance=args.tolerance,
                                      max_dim_sub=10, second_matrix=stx)
    print(f"GJD algorithm converged in: {int(res_gjd.iterations)} iterations!")
    res_dpr = generalized_eigensolver(mtx, k, method="DPR",
                                      max_iterations=100,
                                      tolerance=args.tolerance,
                                      max_dim_sub=10, second_matrix=stx)
    print(f"DPR algorithm converged in: {int(res_dpr.iterations)} iterations!")

    print("Test 1")
    diff = float(torch.linalg.vector_norm(res_gjd.eigenvalues
                                          - res_dpr.eigenvalues))
    print("Check that eigenvalues norm computed by different methods are "
          f"the same: {diff < 1e-6}")

    print("Test 2")
    print("Check that eigenvalue equation:  H V = l S V  holds!")
    ok = True
    for name, res in (("DPR", res_dpr), ("GJD", res_gjd)):
        print(f"{name} method:")
        for j in range(k):
            v = res.eigenvectors[:, j]
            lam = float(res.eigenvalues[j])
            err = float(torch.linalg.vector_norm(mtx @ v - lam * (stx @ v)))
            print(f"eigenvalue {j + 1}: {lam:.12f}  ||Error||: {err:.3e}")
            ok = ok and err < 10 * args.tolerance
    return 0 if (ok and diff < 1e-6) else 1


if __name__ == "__main__":
    raise SystemExit(main())
