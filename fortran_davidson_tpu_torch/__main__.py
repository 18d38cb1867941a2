"""Command-line driver: ``python -m fortran_davidson_tpu_torch <command>``.

The counterpart of ``python -m fortran_davidson_tpu``: the reference's
compiled driver programs (``src/main.f90`` demo,
``src/benchmark_free.f90``) plus a general ``solve`` command over
on-disk matrices. Every command runs on the GPU unless given
``--platform cpu``; without a GPU it raises ``DeviceUnavailableError``.

Commands:
  solve       lowest-k eigenpairs of a matrix file (.npy/.npz/.txt)
  demo        the reference's dim-100 generalized GJD-vs-DPR demo
  benchmark   the reference's dim-1000 matrix-free benchmark (timed)
  northstar   the 10M-row single-GPU benchmark driver

``solve`` accepts whitespace-text matrices (the reference's interchange
format, ``utils.io``), ``.npy`` dense arrays, or ``.npz`` files with
either a dense ``matrix`` entry or scipy-sparse CSR members (``data`` /
``indices`` / ``indptr`` / ``shape``); sparse input becomes a padded-ELL
operator (``ops.operators.as_operator``), assembled on the host.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np

from fortran_davidson_tpu_torch.ops.operators import as_operator
from fortran_davidson_tpu_torch.solver import eigensolve
from fortran_davidson_tpu_torch.utils.dtypes import (canonical_dtype,
                                                     default_device)
from fortran_davidson_tpu_torch.utils.io import read_matrix

_EXAMPLES = {"demo": "demo", "benchmark": "benchmark_free",
             "northstar": "northstar"}


def _read_array(path: str):
    """The matrix stored at ``path``: a dense array, or a
    ``scipy.sparse.csr_matrix`` from an ``.npz`` of CSR members."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "matrix" in z:
                return z["matrix"]
            if {"data", "indices", "indptr", "shape"} <= set(z.files):
                import scipy.sparse as sp
                return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                                     shape=tuple(z["shape"]))
            raise SystemExit(
                f"{path}: .npz needs a 'matrix' entry or scipy CSR "
                f"members (data/indices/indptr/shape); found "
                f"{sorted(z.files)}")
    return read_matrix(path)


def _load_operator(path: str, dtype, device):
    return as_operator(_read_array(path), dtype=canonical_dtype(dtype),
                       device=device)


def _cmd_solve(args) -> int:
    mesh = None
    if args.sharded:
        from fortran_davidson_tpu_torch.parallel import multihost
        mesh = multihost.initialize(device=args.platform)
        device = mesh.device
    else:
        device = default_device(args.platform)
    A = _load_operator(args.matrix, args.dtype, device)
    B = (_load_operator(args.second_matrix, args.dtype, device)
         if args.second_matrix else None)
    kw = dict(method=args.method, tolerance=args.tolerance,
              max_iterations=args.max_iterations, dtype=args.dtype,
              relative_tolerance=args.relative_tolerance,
              refined=args.refined, final_polish=args.final_polish,
              gjd_warm_start=args.gjd_warm_start)
    if args.refined and not args.sharded:
        kw["carry_layout"] = args.carry_layout
    if args.initial_vectors:
        kw["initial_vectors"] = np.load(args.initial_vectors)
    if args.max_dim_sub:
        kw["max_dim_sub"] = args.max_dim_sub
    if mesh is not None:
        from fortran_davidson_tpu_torch.parallel import eigensolve_sharded
        res = eigensolve_sharded(A, args.lowest, mesh, second_matrix=B, **kw)
    else:
        res = eigensolve(A, args.lowest, second_matrix=B, **kw)
    res.block_until_ready()

    out = {
        "eigenvalues": res.eigenvalues.cpu().tolist(),
        "residual_norms": res.residual_norms.cpu().tolist(),
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "stalled": (bool(res.stalled)
                    if res.stalled is not None else None),
        "operator_columns": int(res.operator_columns),
    }
    print(json.dumps(out))
    if args.eigenvectors:
        X = res.eigenvectors
        if mesh is not None:
            # Each rank holds its rows; the file holds all of them.
            X = mesh.all_gather_rows(X)
        if mesh is None or mesh.rank == 0:
            np.save(args.eigenvectors, X.cpu().numpy())
            print(f"eigenvectors -> {args.eigenvectors}", file=sys.stderr)
    return 0 if bool(res.converged) else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fortran_davidson_tpu_torch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="lowest-k eigenpairs of a matrix file")
    ps.add_argument("matrix", help=".npy / .npz (dense 'matrix' or scipy "
                    "CSR members, which become ELL) / whitespace-text matrix")
    ps.add_argument("--lowest", "-k", type=int, default=3)
    ps.add_argument("--second-matrix", help="operator B (generalized)")
    ps.add_argument("--method", default="DPR",
                    choices=["DPR", "GJD", "OLSEN"])
    ps.add_argument("--gjd-warm-start", action="store_true",
                    help="recycle each outer iteration's GJD correction "
                    "as the next inner solve's initial guess (GJD only)")
    ps.add_argument("--tolerance", type=float, default=1e-8)
    ps.add_argument("--relative-tolerance", action="store_true")
    ps.add_argument("--max-iterations", type=int, default=1000)
    ps.add_argument("--max-dim-sub", type=int, default=0)
    ps.add_argument("--dtype", default="float64",
                    choices=["float64", "float32"])
    ps.add_argument("--refined", action="store_true",
                    help="double-single high-precision path (f32)")
    ps.add_argument("--final-polish", type=int, default=0,
                    metavar="ITERS",
                    help="in-solve eigenpair polish (requires --refined)")
    ps.add_argument("--carry-layout", choices=["auto", "flat", "chunked"],
                    default="auto",
                    help="refined-path carry storage (requires --refined); "
                    "the port stores the carries flat whatever is asked")
    ps.add_argument("--sharded", action="store_true",
                    help="row-shard over the ranks of the torch.distributed "
                    "group (parallel.multihost.initialize)")
    ps.add_argument("--eigenvectors", metavar="OUT.npy",
                    help="save eigenvectors to this .npy file")
    ps.add_argument("--platform", choices=["cpu", "cuda"],
                    help="device (default: the GPU)")
    ps.add_argument("--initial-vectors", metavar="X0.npy",
                    help="warm-start block from a previous solve "
                    "(see --eigenvectors)")

    for name, mod in _EXAMPLES.items():
        p = sub.add_parser(name, add_help=False,
                           help=f"run examples.{mod} (args passed through)")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _EXAMPLES:
        # Everything after the command is the example's own (argparse's
        # REMAINDER would refuse a first argument that starts with --).
        m = importlib.import_module(
            f"fortran_davidson_tpu_torch.examples.{_EXAMPLES[argv[0]]}")
        return m.main(argv[1:])
    return _cmd_solve(parser.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
