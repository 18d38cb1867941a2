"""North-star workload: lowest-k eigenpairs of a 10M-row operator.

BASELINE.json's headline target is the lowest eigenpairs of a 10M-row
diagonal-dominant sparse matrix. This driver runs that shape end to end
on one GPU (``fortran_davidson_tpu/examples/northstar.py``, flag for
flag):

- ``--mode free`` (default): the separable matrix-free surrogate
  (O(n m) per application, no stored matrix), in float32;
- ``--mode banded``: a banded BSR operator generated in float32; on a
  GPU it is stored in bf16 (float32 iterates and sums: kernel 1's bf16
  entry), on the CPU it stays float32. ``--quantize`` generates and
  quantizes it to int8 on the host instead (kernel 4), so that only the
  int8 blocks, their scales and the float32 diagonal reach the device:
  3.84 GB at n = 10M against 15.4 GB of float32 blocks;
- ``--sharded``: row-shard the solve over the ranks of the
  ``torch.distributed`` group that ``parallel.multihost.initialize()``
  starts (one process a GPU, ``torchrun``). The matrix-free operator has
  no sharding rule and ``--refined`` no sharded path yet: both raise by
  name (ROADMAP item 19).

The 10M-row, 1e-8 recipe of the JAX package (its default basis width
resolves from a device-memory budget, ``config._carry_budget_bytes``)::

    python -m fortran_davidson_tpu_torch northstar --lowest 20 \\
        --progressive --tolerance 1e-8 --expansion lowest-k

``chip_smoke.py`` phases 10a-10c run it on the card through
:func:`parse_args`, :func:`build_operator` and :func:`solve_timed`; the
walls, iterations and memory are in PERF.md §5.
"""

from __future__ import annotations

import argparse
import time

import torch

from fortran_davidson_tpu_torch.models.generators import surrogate_hamiltonian
from fortran_davidson_tpu_torch.ops.sparse import (
    generate_banded_bsr, generate_banded_bsr_quantized)
from fortran_davidson_tpu_torch.solver import eigensolve, polish_eigenpairs
from fortran_davidson_tpu_torch.utils.dtypes import default_device


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=10_000_384)
    parser.add_argument("--lowest", type=int, default=4)
    # A plain float32 solve floors at ~1e-3 relative at n = 10M (the
    # wide spectrum's Gram roundoff); --refined (and --progressive) reach
    # 1e-8 through the double-single path and its final polish.
    parser.add_argument("--tolerance", type=float, default=3e-3)
    parser.add_argument("--mode", choices=["free", "banded"], default="free")
    parser.add_argument("--block-size", type=int, default=128)
    parser.add_argument("--bandwidth", type=int, default=1)
    parser.add_argument("--quantize", action="store_true",
                        help="banded mode: int8 block storage with the "
                        "exact f32 diagonal, generated and quantized on "
                        "the host, so the float32 table never reaches the "
                        "device")
    parser.add_argument("--sharded", action="store_true")
    parser.add_argument("--max-iterations", type=int, default=100)
    parser.add_argument("--expansion", choices=["doubling", "lowest-k"],
                        default="doubling",
                        help="lowest-k shrinks the padded basis for large "
                        "k (e.g. lowest-20)")
    parser.add_argument("--refined", action="store_true",
                        help="double-single high-precision path: true "
                        "compensated residuals + Rayleigh-refined "
                        "eigenvalues (reach 1e-6-grade tolerances in f32)")
    parser.add_argument("--polish", type=int, default=0, metavar="ITERS",
                        help="post-solve double-single eigenpair polish "
                        "(residuals to the 1e-8 regime)")
    parser.add_argument("--final-polish", type=int, default=0,
                        metavar="ITERS",
                        help="in-solve polish (requires --refined): "
                        "convergence is checked against the polished true "
                        "residuals")
    parser.add_argument("--progressive", action="store_true",
                        help="two-stage pipeline: a cheap plain-f32 "
                        "solve to its residual floor warm-starts the "
                        "refined solve (implies --refined and "
                        "--final-polish >= 3)")
    parser.add_argument("--carry-layout", choices=["auto", "flat", "chunked"],
                        default="auto",
                        help="refined-path storage of the tall carries "
                        "(requires --refined); the port stores them flat "
                        "whatever is asked")
    parser.add_argument("--max-dim-sub", type=int, default=0,
                        help="subspace collapse threshold (default "
                        "10*lowest, clamped to the device-memory budget "
                        "at large n)")
    parser.add_argument("--platform", choices=["cpu", "cuda"],
                        help="device (default: the GPU)")
    args = parser.parse_args(argv)
    if args.sharded and args.polish:
        parser.error("--polish is not sharded: polish_eigenpairs takes the "
                     "global vectors, and a sharded solve returns each "
                     "rank's rows (ROADMAP item 19)")
    if args.progressive:
        args.refined = True
        args.final_polish = max(args.final_polish, 3)
    return args


def build_operator(args: argparse.Namespace, device=None):
    """The operator of ``args.mode`` on ``device`` (by default
    ``--platform``, else the GPU)."""
    device = default_device(device if device is not None else args.platform)
    if args.mode == "free":
        return surrogate_hamiltonian(args.n, dtype=torch.float32,
                                     device=device)
    nbr = args.n // args.block_size
    if args.quantize:
        return generate_banded_bsr_quantized(nbr, args.block_size,
                                             bandwidth=args.bandwidth,
                                             coupling=1e-3, device=device)
    op = generate_banded_bsr(nbr, args.block_size, bandwidth=args.bandwidth,
                             coupling=1e-3, dtype=torch.float32,
                             device=device)
    if op.device.type == "cuda":
        # bf16 block storage (f32 iterates and sums) halves the operator's
        # memory; its values carry bf16 representation error (~0.4%
        # relative).
        op = op.astype(torch.bfloat16)
    return op


def solve_options(args: argparse.Namespace) -> tuple[dict, dict]:
    """The solve's options, and the loose stage's (``--progressive``)."""
    common = dict(method="DPR", tolerance=args.tolerance,
                  max_iterations=args.max_iterations, dtype="float32",
                  relative_tolerance=True, expansion=args.expansion,
                  refined=args.refined, final_polish=args.final_polish)
    if args.max_dim_sub:
        common["max_dim_sub"] = args.max_dim_sub
    if args.refined and not args.sharded:
        common["carry_layout"] = args.carry_layout
    loose = dict(common, tolerance=max(args.tolerance, 1e-3),
                 refined=False, final_polish=0, max_iterations=30)
    return common, loose


def run(op, args: argparse.Namespace, mesh=None):
    """One solve of ``op`` as ``args`` asks (the loose stage, then the
    refined one from its vectors, under ``--progressive``); row-sharded
    over ``mesh`` when it is given. Returns the last stage's result,
    synchronised."""
    common, loose = solve_options(args)
    if mesh is not None:
        from fortran_davidson_tpu_torch.parallel import eigensolve_sharded

        def solve(**kw):
            return eigensolve_sharded(op, args.lowest, mesh, **kw)
    else:
        def solve(**kw):
            return eigensolve(op, args.lowest, **kw)
    if args.progressive:
        first = solve(**loose)
        return solve(initial_vectors=first.eigenvectors,
                     **common).block_until_ready()
    return solve(**common).block_until_ready()


def solve_timed(op, args: argparse.Namespace, mesh=None):
    """A cold and a warm :func:`run`, with the JAX example's lines.
    Returns ``(result, cold_s, warm_s)`` of the warm run."""
    t0 = time.perf_counter()
    res = run(op, args, mesh)
    cold = time.perf_counter() - t0
    print(f"cold solve (incl. compile): {cold:.1f} s")
    t0 = time.perf_counter()
    res = run(op, args, mesh)
    warm = time.perf_counter() - t0
    iters = int(res.iterations)
    print(f"warm solve: {warm:.2f} s  ({warm / max(iters, 1) * 1e3:.1f} "
          f"ms/iter), {iters} iterations, converged={bool(res.converged)}")
    print("eigenvalues:", [f"{float(v):.6f}" for v in res.eigenvalues])
    print("residuals:  ", [f"{float(v):.2e}" for v in res.residual_norms])
    return res, cold, warm


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh = None
    if args.sharded:
        from fortran_davidson_tpu_torch.parallel import multihost
        mesh = multihost.initialize(device=args.platform)
        print(f"mesh: {{{mesh.axis!r}: {mesh.size}}}")
    op = build_operator(args, device=None if mesh is None else mesh.device)
    res, _, _ = solve_timed(op, args, mesh)
    if args.polish:
        t0 = time.perf_counter()
        pol = polish_eigenpairs(op, res, iterations=args.polish)
        errs = [float(v) for v in pol.errors]
        print(f"polish ({args.polish} iters): "
              f"{time.perf_counter() - t0:.2f} s")
        print("polished eigenvalues:", [f"{float(v):.9f}"
                                        for v in pol.evals])
        print("polished residuals:  ", [f"{v:.2e}" for v in errs])
    return 0 if bool(res.converged) else 1


if __name__ == "__main__":
    raise SystemExit(main())
