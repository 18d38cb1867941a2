#!/usr/bin/env python3
"""The JAX package's plain float64 DPR solve of the surrogate, on the CPU.

    JAX_PLATFORMS=cpu python scripts/jax_float64_surrogate.py --n 4000000

The reference side of ROADMAP Queue 3's float64 entry: lowest-20 of
``surrogate_hamiltonian(n, float64)`` to relative 1e-8 with
``expansion="lowest-k"`` and ``max_dim_sub=60``, the recipe that the
port's solve at 10,000,384 rows stops on at a fixed point on the GPU
while the GPU machine's CPU converges. Prints the subspace dimensions,
the iterations, the converged flag, the loop's residual norms by pair
and the peak resident memory of the process, and as the last line one
JSON object with them. It runs the JAX package only, on the CPU (float64
needs ``jax_enable_x64``).
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=4_000_000)
    parser.add_argument("--lowest", type=int, default=20)
    parser.add_argument("--max-dim-sub", type=int, default=60)
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import fortran_davidson_tpu as fdt
    from fortran_davidson_tpu.models.generators import surrogate_hamiltonian

    op = surrogate_hamiltonian(args.n, dtype="float64")
    res = fdt.eigensolve(op, args.lowest, method="DPR", tolerance=1e-8,
                         relative_tolerance=True, expansion="lowest-k",
                         max_dim_sub=args.max_dim_sub, dtype="float64")
    res.block_until_ready()
    its = int(res.iterations)
    out = dict(
        n=args.n, lowest=args.lowest, max_dim_sub=args.max_dim_sub,
        backend=jax.default_backend(), iterations=its,
        converged=bool(res.converged),
        subspace_dims=np.asarray(res.subspace_dims)[:its].tolist(),
        residual_norms=np.asarray(res.residual_norms).tolist(),
        eigenvalues=np.asarray(res.eigenvalues).tolist(),
        peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)
    print(f"n={args.n}: iterations {its}, converged {out['converged']}, "
          f"dims {out['subspace_dims']}, residuals by pair "
          f"{['%.3e' % r for r in out['residual_norms']]}, peak RSS "
          f"{out['peak_rss_gb']:.1f} GB", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
