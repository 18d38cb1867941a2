#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fortran_davidson_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: requires CUDA (exit 1 without it); prints torch, CUDA and the
   card's name and power limit.
2. Build: compiles ``csrc/bsr_spmm.cu`` with nvcc for sm_90a.
3. Kernels against their plain PyTorch versions on the same tensors on
   the card (max relative error <= 1e-12 in float64, <= 1e-5 in float32),
   with CUDA-event times (median of several runs) of both.
4. Main path: ``eigensolve(A, 3)`` and ``eigensolve(A, 20)`` with default
   options on the 1,048,576-row banded BSR matrix
   ``generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3, seed=0)``
   in float64. Each converges at 1e-8 with a true residual (taken with the
   plain SpMM) <= 1e-8, and matches the same solve run through the plain
   versions: same iteration count, eigenvalues to 1e-9.
5. Collapse and generalized legs at the same size: coupling 0.1 with
   ``max_dim_sub=12`` (must collapse), a pencil with a diagonal B, and a
   BSR without a declared bandwidth (the general kernel); plus a small
   solve checked against a dense ``eigvalsh``.
6. Prints the kernels' JSON line (launch counts of phases 4-5), the card's
   name and power limit, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Imports nothing of JAX. Builds into ``fortran_davidson_tpu_torch/_build/``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SOURCE = "fortran_davidson_tpu_torch/csrc/bsr_spmm.cu"
REPLACES = {
    "banded_bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:438",
    "bsr_spmm": "fortran_davidson_tpu/ops/pallas_kernels.py:101",
}
TOL = {"float64": 1e-12, "float32": 1e-5}
SOLVE_TOL = 1e-8


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase_kernels(A, dev, record):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.ops.sparse import (BSROperator,
                                                       generate_banded_bsr)

    gen = torch.Generator(device=dev).manual_seed(1)

    def compare(name, kernel, plain, dtype, m, shape_note):
        n = kernel_rows[name]
        x = torch.randn((n, m), generator=gen, dtype=dtype, device=dev)
        y_k = kernel(x)
        y_p = plain(x)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(y_k - y_p)))
        rel = err / max(float(torch.max(torch.abs(y_p))), 1e-300)
        dname = str(dtype).removeprefix("torch.")
        ms = _time_ms(lambda: kernel(x))
        plain_ms = _time_ms(lambda: plain(x))
        print(f"  {name:16s} {dname:8s} {shape_note:28s} m={m:<4d} "
              f"max_abs_err={err:.3e} rel={rel:.3e} kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms", flush=True)
        _check(rel <= TOL[dname], f"{name} {dname} m={m}: rel err {rel:.3e} "
               f"> {TOL[dname]}")
        record.append(dict(name=name, dtype=dname, m=m, shape=shape_note,
                           max_abs_err=err, rel_err=rel, ms=ms,
                           plain_ms=plain_ms))

    kernel_rows = {}

    # Ragged shapes first: a failing kernel shows on a small case.
    rag = generate_banded_bsr(17, 8, bandwidth=2, seed=9, device=dev)
    rng = np.random.default_rng(3)
    nbr_s, bs_s = 61, 16
    pairs = {(r, r) for r in range(nbr_s)}
    while len(pairs) < 5 * nbr_s:
        i, j = (int(v) for v in rng.integers(0, nbr_s, 2))
        pairs |= {(i, j), (j, i)}
    brows, bcols = np.array(sorted(pairs)).T
    scr = BSROperator.from_block_coo(
        brows, bcols, rng.standard_normal((len(brows), bs_s, bs_s)), nbr_s,
        pad_width=12, device=dev)
    cases = [
        ("banded_bsr_spmm", rag, "nbr=17 bs=8 bw=2", (torch.float64,
                                                       torch.float32), (3,)),
        ("bsr_spmm", rag, "nbr=17 bs=8 K=5 clipped cols",
         (torch.float64, torch.float32), (3,)),
        ("bsr_spmm", scr, "nbr=61 bs=16 K=12 scrambled",
         (torch.float64, torch.float32), (3, 48)),
        ("banded_bsr_spmm", A, "nbr=8192 bs=128 bw=1", (torch.float64,),
         (6, 12, 24, 40, 48, 80, 160, 320)),
        ("banded_bsr_spmm", A, "nbr=8192 bs=128 bw=1", (torch.float32,),
         (6, 48, 320)),
        ("bsr_spmm", A, "nbr=8192 bs=128 K=3 (band dropped)",
         (torch.float64,), (6, 24, 48, 320)),
        ("bsr_spmm", A, "nbr=8192 bs=128 K=3 (band dropped)",
         (torch.float32,), (6, 48, 320)),
    ]
    for name, op, note, dtypes, widths in cases:
        kernel_rows[name] = op.shape[0]
        for dtype in dtypes:
            blocks = op.blocks.to(dtype)
            if name == "banded_bsr_spmm":
                bw = op.bandwidth
                kernel = (lambda x, b=blocks, bw=bw:
                          kernels.banded_bsr_spmm(b, x, bw))
                plain = (lambda x, b=blocks, bw=bw:
                         kernels.banded_bsr_spmm_plain(b, x, bw))
            else:
                cols = op.block_cols
                kernel = (lambda x, b=blocks, c=cols:
                          kernels.bsr_spmm(c, b, x))
                plain = (lambda x, b=blocks, c=cols:
                         kernels.bsr_spmm_plain(c, b, x))
            for m in widths:
                compare(name, kernel, plain, dtype, m, note)
            del blocks
    torch.cuda.empty_cache()


def _true_residual(op_blocks, bw, cols, X, lam, b_diag=None):
    """max_j ||A x_j - lam_j B x_j|| with the plain SpMM."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels
    AX = (kernels.banded_bsr_spmm_plain(op_blocks, X, bw) if bw is not None
          else kernels.bsr_spmm_plain(cols, op_blocks, X))
    BX = X if b_diag is None else b_diag[:, None] * X
    return float(torch.max(torch.linalg.vector_norm(AX - BX * lam[None, :],
                                                    dim=0)))


def _solve(label, A, k, B=None, **kw):
    import torch
    import fortran_davidson_tpu_torch as fdtt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fdtt.eigensolve(A, k, second_matrix=B, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dims = res.subspace_dims[:res.iterations].tolist()
    print(f"  {label}: converged={res.converged} iterations={res.iterations} "
          f"wall={wall:.3f} s dims={dims} "
          f"max_loop_residual={float(res.residual_norms.max()):.3e}",
          flush=True)
    _check(res.converged, f"{label}: did not converge")
    _check(bool(torch.all(torch.isfinite(res.eigenvalues)))
           and tuple(res.eigenvectors.shape) == (A.shape[0], k),
           f"{label}: bad output")
    return res, wall


def phase_main(A, dev, solves):
    """Phase 4: the default solve at k=3 and k=20, kernel vs plain path."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    plain_A = fdtt.MatrixFreeOperator(
        lambda X: kernels.banded_bsr_spmm_plain(A.blocks, X.contiguous(), 1),
        A.shape[0], dtype=A.dtype, diag=A.diagonal(), device=dev)
    for k in (3, 20):
        # In turns (kernel, plain, plain, kernel): the first solve of a
        # shape pays one-time costs (allocator growth, solver handles), so
        # the pair order must not decide the comparison.
        walls = {"kernels": [], "plain": []}
        for path in ("kernels", "plain", "plain", "kernels"):
            before = kernels.banded_bsr_spmm.launches
            torch.cuda.reset_peak_memory_stats()
            res, wall = _solve(f"eigensolve(A, {k}) [{path}]",
                               A if path == "kernels" else plain_A, k)
            walls[path].append(wall)
            launches = kernels.banded_bsr_spmm.launches - before
            if path == "plain":
                _check(launches == 0, "the plain path launched a kernel")
                ref = res
                continue
            _check(launches > 0, f"k={k}: the banded kernel never launched")
            peak = torch.cuda.max_memory_allocated() / 1e9
            true_res = _true_residual(A.blocks, 1, None, res.eigenvectors,
                                      res.eigenvalues)
            _check(true_res <= SOLVE_TOL,
                   f"k={k}: true residual {true_res:.3e}")
            out = res
        dev_eval = float(torch.max(torch.abs(out.eigenvalues
                                             - ref.eigenvalues)))
        print(f"  k={k}: kernel launches per solve={launches} true_residual="
              f"{true_res:.3e} |eig - eig_plain|={dev_eval:.3e} "
              f"peak_mem={peak:.2f} GB", flush=True)
        _check(out.iterations == ref.iterations,
               f"k={k}: {out.iterations} iterations vs {ref.iterations} plain")
        _check(dev_eval <= 1e-9, f"k={k}: eigenvalues differ by {dev_eval:.3e}")
        solves.append(dict(solve=f"banded f64 lowest-{k}", n=A.shape[0],
                           iterations=out.iterations, wall_s=walls["kernels"],
                           plain_wall_s=walls["plain"],
                           true_residual=true_res, launches=launches,
                           peak_mem_gb=peak))
        del res, ref, out
        torch.cuda.empty_cache()


def phase_legs(A, dev, solves):
    """Phase 5: collapse, generalized and general-kernel legs, and a small
    solve against a dense reference."""
    import numpy as np
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    n = A.shape[0]
    strong = fdtt.generate_banded_bsr(A.n_block_rows, A.block_size,
                                      bandwidth=1, coupling=0.1, seed=0,
                                      device=dev)
    res, wall = _solve("coupling 0.1, k=3, max_dim_sub=12", strong, 3,
                       max_dim_sub=12)
    dims = res.subspace_dims[:res.iterations].tolist()
    _check(any(b < a for a, b in zip(dims, dims[1:])),
           f"expected a collapse, dims={dims}")
    tr = _true_residual(strong.blocks, 1, None, res.eigenvectors,
                        res.eigenvalues)
    _check(tr <= SOLVE_TOL, f"collapse leg: true residual {tr:.3e}")
    solves.append(dict(solve="banded f64 coupling 0.1 lowest-3 max_dim 12",
                       n=n, iterations=res.iterations, wall_s=wall,
                       true_residual=tr))
    del strong, res
    torch.cuda.empty_cache()

    b_diag = torch.from_numpy(
        1.0 + 0.5 * np.random.default_rng(7).random(n)).to(dev)
    res, wall = _solve("pencil A x = lam B x, B diagonal, k=3", A, 3,
                       B=fdtt.DiagonalOperator(b_diag))
    tr = _true_residual(A.blocks, 1, None, res.eigenvectors, res.eigenvalues,
                        b_diag)
    _check(tr <= SOLVE_TOL, f"pencil leg: true residual {tr:.3e}")
    solves.append(dict(solve="banded f64 pencil (diagonal B) lowest-3", n=n,
                       iterations=res.iterations, wall_s=wall,
                       true_residual=tr))
    del res

    general = fdtt.BSROperator(A.block_cols, A.blocks)  # no bandwidth
    before = kernels.bsr_spmm.launches
    res, wall = _solve("BSR without bandwidth (general kernel), k=3",
                       general, 3)
    _check(kernels.bsr_spmm.launches > before, "bsr_spmm never launched")
    tr = _true_residual(A.blocks, None, A.block_cols, res.eigenvectors,
                        res.eigenvalues)
    _check(tr <= SOLVE_TOL, f"general leg: true residual {tr:.3e}")
    solves.append(dict(solve="general BSR f64 lowest-3", n=n,
                       iterations=res.iterations, wall_s=wall,
                       true_residual=tr,
                       launches=kernels.bsr_spmm.launches - before))
    del res

    small = fdtt.generate_banded_bsr(64, 16, bandwidth=1, coupling=0.1,
                                     seed=0, device=dev)
    res, _ = _solve("small banded (n=1024), k=3, vs dense eigvalsh", small, 3)
    want = torch.linalg.eigvalsh(small.to_dense().cpu())[:3]
    diff = float(torch.max(torch.abs(res.eigenvalues.cpu() - want)))
    print(f"  small solve vs dense eigvalsh: {diff:.3e}", flush=True)
    _check(diff <= 1e-8, f"small solve: eigenvalues off by {diff:.3e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    smi = _smi()
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    path, log = kernels.build()
    print(f"[2] built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("   ", line.strip())
    sys.stdout.flush()

    t0 = time.perf_counter()
    A = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3,
                                 seed=0, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    print(f"    built A: n={A.shape[0]}, blocks {tuple(A.blocks.shape)} "
          f"float64 ({A.blocks.numel() * 8 / 1e9:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    print("[3] kernels vs plain versions", flush=True)
    record = []
    phase_kernels(A, dev, record)

    solves = []
    kernels.reset_launch_counts()
    print("[4] main path", flush=True)
    phase_main(A, dev, solves)
    print("[5] collapse and generalized legs", flush=True)
    phase_legs(A, dev, solves)
    counts = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    for name, count in counts.items():
        _check(count > 0, f"{name} was never launched on the main path")

    summary = []
    for name in REPLACES:
        rows = [r for r in record if r["name"] == name]
        main_row = next(r for r in rows if r["dtype"] == "float64"
                        and r["m"] == 48 and "8192" in r["shape"])
        summary.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=counts[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"]))
    print(json.dumps({"solves": solves}))
    print(json.dumps({"kernel_cases": record}))
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
