#!/usr/bin/env python3
"""The port's plain float64 surrogate solve on the GPU and on the CPU, and
where the two part: the first expansion's orthonormalization.

    python3 scripts/surrogate_stall.py [--n 4000000] [--max-dim-sub 60]

Lowest-20 of ``surrogate_hamiltonian(n, float64)`` to relative 1e-8 with
``expansion="lowest-k"`` (the recipe of ROADMAP Queue 3's float64 entry;
``scripts/jax_float64_surrogate.py`` runs the JAX package's on a CPU) on
``cuda`` and on ``cpu``. For each device it prints the iterations, the
converged and stalled flags, the subspace dimensions and the residuals by
pair. It keeps the inputs of each solve's first call of
``core.orthogonal.orthonormalize_block`` (the basis V and the 20 DPR
corrections) and replays the call's stages on both devices from both
devices' inputs: the column norms, the two CGS passes (the tall
``Vᵀ block`` products), the normalized SVQB Gram and its ``eigh``, the
rank threshold and the columns kept. Beside each stage it prints the
largest difference between the devices on the same input, so the stage
whose reduction moves the kept count shows. The last line is one JSON
object with all of it; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LOWEST = 20
RECIPE = dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
              expansion="lowest-k", dtype="float64")


def _solve(n, max_dim_sub, device):
    """The solve on ``device``, with the first orthonormalization's inputs
    (moved to the CPU) and its kept-column count."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.core import loop
    from fortran_davidson_tpu_torch.models import generators

    op = generators.surrogate_hamiltonian(n, dtype=torch.float64,
                                          device=device)
    captured = {}
    real = loop.orthogonal.orthonormalize_block

    def spy(V, block, mask, **kw):
        q, alive = real(V, block, mask, **kw)
        if not captured:
            captured.update(V=V.cpu(), block=block.cpu(), mask=mask.cpu(),
                            kw=kw, alive=int(alive.sum()))
        return q, alive

    loop.orthogonal.orthonormalize_block = spy
    try:
        t0 = time.perf_counter()
        res = fdtt.eigensolve(op, LOWEST, max_dim_sub=max_dim_sub, **RECIPE)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        loop.orthogonal.orthonormalize_block = real
    its = res.iterations
    out = dict(device=device, iterations=its, converged=res.converged,
               stalled=res.stalled, wall_s=wall,
               subspace_dims=res.subspace_dims[:its].tolist(),
               residual_norms=res.residual_norms.tolist(),
               eigenvalues=res.eigenvalues.tolist(),
               first_ortho_kept=captured.get("alive"))
    return out, captured


def _stages(cap, device):
    """The stages of ``orthonormalize_block`` (cholqr2 method, one
    device) on ``cap``'s inputs, on ``device``."""
    import torch
    from fortran_davidson_tpu_torch.core import orthogonal

    V = cap["V"].to(device)
    mask = cap["mask"].to(device)
    block = cap["block"].to(device) * mask[None, :]
    kw = cap["kw"]
    out = dict(norms_before=torch.linalg.vector_norm(block, dim=0))
    coeffs = []
    for _ in range(kw.get("n_reorth", 2)):
        c = V.T @ block
        coeffs.append(c)
        block = block - V @ c
    out["cgs_coeffs"] = torch.cat(coeffs, dim=1)
    out["norms_after"] = torch.linalg.vector_norm(block, dim=0)
    finfo = torch.finfo(block.dtype)
    alive = ((out["norms_after"] > finfo.eps ** 0.5
              * torch.clamp(out["norms_before"], min=finfo.tiny))
             & (mask > 0.5))
    block = block * alive[None, :].to(block.dtype)
    norms = torch.linalg.vector_norm(block, dim=0)
    inv = torch.where(norms > 0, 1.0 / torch.where(norms > 0, norms, 1.0),
                      0.0)
    Bh = block * inv[None, :]
    active = (norms > 0).to(block.dtype) * mask * alive.to(block.dtype)
    G = Bh.T @ Bh + torch.diag(1.0 - active)
    s, _ = orthogonal.eigh(G)
    width = kw.get("rank_width") or block.shape[1]
    threshold = width * finfo.eps * s[-1]
    out.update(gram=G, gram_eigenvalues=s, threshold=threshold,
               kept=int(torch.sum(s > threshold)),
               cgs_survivors=int(alive.sum()))
    _, alive_full = orthogonal.orthonormalize_block(
        V, cap["block"].to(device), mask, **kw)
    out["kept_by_orthonormalize_block"] = int(alive_full.sum())
    return {k: (v.cpu() if hasattr(v, "cpu") else v) for k, v in out.items()}


def _rel(a, b) -> float:
    import torch
    scale = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / (scale if scale else 1.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=4_000_000)
    parser.add_argument("--max-dim-sub", type=int, default=60)
    parser.add_argument("--devices", default="cuda,cpu")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch
    devices = args.devices.split(",")
    if "cuda" in devices and not torch.cuda.is_available():
        print("surrogate_stall: no CUDA device", file=sys.stderr)
        return 1
    solves, caps = {}, {}
    for dev in devices:
        solves[dev], caps[dev] = _solve(args.n, args.max_dim_sub, dev)
        s = solves[dev]
        print(f"[{dev}] n={args.n} max_dim_sub={args.max_dim_sub}: "
              f"iterations {s['iterations']}, converged {s['converged']}, "
              f"stalled {s['stalled']}, dims {s['subspace_dims']}, "
              f"{s['wall_s']:.2f} s; residuals by pair "
              + " ".join(f"{r:.3e}" for r in s["residual_norms"])
              + f"; first orthonormalization kept {s['first_ortho_kept']}",
              flush=True)
    report = dict(n=args.n, max_dim_sub=args.max_dim_sub, solves=solves)
    if len(devices) == 2:
        a, b = devices
        report["inputs"] = dict(
            V_rel_diff=_rel(caps[a]["V"], caps[b]["V"]),
            corrections_rel_diff=_rel(caps[a]["block"], caps[b]["block"]))
        print(f"  inputs of the first orthonormalization, {a} against {b}: "
              f"V {report['inputs']['V_rel_diff']:.3e}, corrections "
              f"{report['inputs']['corrections_rel_diff']:.3e} (largest "
              "difference over the largest entry)", flush=True)
        replay = {}
        for src in devices:
            st = {dev: _stages(caps[src], dev) for dev in devices}
            row = dict(
                kept={dev: st[dev]["kept"] for dev in devices},
                kept_by_orthonormalize_block={
                    dev: st[dev]["kept_by_orthonormalize_block"]
                    for dev in devices},
                cgs_survivors={dev: st[dev]["cgs_survivors"]
                               for dev in devices},
                threshold={dev: float(st[dev]["threshold"])
                           for dev in devices},
                gram_eigenvalues={dev: st[dev]["gram_eigenvalues"].tolist()
                                  for dev in devices},
                rel_diff={key: _rel(st[a][key], st[b][key]) for key in (
                    "norms_before", "cgs_coeffs", "norms_after", "gram",
                    "gram_eigenvalues")})
            replay[f"inputs of {src}"] = row
            print(f"  replay on the inputs of {src}: kept {row['kept']} "
                  f"(orthonormalize_block: "
                  f"{row['kept_by_orthonormalize_block']}), CGS survivors "
                  f"{row['cgs_survivors']}, threshold {row['threshold']}",
                  flush=True)
            for dev in devices:
                s = row["gram_eigenvalues"][dev]
                print(f"    {dev}: the 10 smallest Gram eigenvalues "
                      + " ".join(f"{x:.3e}" for x in s[:10]), flush=True)
            print("    largest difference between the devices, over the "
                  "largest entry: " + ", ".join(
                      f"{k} {v:.3e}" for k, v in row["rel_diff"].items()),
                  flush=True)
        report["replay"] = replay
    line = json.dumps(report)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
