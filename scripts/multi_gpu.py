#!/usr/bin/env python3
"""Phase 16d of ``chip_smoke.py`` alone, with the one-GPU runs it is held
to, on a host with two or more GPUs.

    python3 scripts/multi_gpu.py

Builds the kernels, then on GPU 0 (a one-rank NCCL group) runs what
phase 16d compares with: phase 4's default solves of the 1,048,576-row
float64 matrix (kernel 1), phase 6's int8 loose stage and 6b's refined
stage on the 2,097,152-row int8 matrix (kernel 4), phase 8a-8b's
row-sharded solves at world size 1 (kernels 6-8), 14b's sharded refined
stage (kernel 7) and phase 16a-16b's inventories and all_reduce latency.
Then phase 16d: 8b's lowest-20 through ``"pallas-remote"`` (kernel 8 on
its push route: the halos written into the ring neighbours' windows over
NVLink from inside its one launch) and 14b's refined stage (kernel 7) at
world size 2, and 4 where four GPUs are visible, over NCCL in spawned
ranks, each held to world 1 (iterations, eigenvalues, each rank's
collective inventory), its route, its measured efficiency printed beside
the model's projection, and one apply of the push and of the exchange
route timed in turns. Last, a skipped epoch at the largest world size:
rank 0 applies the push route once more than the others; every rank's
wait must run out within the bound (``SKIP_LIMIT_NS``) and report its
rank, epoch and slot instead of hanging. Exits 1 without two GPUs or when
a check fails. Prints the card's name and power limit; the last line is
one JSON object of the solves.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# The skipped-epoch check: the bound of each wait, and how long the
# parent waits for the ranks' reports.
SKIP_LIMIT_NS = 3_000_000_000
SKIP_JOIN_S = 240


def _rank_skip(rank: int, world: int, tmp: str) -> None:
    """A rank of the skipped-epoch check: three applies of the push route
    on every rank, then one more, rank 0's a skipped epoch ahead. Writes
    what the card reported to ``tmp/skip<rank>.txt`` and leaves without
    tearing the group down (the trap lost the CUDA context)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel import HaloBSROperator, multihost
    from fortran_davidson_tpu_torch.utils.errors import HaloPushFault
    kernels.PUSH_SPIN_LIMIT_NS = SKIP_LIMIT_NS
    dev = torch.device("cuda", rank)
    mesh = multihost.initialize(init_method=f"file://{tmp}/skip",
                                world_size=world, rank=rank, device=dev)
    A = fdtt.generate_banded_bsr(64 * world, 128, bandwidth=1, seed=0,
                                 dtype=torch.float64, device=dev)
    R = HaloBSROperator.from_bsr(A, 1, mesh, backend="pallas-remote")
    x = torch.ones((A.shape[0] // world, 8), dtype=torch.float64,
                   device=dev)
    for _ in range(3):
        R.matmat(x)
    torch.cuda.synchronize()
    mesh.barrier()
    if rank == 0:
        R._push["window"].next_epoch()
    t0 = time.monotonic()
    R.matmat(x)
    lines = [f"route {R.route}"]
    try:
        torch.cuda.synchronize()
        lines.append("no trap")
    except RuntimeError as exc:
        lines.append(f"synchronize raised: {str(exc).splitlines()[0]}")
    lines.append(f"after {time.monotonic() - t0:.2f} s")
    try:
        R._push["window"].raise_if_faulted()
    except HaloPushFault as exc:
        lines.append(f"fault: {exc}")
    with open(os.path.join(tmp, f"skip{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    os._exit(0)


def skipped_epoch(world: int) -> dict:
    """Run the skipped-epoch check on ``world`` GPUs; every rank must
    report a fault (its rank, epoch, slot) within the bound."""
    import torch.multiprocessing as mp
    import chip_smoke as cs
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_skip, args=(world, tmp), nprocs=world,
                       join=False)
        deadline = time.monotonic() + SKIP_JOIN_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"skipped epoch: the ranks hung past "
                                     f"{SKIP_JOIN_S} s")
        reports = {}
        for r in range(world):
            path = os.path.join(tmp, f"skip{r}.txt")
            cs._check(os.path.exists(path),
                      f"skipped epoch: rank {r} ended without a report")
            with open(path) as f:
                reports[r] = f.read().strip()
    # Rank 0 and its ring neighbours wait on one another's pushes of
    # another epoch; a rank further away completes its apply.
    waiting = {0, 1 % world, world - 1}
    for r, text in reports.items():
        print(f"  skip rank {r}: " + text.replace("\n", "; "), flush=True)
        faulted = f"fault: halo push: rank {r}, epoch" in text
        cs._check(faulted == (r in waiting),
                  f"skipped epoch: rank {r} reported {text!r}")
    return reports


def main() -> int:
    import torch
    import torch.distributed as dist
    if torch.cuda.device_count() < 2:
        print(f"multi_gpu: {torch.cuda.device_count()} GPU visible; it needs "
              "two or more", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs._smi()
    print(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)
    path, _ = kernels.build()
    print(f"built {path.name} in {time.perf_counter() - t_run:.1f} s",
          flush=True)
    dev = torch.device("cuda", 0)
    A = fdtt.generate_banded_bsr(cs.P16_MULTI["nbr"], cs.P16_MULTI["bs"],
                                 bandwidth=1, coupling=1e-3, seed=0,
                                 dtype=torch.float64, device=dev)
    q = fdtt.generate_banded_bsr_quantized(cs.P16_MULTI["q_nbr"],
                                           cs.P16_MULTI["bs"], bandwidth=1,
                                           coupling=1e-3, seed=0, device=dev)
    solves, refs, p16 = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{tmp}/rendezvous"
        try:
            for title, run in [
                    ("[4] main path", lambda: cs.phase_main(
                        A, dev, solves, refs)),
                    ("[6] int8 loose stage", lambda: cs.phase_int8(
                        q, dev, solves, refs)),
                    ("[6b] refined stage", lambda: cs.phase_refined(
                        q, dev, solves, refs)),
                    ("[8a] sharded, world size 1, pallas",
                     lambda: cs.phase_sharded(A, q, dev, rendezvous, solves,
                                              refs)),
                    ("[8b] sharded, world size 1, pallas-remote",
                     lambda: cs.phase_remote(A, dev, rendezvous, solves,
                                             refs)),
                    ("[14b] sharded refined stage, world size 1",
                     lambda: cs.phase_sharded_refined(q, dev, rendezvous,
                                                      solves, refs)),
                    ("[16a] inventory, int8, world size 1",
                     lambda: cs.phase16_int8(q, dev, rendezvous, solves,
                                             p16)),
                    ("[16b] per-rule inventories, world size 1",
                     lambda: cs.phase16_rules(A, dev, rendezvous, solves,
                                              refs, p16))]:
                print(title, flush=True)
                # Each phase checks the launches since its own start, as
                # chip_smoke.py's run_path counts them.
                kernels.reset_launch_counts()
                run()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        del A, q
        torch.cuda.empty_cache()
        print("[16d] world sizes 2 and 4 over NCCL", flush=True)
        t0 = time.perf_counter()
        cs.phase16_multi_gpu(dev, solves, refs, p16)
        print(f"    16d in {time.perf_counter() - t0:.1f} s", flush=True)
    world = 4 if torch.cuda.device_count() >= 4 else 2
    print(f"[skip] a skipped epoch at world size {world}", flush=True)
    t0 = time.perf_counter()
    reports = skipped_epoch(world)
    solves.append(dict(solve=f"phase 16 skipped epoch world {world}",
                       reports=reports))
    print(f"    in {time.perf_counter() - t0:.1f} s; the run "
          f"{time.perf_counter() - t_run:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"solves": [s for s in solves
                                 if str(s.get("solve", "")).startswith(
                                     "phase 16")]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
