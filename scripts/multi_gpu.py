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
Then phase 16d: 8b's lowest-20 through ``"pallas-remote"`` (kernel 8)
and 14b's refined stage (kernel 7) at world size 2, and 4 where four
GPUs are visible, over NCCL in spawned ranks, each held to world 1
(iterations, eigenvalues, each rank's collective inventory), its
measured efficiency printed beside the model's projection. Exits 1
without two GPUs or when a check fails. Prints the card's name and
power limit; the last line is one JSON object of the solves.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


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
        print(f"    16d in {time.perf_counter() - t0:.1f} s; the run "
              f"{time.perf_counter() - t_run:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"solves": [s for s in solves
                                 if str(s.get("solve", "")).startswith(
                                     "phase 16")]}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
