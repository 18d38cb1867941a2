#!/usr/bin/env python3
"""Kernel 6's TMA route called again and again on one GPU, every output
held bit for bit to its cp.async route (the same products in the same
order); with ``--mutants``, the same on builds of ``csrc/ext_spmm.cu``
whose consumers release a stage differently, beside the SASS of each.

    python3 scripts/tma_stress.py [--calls N] [--mutants]

Cases, on ``generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3,
seed=0)`` (1,048,576 rows, as ``chip_smoke.py``) over a seeded x_ext:
f64 at m = 40 (the main case, 5N calls) and m = 6, 12, 24, 80, 160; f32
at m = 12, 40, 160; bf16 at m = 24, 40, 160 (N calls each; bf16 storage
compared in its float32 sums). The cp.async route runs N calls of each
case too, against its own first output: a card that flips bits shows
there as well.

``--mutants`` copies ``ext_spmm.cu`` into ``_archive/tma_stress/``
(gitignored) once per build below, compiles each copy alone (``nvcc``
sm_90a, ``-I csrc``, one process each, all started together), loads it
with ctypes and runs the cases through its TMA entry:

- ``shipped``: the file as it is (each consumer lane runs
  ``fence.proxy.async.shared::cta`` after its reads of a stage, before
  the warp's arrive frees the stage for the producer's next TMA write);
- ``no_fence``: without that fence;
- ``wait_sync_no_fence``: without the fence, with a ``__syncwarp()``
  after the wait on a full stage instead;
- ``apart``: the wait polled by each lane with a backoff of its own (a
  ``__nanosleep`` whose length depends on the lane), which moves the
  schedule; the fence kept;
- ``apart_no_fence``: the same backoff, without the fence.

For each build it writes the SASS of ``ext_tma_kernel<double, 128, 48>``
(the main case's instantiation, ``cuobjdump -sass``) beside the build
(``_archive/tma_stress/<build>/ext_spmm.sass``) and prints the
shared-memory loads, fences and the arrive on the empty barrier that end
the consumers' loop, each with the scoreboards it sets (``wb``) and waits on
(``wait``): an arrive that waits on no load's scoreboard is issued with
those loads outstanding.

Prints one line a case and build, the outputs that differ (call, rows,
columns, the largest relative error), and a JSON summary last. Exits 1 if
the shipped kernel (the package's own build, or ``shipped``) gave other
bits than the cp.async route on any call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
WORK = HERE / "_archive" / "tma_stress"

CASES = [("float64", 40, 5), *(("float64", m, 1) for m in (6, 12, 24, 80,
                                                        160)),
         *(("float32", m, 1) for m in (12, 40, 160)),
         *(("bfloat16", m, 1) for m in (24, 40, 160))]

# Lines of the consumers' loop in csrc/ext_spmm.cu, and what each build
# puts in their place.
WAIT = "      mbar_wait(full0 + 8u * s, phase);\n"
FENCE = ('      asm volatile("fence.proxy.async.shared::cta;\\n" ::: '
         '"memory");\n')
APART_WAIT = (
    "      {\n"
    "        uint32_t ok = 0;\n"
    "        while (!ok) {\n"
    "          asm volatile(\"{\\n .reg .pred p;\\n\"\n"
    "                       \" mbarrier.try_wait.parity.shared::cta.b64 p,"
    " [%1], %2;\\n\"\n"
    "                       \" selp.u32 %0, 1, 0, p;\\n}\\n\"\n"
    "                       : \"=r\"(ok) : \"r\"(full0 + 8u * s),"
    " \"r\"(phase) : \"memory\");\n"
    "          if (!ok) __nanosleep(32u * (lane & 7));\n"
    "        }\n"
    "      }\n")
BUILDS = {
    "shipped": [],
    "no_fence": [(FENCE, "")],
    "wait_sync_no_fence": [(FENCE, ""),
                           (WAIT, WAIT + "      __syncwarp();\n")],
    "apart": [(WAIT, APART_WAIT)],
    "apart_no_fence": [(WAIT, APART_WAIT), (FENCE, "")],
}
SASS_KERNEL = "ext_tma_kernelIdLi128ELi48E"


def _mutate(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"ext_spmm.cu: {old!r} is not there once")
        text = text.replace(old, new)
    return text


def build_mutants() -> dict:
    """Compile every build of ext_spmm.cu alone; name -> library path."""
    from fortran_davidson_tpu_torch.ops import kernels
    src = (kernels.CSRC / "ext_spmm.cu").read_text()
    nvcc = kernels._find_nvcc()
    jobs = {}
    for name, subs in BUILDS.items():
        d = WORK / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "ext_spmm.cu"
        cu.write_text(_mutate(src, subs))
        lib = d / f"libext_{name}.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", f"-I{kernels.CSRC}",
               "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on build {name}:\n{log}")
        libs[name] = lib
    return libs


def _instructions(sass: str) -> list:
    """(opcode text, write scoreboard, scoreboards waited on) of each SASS
    instruction: the control bits of Volta and later, bits 105-125 of the
    128-bit word (stall 4, yield 1, write barrier 3, read barrier 3, wait
    mask 6, reuse 4), 7 meaning no scoreboard."""
    lines = sass.splitlines()
    out = []
    for i, line in enumerate(lines[:-1]):
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(.*?)\s*;\s*/\* (0x[0-9a-f]+) \*/",
                     line)
        hi = re.search(r"/\* (0x[0-9a-f]+) \*/", lines[i + 1])
        if m and hi:
            word = int(hi.group(1), 16)
            out.append((m.group(1), (word >> 46) & 7,
                        [b for b in range(6) if (word >> 52) >> b & 1]))
    return out


def sass_report(name: str, lib: Path) -> dict:
    """Save the SASS of the main case's instantiation; return the loads,
    fences, warp syncs and arrive that end the consumers' loop (the last
    16 instructions up to the arrive on the empty barrier) with their
    scoreboards."""
    cuobjdump = next((c for c in ("cuobjdump", "/usr/local/cuda/bin/cuobjdump")
                      if shutil.which(c)), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(lib)], text=True,
                         capture_output=True, check=True)
    funcs = re.split(r"\n\s*Function : ", res.stdout)
    body = next((f for f in funcs if f.startswith("_Z")
                 and SASS_KERNEL in f.split("\n", 1)[0]), "")
    (lib.parent / "ext_spmm.sass").write_text(body)
    ins = _instructions(body)
    # The empty barriers sit 8 * kTmaMaxStages = 64 bytes after the full.
    end = next((i for i, (op, _, _) in enumerate(ins)
                if "SYNCS.ARRIVE" in op and "0x40]" in op), None)
    if end is None:
        return {"found": bool(body), "tail": None}
    keep = ("LDS", "FENCE", "SYNCS", "WARPSYNC", "MEMBAR", "DEPBAR")
    tail = [f"{op} wb={wb} wait={wait}" for op, wb, wait in
            ins[max(0, end - 16):end + 1] if any(k in op for k in keep)]
    return {"found": True, "tail": tail}


def _entry(lib, dtype):
    import torch
    sfx = {torch.float64: "f64", torch.float32: "f32",
           torch.bfloat16: "bf16"}[dtype]
    fn = getattr(lib, f"fdt_banded_ext_bsr_spmm_{sfx}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def _diff(y, want) -> str:
    import torch
    bad = (y != want) & ~(torch.isnan(y) & torch.isnan(want))
    rows = torch.nonzero(bad.any(dim=1)).flatten()
    cols = torch.nonzero(bad.any(dim=0)).flatten()
    rel = float(((y - want).abs()[bad]).max() / want.abs().max())
    tiles = sorted({int(r) // 16 for r in rows[:4096]})
    return (f"rows {int(rows[0])}-{int(rows[-1])} ({rows.numel()}, 16-row "
            f"tiles {tiles[:8]}{'...' if len(tiles) > 8 else ''}), cols "
            f"{int(cols[0])}-{int(cols[-1])}, max rel {rel:.3e}")


def stress(calls: int, libs: dict) -> dict:
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    A = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, coupling=1e-3,
                                 seed=0, device=dev)
    bw, bs, nbr = A.bandwidth, A.block_size, A.n_block_rows
    gen = torch.Generator(device=dev)
    loaded = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
    summary = {}
    for dname, m, weight in CASES:
        dtype = getattr(torch, dname)
        blocks = A.blocks.to(dtype)
        gen.manual_seed(m)
        x_ext = torch.randn(((nbr + 2 * bw) * bs, m), generator=gen,
                            device=dev).to(dtype)
        route = kernels.ext_spmm_route(dtype, bs, m, blocks.data_ptr(),
                                       x_ext.data_ptr())
        if route != "tma":
            raise RuntimeError(f"{dname} m={m} does not take the TMA route")
        n = calls * weight
        acc = kernels.acc_dtype(dtype)
        runs = {route: (lambda route=route: kernels.banded_ext_bsr_spmm_at(
            route, blocks, x_ext, bandwidth=bw, out_dtype=acc))
            for route in ("cp.async", "tma")}
        runs["package tma"] = runs.pop("tma")
        want = runs["cp.async"]()
        for name, lib in loaded.items():
            fn = _entry(lib, dtype)

            def run(fn=fn):
                y = torch.empty_like(want)
                err = fn(blocks.data_ptr(), x_ext.data_ptr(), y.data_ptr(),
                         nbr, bs, 2 * bw + 1, bw, m, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"build {name}: CUDA error {err}")
                return y
            runs[name] = run
        for name, run in runs.items():
            t0 = time.perf_counter()
            bad = []
            for i in range(n):
                y = run()
                if not torch.equal(y, want):
                    bad.append((i, _diff(y, want)))
            torch.cuda.synchronize()
            key = f"{dname} m={m} {name}"
            summary[key] = {"calls": n, "bad": len(bad)}
            print(f"{key}: bad {len(bad)}/{n} ({time.perf_counter() - t0:.1f}"
                  f" s){''.join(f'; call {i}: {d}' for i, d in bad[:5])}",
                  flush=True)
        del blocks, x_ext, want
        torch.cuda.empty_cache()
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200,
                    help="calls a case and build (5x at the main case)")
    ap.add_argument("--mutants", action="store_true",
                    help="also build and run the altered waits")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from fortran_davidson_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.build()
    libs, sass = {}, {}
    if args.mutants:
        libs = build_mutants()
        for name, lib in libs.items():
            sass[name] = sass_report(name, lib)
            print(f"SASS {name}: {json.dumps(sass[name])}", flush=True)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    summary = stress(args.calls, libs)
    shipped_bad = sum(v["bad"] for k, v in summary.items()
                      if k.endswith((" package tma", " shipped")))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "bad": {k: v["bad"] for k, v in summary.items()
                              if v["bad"]},
                      "calls": sum(v["calls"] for v in summary.values()),
                      "shipped_bad": shipped_bad,
                      "sass_tail": {k: v.get("tail")
                                    for k, v in sass.items()}}))
    return 1 if shipped_bad else 0


if __name__ == "__main__":
    sys.exit(main())
