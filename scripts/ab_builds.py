#!/usr/bin/env python3
"""Two builds of the port's kernels on one GPU, side by side: ptxas's
registers of every kernel instantiation, and the bits that the public
kernel wrappers give on the same seeded inputs.

    git archive <parent> | tar -x -C _archive/parent
    python3 scripts/ab_builds.py --parent _archive/parent \\
        [--rename 'REGEX=>REPLACEMENT' ...] [--hold REGEX ...] \\
        [--hold-bits PREFIX ...] [--time]

Each tree is built and run in a process of its own (``--worker``), with
that tree first on ``sys.path``, so each imports its own
``fortran_davidson_tpu_torch``; the ptxas reports go to
``chiprun_out/ab/``, the outputs to ``_archive/ab/`` (gitignored).
Each tree is built afresh, into ``_archive/ab/<tag>_build``.

An instantiation's key is its demangled name without the parameter list
(``cu++filt`` or ``c++filt``; without either, the mangled name with the
anonymous namespaces' hashes blanked). Keys are matched by equality. When
a change renames instantiations (a new template argument, an enum value
that moved), each ``--rename`` is a ``re.sub`` applied in order to the
parent's keys: the mapping belongs to the run, not to this script.

With ``--time``, the full-size cases of :func:`_timed_cases` are then
timed in both trees in turns (parent, change, change, parent; each a
process of its own on the build above; CUDA events, median of 7 after a
warm-up), and the times join the summary.

Prints each instantiation whose registers differ or that one build lacks,
each output whose bits differ or that one tree cannot make, and a JSON
summary. Exits 1 if a key that matches a ``--hold`` regex in the parent
moved or is missing in the change, or an output whose label starts with a
``--hold-bits`` prefix differs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "chiprun_out" / "ab"
BULK = HERE / "_archive" / "ab"


# Kernel 1's measurement variants (kernels.banded_spmm_variant): "copy" in
# every type and bs, the rest in float64 and bf16 at bs > 16.
_K1_VARIANTS = (
    ("copy", {}), ("noy", {}), ("writeonly", {}),
    ("full", {"rows_per_cta": 2}), ("full", {"rows_per_cta": 4}),
    ("full", {"store": "tma"}), ("full", {"block_policy": "evict_first"}),
    ("full", {"stages": 3}),
)


def _permuted(cols, blocks, seed):
    """P A Pᵀ of a block-ELL table, for a permutation p of the block rows
    seeded by ``seed``: block row p[r] takes row r's slabs, its columns
    p[cols[r, k]]. Returns (p, columns, blocks)."""
    import torch
    gen = torch.Generator(device=blocks.device).manual_seed(seed)
    nbr = blocks.shape[0]
    p = torch.randperm(nbr, generator=gen, device=blocks.device)
    pcols = torch.empty_like(cols)
    pcols[p] = p[cols.long()].to(cols.dtype)
    pblocks = torch.empty_like(blocks)
    pblocks[p] = blocks
    return p, pcols, pblocks


def _cases():
    """(label, fn) pairs over the public wrappers of kernels 1-8 (kernel 2
    also on a block-permuted table) and the measurement variants of kernels
    1 and 5; each fn returns the outputs to compare (a tensor or a tuple of
    them). Inputs are made on the card from fixed seeds."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels as k

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)

    def randn(rows, cols, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn((rows, cols), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    A = fdtt.generate_banded_bsr(512, 128, bandwidth=1, seed=0, device=dev)
    rag = fdtt.generate_banded_bsr(37, 24, bandwidth=3, seed=1, device=dev)
    q = fdtt.generate_banded_bsr_quantized(512, 128, bandwidth=1, seed=0,
                                           device=dev)
    ql = (q.qblocks, q.scale_rows, q.diag)
    out = []
    for op, tag in ((A, "bs128"), (rag, "bs24")):
        bw, n, bs = op.bandwidth, op.shape[0], op.block_size
        halo = bw * bs
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            b = op.blocks.to(dtype)
            acc = k.acc_dtype(dtype)
            for m in (6, 20, 48, 64, 320):
                x = randn(n, m, dtype, m)
                out.append((f"k1 {tag} {dtype} m={m}",
                            lambda b=b, x=x, bw=bw, acc=acc:
                            k.banded_bsr_spmm(b, x, bw, out_dtype=acc)))
                if m not in (20, 48):
                    continue
                xe = randn(n + 2 * halo, m, dtype, m + 1)
                out.append((f"k6 {tag} {dtype} m={m}",
                            lambda b=b, xe=xe, bw=bw, acc=acc:
                            k.banded_ext_bsr_spmm(b, xe, bandwidth=bw,
                                                  out_dtype=acc)))
                out.append((f"k8 {tag} {dtype} m={m}",
                            lambda b=b, xe=xe, bw=bw, h=halo, acc=acc:
                            k.banded_remote_halo_spmm(
                                b, xe[h:-h], xe[:h], xe[-h:], bandwidth=bw,
                                out_dtype=acc)))
                out.append((f"k2 {tag} {dtype} m={m}",
                            lambda b=b, x=x, acc=acc, c=op.block_cols:
                            k.bsr_spmm(c, b, x, out_dtype=acc)))
                perm, pcols, pblocks = _permuted(op.block_cols, b, m)
                xp = x.reshape(-1, bs, m)[perm.argsort()].reshape(n, m)
                out.append((f"k2 permuted {tag} {dtype} m={m}",
                            lambda b=pblocks, x=xp, acc=acc, c=pcols:
                            k.bsr_spmm(c, b, x, out_dtype=acc)))
                for variant, opts in _K1_VARIANTS:
                    if variant != "copy" and (dtype == torch.float32
                                              or bs <= 16):
                        continue
                    out.append((f"k1v {variant} {opts} {tag} {dtype} m={m}",
                                lambda b=b, x=x, bw=bw, v=variant, o=opts:
                                k.banded_spmm_variant(b, x, bw, variant=v,
                                                      **o)))
    A32 = A.blocks.float()
    for m, mv in ((20, 220), (128, 1408), (40, None)):
        x = randn(q.shape[0], m, torch.float32, 100 + m)
        v = None if mv is None else randn(q.shape[0], mv, torch.float32,
                                          200 + m)
        out.append((f"k5 int8 m={m} mv={mv}",
                    lambda x=x, v=v: k.banded_q_bsr_spmm_gram(*ql, x, v,
                                                              bandwidth=1)))
        out.append((f"k3 f32 m={m} mv={mv}",
                    lambda x=x, v=v: k.banded_bsr_spmm_gram(A32, x, v,
                                                            bandwidth=1)))
        for variant in ("nov", "nogram", "bf16deq", "tg_bf16deq",
                        "nov_bf16"):
            bf16 = variant.endswith("bf16deq") or variant == "nov_bf16"
            xv = x.to(torch.bfloat16) if bf16 else x
            vv = (None if variant == "nov_bf16" or v is None
                  else v.to(xv.dtype))
            if vv is None and variant != "nov_bf16":
                continue
            out.append((f"k5 {variant} m={m} mv={mv}",
                        lambda xv=xv, vv=vv, var=variant:
                        k.fused_gram_variant("banded_q_bsr_spmm_gram", ql,
                                             xv, vv, bandwidth=1,
                                             variant=var)))
    for m in (20, 40):
        for dtype in (torch.float32, torch.float64):
            x = randn(q.shape[0], m, dtype, 300 + m)
            out.append((f"k4 {dtype} m={m}",
                        lambda x=x: k.banded_q_bsr_spmm(*ql, x, 1)))
        xe = randn(q.shape[0] + 256, m, torch.float32, 400 + m)
        out.append((f"k7 f32 m={m}",
                    lambda xe=xe: k.banded_q_ext_bsr_spmm(*ql, xe,
                                                          bandwidth=1)))
        # Float64 x on kernels 5 and 7, kernel 3 in float64 and bf16.
        xe = xe.double()
        out.append((f"k7 f64 m={m}",
                    lambda xe=xe: k.banded_q_ext_bsr_spmm(*ql, xe,
                                                          bandwidth=1)))
        x = randn(q.shape[0], m, torch.float64, 500 + m)
        v = randn(q.shape[0], 220, torch.float64, 600 + m)
        out.append((f"k5 f64 m={m} mv=220",
                    lambda x=x, v=v: k.banded_q_bsr_spmm_gram(*ql, x, v,
                                                              bandwidth=1)))
        for dtype in (torch.float64, torch.bfloat16):
            x = randn(A.shape[0], m, dtype, 700 + m)
            v = randn(A.shape[0], 220, dtype, 800 + m)
            for mv, vv in ((None, None), (220, v)):
                out.append((f"k3 {dtype} m={m} mv={mv}",
                            lambda b=A.blocks.to(dtype), x=x, vv=vv:
                            k.banded_bsr_spmm_gram(b, x, vv, bandwidth=1)))
    return out


def _timed_cases():
    """(label, fn) pairs timed with ``--time``: the float64-x entries of
    kernels 4 and 7 on the 2M-row int8 matrix of the solves at the
    lowest-20 widths (kernel 7 over the one shard's ring-wrapped x_ext),
    kernel 5's float64-x entry there at mv = 220 (row 5d), kernel 3's bf16
    and float64 entries at row 3's shape (the 1M-row matrix, m = 128,
    mv = 1408), and kernel 5's bf16-dequant variants at the probe's shape
    (int8, nbr 4096, bs 128, bw 2, m = mv = 256; rows 10a-c)."""
    import torch
    import fortran_davidson_tpu_torch as fdtt
    from fortran_davidson_tpu_torch.ops import kernels as k

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(900)
    q = fdtt.generate_banded_bsr_quantized(16384, 128, bandwidth=1, seed=0,
                                           device=dev)
    ql = (q.qblocks, q.scale_rows, q.diag)
    out = []
    for m in (20, 40):
        x = torch.randn((q.shape[0], m), generator=gen, device=dev,
                        dtype=torch.float64)
        xe = torch.cat([x[-128:], x, x[:128]])
        out.append((f"k4 f64 m={m} nbr=16384",
                    lambda x=x: k.banded_q_bsr_spmm(*ql, x, 1)))
        out.append((f"k7 f64 m={m} nbr=16384",
                    lambda xe=xe: k.banded_q_ext_bsr_spmm(*ql, xe,
                                                          bandwidth=1)))
    v = torch.randn((q.shape[0], 220), generator=gen, device=dev,
                    dtype=torch.float64)
    x = torch.randn((q.shape[0], 20), generator=gen, device=dev,
                    dtype=torch.float64)
    out.append(("k5 f64 m=20 mv=220 nbr=16384",
                lambda x=x, v=v: k.banded_q_bsr_spmm_gram(*ql, x, v,
                                                          bandwidth=1)))
    A = fdtt.generate_banded_bsr(8192, 128, bandwidth=1, seed=0, device=dev)
    for dtype in (torch.bfloat16, torch.float64):
        b = A.blocks.to(dtype)
        x = torch.randn((A.shape[0], 128), generator=gen, device=dev).to(dtype)
        v = torch.randn((A.shape[0], 1408), generator=gen,
                        device=dev).to(dtype)
        out.append((f"k3 {dtype} m=128 mv=1408 nbr=8192",
                    lambda b=b, x=x, v=v: k.banded_bsr_spmm_gram(
                        b, x, v, bandwidth=1)))
    qp = fdtt.generate_banded_bsr_quantized(4096, 128, bandwidth=2, seed=0,
                                            device=dev)
    lead = (qp.qblocks, qp.scale_rows, qp.diag)
    x = torch.randn((qp.shape[0], 256), generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((qp.shape[0], 256), generator=gen,
                    device=dev).to(torch.bfloat16)
    for variant in ("bf16deq", "tg_bf16deq", "nov_bf16"):
        out.append((f"k5 {variant} m=256 mv=256 nbr=4096",
                    lambda var=variant: k.fused_gram_variant(
                        "banded_q_bsr_spmm_gram", lead, x,
                        None if var == "nov_bf16" else v, bandwidth=2,
                        variant=var)))
    return out


def time_worker(tag: str, turn: int) -> int:
    """Time :func:`_timed_cases` on this tree's build (made by
    :func:`worker`); saves label -> ms."""
    import statistics
    import torch
    from fortran_davidson_tpu_torch.ops import kernels as k
    k.BUILD_DIR = BULK / f"{tag}_build"
    times = {}
    for label, fn in _timed_cases():
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        times[label] = statistics.median(runs)
    (BULK / f"{tag}.time{turn}.json").write_text(json.dumps(times))
    print(f"{tag} turn {turn}: {times}", flush=True)
    return 0


def worker(tag: str) -> int:
    """Build this process's tree, save its ptxas report and its outputs
    (an output this tree cannot make is saved as None)."""
    import torch
    from fortran_davidson_tpu_torch.ops import kernels as k
    OUT.mkdir(parents=True, exist_ok=True)
    BULK.mkdir(parents=True, exist_ok=True)
    # A fresh build, so that ptxas reports every instantiation.
    k.BUILD_DIR = BULK / f"{tag}_build"
    shutil.rmtree(k.BUILD_DIR, ignore_errors=True)
    _, log = k.build()
    (OUT / f"{tag}.ptxas.log").write_text(log)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for label, fn in _cases():
        try:
            y = fn()
        except (AttributeError, ValueError, NotImplementedError,
                RuntimeError) as err:
            print(f"{tag}: {label}: {type(err).__name__}: {err}", flush=True)
            results[label] = None
            continue
        results[label] = tuple(t.cpu() for t in (y if isinstance(y, tuple)
                                                 else (y,)))
    torch.cuda.synchronize()
    torch.save(results, BULK / f"{tag}.pt")
    print(f"{tag}: {k.library_path().name}, {len(results)} outputs",
          flush=True)
    return 0


def _demangler():
    for tool in ("cu++filt", "c++filt"):
        path = shutil.which(tool) or shutil.which(
            str(Path("/usr/local/cuda/bin") / tool))
        if path:
            return path
    return None


def _strip_params(name: str) -> str:
    """A demangled ``void f<...>(params)`` as ``f<...>``: the last
    top-level parenthesised group is the parameter list (``(anonymous
    namespace)`` stays)."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name).strip()


def registers(log: str) -> dict:
    """Key -> registers, for every kernel in a ptxas report."""
    pairs, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            pairs.append((name, int(m.group(1))))
            name = None
    names = [n for n, _ in pairs]
    tool = _demangler()
    if tool:
        res = subprocess.run([tool], input="\n".join(names), text=True,
                             capture_output=True, check=True)
        keys = [_strip_params(k) for k in res.stdout.splitlines()]
    else:
        keys = [re.sub(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}",
                       r"\g<1>00000000\g<2>00000000", n) for n in names]
    return {key: regs for key, (_, regs) in zip(keys, pairs)}


def compare(parent: Path, renames, hold, hold_bits, timed) -> int:
    import torch
    env = dict(os.environ)
    trees = {"parent": parent.resolve(), "change": HERE}
    for tag, tree in trees.items():
        env["PYTHONPATH"] = str(tree)
        res = subprocess.run([sys.executable, __file__, "--worker", tag],
                             env=env, cwd=tree, check=False)
        if res.returncode != 0:
            print(f"{tag} worker failed ({res.returncode})", flush=True)
            return 2
    times = {}
    if timed:
        for turn, tag in enumerate(("parent", "change", "change", "parent")):
            env["PYTHONPATH"] = str(trees[tag])
            res = subprocess.run([sys.executable, __file__, "--time-worker",
                                  f"{tag}:{turn}"], env=env, cwd=trees[tag],
                                 check=False)
            if res.returncode != 0:
                print(f"{tag} time worker failed ({res.returncode})",
                      flush=True)
                return 2
            got = json.loads((BULK / f"{tag}.time{turn}.json").read_text())
            for label, ms in got.items():
                times.setdefault(label, {}).setdefault(tag, []).append(ms)
    change = registers((OUT / "change.ptxas.log").read_text())
    parent_regs = {}
    for key, n in registers((OUT / "parent.ptxas.log").read_text()).items():
        for pattern, repl in renames:
            key = re.sub(pattern, repl, key)
        parent_regs[key] = n
    moved, same_regs = [], 0
    for key in sorted(set(parent_regs) | set(change)):
        a, b = parent_regs.get(key), change.get(key)
        if a == b:
            same_regs += 1
            continue
        print(f"  registers {key}: parent {a}, change {b}")
        if a is not None and any(re.search(h, key) for h in hold):
            moved.append(key)
    outs = {tag: torch.load(BULK / f"{tag}.pt") for tag in ("parent", "change")}
    same_bits, diff, one_side = 0, [], []
    for label in sorted(set(outs["parent"]) | set(outs["change"])):
        pa, ch = outs["parent"].get(label), outs["change"].get(label)
        if pa is None or ch is None:
            one_side.append(label)
            print(f"  only one tree makes: {label} "
                  f"(parent {pa is not None}, change {ch is not None})")
            continue
        if all(torch.equal(x, y) for x, y in zip(pa, ch)):
            same_bits += 1
            continue
        err = max(float((x.double() - y.double()).abs().max())
                  for x, y in zip(pa, ch))
        print(f"  bits differ: {label} (max abs diff {err:.3e})")
        diff.append(label)
    held = [d for d in diff if d.startswith(tuple(hold_bits))]
    print(json.dumps(dict(registers_same=same_regs, held_registers_moved=moved,
                          outputs_same_bits=same_bits, outputs_differ=diff,
                          held_outputs_differ=held,
                          outputs_in_one_tree=one_side,
                          times_ms_in_turns=times)), flush=True)
    return 1 if moved or held else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--rename", action="append", default=[],
                    metavar="REGEX=>REPLACEMENT",
                    help="re.sub applied to the parent's keys, in order")
    ap.add_argument("--hold", action="append", default=[], metavar="REGEX",
                    help="keys whose registers must not move")
    ap.add_argument("--hold-bits", action="append", default=[],
                    metavar="PREFIX",
                    help="output labels whose bits must not move")
    ap.add_argument("--time", action="store_true",
                    help="also time the full-size cases in turns")
    ap.add_argument("--worker", choices=("parent", "change"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time-worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    if args.time_worker:
        tag, turn = args.time_worker.split(":")
        return time_worker(tag, int(turn))
    if args.parent is None:
        ap.error("--parent is required")
    renames = []
    for spec in args.rename:
        pattern, sep, repl = spec.partition("=>")
        if not sep:
            ap.error(f"--rename {spec!r}: expected REGEX=>REPLACEMENT")
        renames.append((pattern, repl))
    return compare(args.parent, renames, args.hold, args.hold_bits,
                   args.time)


if __name__ == "__main__":
    sys.exit(main())
