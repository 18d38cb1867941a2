"""Row-locality audit and N-GPU scaling model of the row-sharded engine
(counterpart of ``fortran_davidson_tpu/parallel/scaling.py``).

The model rests on one property of a row-sharded Davidson iteration:
every heavy term (operator apply, corrections, projections, basis
updates) is row-local and scales 1/N, and the only traffic between ranks
is (a) the halo exchange of ``bandwidth * bs * w`` rows per operator
apply and (b) the all-reduces and all-gathers of width-scale partials
(Gram blocks, column sums, the double-single partials). Neither grows
with n, so the bytes of one iteration at a small n are the bytes of one
iteration at 10M rows, and with a measured one-device iteration time
they project the efficiency on N devices.

The JAX package reads the collectives out of the compiled HLO of the
sharded step. Here the collectives are explicit calls, and every one of
them is a method of :class:`~.mesh.RowMesh` (``all_reduce``,
``all_gather_rows``, ``ring_exchange``): :func:`record_collectives`
records each call while it is open, and :func:`probe_collectives` runs
one iteration of the sharded north-star program inside it. The record is
exact (the calls that ran, at their payloads) and per rank, at any world
size, 1 included: at world size 1 the exchange and the norms' all-reduce
move nothing, and are recorded as the calls N >= 2 ranks make (each
record says whether it moved). So one GPU takes the inventory of an
N-GPU solve. Two differences from the static HLO inventory: the port
runs at the iteration's active width, not at ``m_max`` (the probe also
returns the ``m_max`` ceiling of the Gram payloads, which is what the
JAX inventory counts), and GSPMD combines and pads collectives that the
port issues one by one.

The audits keep the JAX package's tests and texts: no single collective
may move an n-scale payload (:func:`audit_no_tall_collectives`), and the
inventories at two row counts must be byte-identical
(:func:`assert_n_independent`, the strong form). :func:`rule_report`
applies both to each sharding rule of ``parallel/sharded.py``: the halo
operators and the per-rank matrix-free rule are row-local; the rules that
all-gather x (dense, general BSR, ELL, sliced ELL, the hybrid's
remainder) are n-scale by design, and the report gives their bytes per
row.
"""

from __future__ import annotations

import contextlib
import json
import math
import sys
from typing import Optional

import torch

from fortran_davidson_tpu_torch.parallel import mesh as _mesh
from fortran_davidson_tpu_torch.parallel.mesh import RowMesh

# NVLink 4 of the H100 SXM: 900 GB/s a GPU, 450 GB/s in each direction
# (NVIDIA's data sheet; a published figure, not a measurement). A rank of
# the 1-D row ring sends its halos and partials over its own links, so the
# per-GPU rate in one direction is the denominator.
NVLINK_GBPS_PER_GPU = 450.0
# An assumed 10 us a collective call: no measurement stands behind it.
# ``chip_smoke.py`` passes the latency it measures on the card.
ASSUMED_LATENCY_S = 1e-5

# HLO's names of torch's dtypes, for the inventory's descriptions.
_HLO_DTYPE = {torch.float64: "f64", torch.float32: "f32",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}


@contextlib.contextmanager
def record_collectives():
    """Record every collective of the port inside the ``with`` block.

    Yields the list that each call of ``RowMesh.all_reduce``
    (``"all-reduce"``), ``RowMesh.all_gather_rows`` (``"all-gather"``)
    and ``RowMesh.ring_exchange`` (two ``"collective-permute"``, the two
    sends) appends a :class:`~.mesh.Collective` to, in call order; so do
    the all-reduce of the norms and the TSQR's gather that a one-rank
    mesh skips. Blocks nest; each sees every call made inside it.
    """
    records: list = []
    token = _mesh._INVENTORIES.set(_mesh._INVENTORIES.get() + (records,))
    try:
        yield records
    finally:
        _mesh._INVENTORIES.reset(token)


def _describe(rec) -> str:
    dims = ",".join(str(d) for d in rec.shape)
    return f"{_HLO_DTYPE.get(rec.dtype, str(rec.dtype))}[{dims}] {rec.kind}"


def collective_stats(records) -> dict:
    """Collective inventory of a list of records
    (:func:`record_collectives`).

    Returns the JAX package's keys: total bytes and count, per-kind
    (count, bytes), the largest calls and the largest single payload; and
    ``moved_bytes``, the bytes of the calls that crossed between ranks in
    this run (0 at world size 1).
    """
    kinds: dict = {}
    largest: list = []
    for rec in records:
        entry = kinds.setdefault(rec.kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += rec.bytes
        largest.append((rec.bytes, _describe(rec)))
    largest.sort(reverse=True)
    return {
        "total_bytes": sum(e["bytes"] for e in kinds.values()),
        "total_count": sum(e["count"] for e in kinds.values()),
        "by_kind": kinds,
        "largest": [f"{b}B {s}" for b, s in largest[:8]],
        "max_single_bytes": largest[0][0] if largest else 0,
        "moved_bytes": sum(rec.bytes for rec in records if rec.moved),
    }


def audit_no_tall_collectives(stats: dict, n_local: int, m_max: int,
                              itemsize: int = 4,
                              slack: float = 1.0) -> None:
    """Fail if any single collective moves an n-scale array.

    Threshold: one full local carry panel ``n_local * m_max * itemsize``
    (times ``slack``), floored at ``32 * m_max²`` elements so that
    width-scale payloads never trip it at the probe's small n. An
    all-gather of a tall array exceeds it at once; halos (bw·bs·w) and
    Gram blocks (m²) sit orders below at production scale. The rigorous
    guard against n-scaling is :func:`assert_n_independent`.
    """
    cap = max(slack * n_local * m_max * itemsize,
              32 * m_max * m_max * itemsize)
    if stats["max_single_bytes"] >= cap:
        raise AssertionError(
            f"compiled sharded program moves an n-scale collective: "
            f"{stats['largest'][:3]} (cap {cap:.0f}B) — the scaling "
            "model's row-locality assumption is violated")


def projected_efficiency(t_iter_1chip_s: float, collective_bytes: int,
                         collective_count: int, chips: int,
                         ici_gbps_per_chip: float = NVLINK_GBPS_PER_GPU,
                         latency_s: float = ASSUMED_LATENCY_S,
                         replicated_fraction: float = 0.0) -> dict:
    """Analytic scaling efficiency of an N-GPU row-sharded iteration.

    ``t_iter_1chip_s``: the measured one-device wall time of an iteration
    at the target shape. Work: a fraction ``1 - replicated_fraction``
    scales 1/N, ``replicated_fraction`` (the width-scale eigenproblem
    every rank solves) does not. Communication: ``collective_bytes`` per
    iteration at ``ici_gbps_per_chip`` GB/s (default: NVLink 4's
    published 450 GB/s a direction) plus ``latency_s`` per call (default:
    an assumed 10 us; pass a measured one). Efficiency = T1 / (N · TN).
    """
    local = t_iter_1chip_s * (1.0 - replicated_fraction) / chips
    repl = t_iter_1chip_s * replicated_fraction
    comm = (collective_bytes / (ici_gbps_per_chip * 1e9)
            + collective_count * latency_s)
    t_n = local + repl + comm
    return {
        "chips": chips,
        "t_iter_projected_s": t_n,
        "comm_s": comm,
        "efficiency": t_iter_1chip_s / (chips * t_n),
    }


def _ceiling_bytes(rec, width: int, m_max: int) -> int:
    """A width-scale payload's bytes with every dimension equal to the
    active width raised to ``m_max``; a halo's bytes as recorded."""
    if rec.kind == "collective-permute":
        return rec.bytes
    return math.prod(m_max if d == width else d
                     for d in rec.shape) * rec.dtype.itemsize


def iteration_inventory(matrix, mesh: RowMesh, lowest: int = 20,
                        **options) -> dict:
    """The collectives of one iteration of the sharded solve of
    ``matrix`` (``eigensolve_sharded``'s operator and options) on
    ``mesh``, recorded after the solve's initialisation.

    Returns :func:`collective_stats` and ``n``, ``n_local``, ``m_max``,
    ``n_devices``, ``width`` (the iteration's active width),
    ``m_max_ceiling_bytes`` (the Gram payloads at ``m_max``, the JAX
    package's static count), ``exchanges`` (ring exchanges, one per halo
    apply), ``launches`` (the kernels launched in the iteration, by
    wrapper; none on the CPU) and ``records``. Every rank of ``mesh``
    calls it.
    """
    from fortran_davidson_tpu_torch.config import merge_options
    from fortran_davidson_tpu_torch.core.loop import get_stepper
    from fortran_davidson_tpu_torch.ops import kernels
    from fortran_davidson_tpu_torch.parallel.sharded import prepare_sharded

    opts = merge_options(None, options)
    A, _, cfg, rows = prepare_sharded(matrix, lowest, mesh, None, mesh.axis,
                                      opts)
    init, step = get_stepper(cfg, rows)
    st = init(A, None)
    A_off = A.offdiag() if cfg.refined else None
    width = int(st["m_hi"])
    st["chunk_end"] = st["it"] + 1
    before = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    with record_collectives() as records:
        step(A, None, st, A_off=A_off)
    launches = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in kernels.KERNELS}
    if st["it"] != 1:
        raise AssertionError(f"the probe ran {st['it']} iterations, not 1 "
                             "(converged at the initial subspace?)")
    stats = collective_stats(records)
    n = A.shape[0]
    stats.update(
        n=n, n_local=n // mesh.size, m_max=cfg.m_max, n_devices=mesh.size,
        width=width, itemsize=torch.empty((), dtype=getattr(
            torch, cfg.dtype)).element_size(),
        m_max_ceiling_bytes=sum(_ceiling_bytes(r, width, cfg.m_max)
                                for r in records),
        exchanges=sum(r.kind == "collective-permute" for r in records) // 2,
        launches={name: c for name, c in launches.items() if c},
        records=records)
    return stats


def probe_options(max_dim_sub: int = 44, refined: bool = True) -> dict:
    """The options of the probe's solve: the JAX probe's
    (``fortran_davidson_tpu/parallel/scaling.py:198-203``)."""
    return dict(method="DPR", tolerance=1e-8, relative_tolerance=True,
                dtype="float32", expansion="lowest-k",
                max_dim_sub=max_dim_sub, refined=refined,
                final_polish=3 if refined else 0, max_iterations=120)


def probe_collectives(mesh: RowMesh, nbr: int = 128, bs: int = 128,
                      k: int = 20, max_dim_sub: int = 44,
                      refined: bool = True) -> dict:
    """The inventory of one iteration of the sharded north-star program
    (the counterpart of ``probe_compiled_collectives``): the int8 halo
    operator of ``generate_banded_bsr_quantized(nbr, bs, bandwidth=1,
    coupling=1e-3)`` on ``mesh`` (kernel 7 on a GPU, its plain version on
    the CPU), lowest-``k``, float32, refined as in the JAX probe. Runs on
    any mesh (gloo on the CPU, NCCL on GPUs); every rank calls it. See
    :func:`iteration_inventory` for the keys.
    """
    from fortran_davidson_tpu_torch.ops.sparse import \
        generate_banded_bsr_quantized
    op = generate_banded_bsr_quantized(nbr, bs, bandwidth=1, coupling=1e-3,
                                       device=mesh.device)
    return iteration_inventory(op, mesh, k,
                               **probe_options(max_dim_sub, refined))


def assert_n_independent(stats_small: dict, stats_large: dict) -> None:
    """Require byte-identical collective inventories at two row counts:
    if doubling n moves a single extra byte between ranks, a tall array
    crosses them and the 1/N work model is wrong."""
    a, b = stats_small, stats_large
    if (a["total_bytes"], a["total_count"]) != (b["total_bytes"],
                                               b["total_count"]):
        raise AssertionError(
            "collective traffic scales with n: "
            f"n={a['n']}: {a['total_bytes']}B/{a['total_count']} ops vs "
            f"n={b['n']}: {b['total_bytes']}B/{b['total_count']} ops; "
            f"largest at large n: {b['largest'][:3]}")


def rule_report(rule: str, small, large, mesh: RowMesh, row_local: bool,
                lowest: int = 20, **options) -> dict:
    """One iteration's inventory of a sharding rule at two row counts
    (``small`` and ``large``, operators of the same kind), judged by both
    audits (the tall one at the solve's itemsize).

    ``row_local`` is the verdict the rule must get: True for the halo
    operators and the per-rank matrix-free rule, False for the rules
    that all-gather x. A rule that gets the other verdict raises
    ``AssertionError``. Returns the verdict, the audit's text where it
    failed, the inventory of each row count by kind, and ``bytes_per_row``,
    the growth of the per-iteration bytes with n (0 where row-local).
    """
    a = iteration_inventory(small, mesh, lowest, **options)
    b = iteration_inventory(large, mesh, lowest, **options)
    failure = None
    try:
        assert_n_independent(a, b)
        audit_no_tall_collectives(a, a["n_local"], a["m_max"], a["itemsize"])
    except AssertionError as err:
        failure = str(err)
    report = {
        "rule": rule, "n": [a["n"], b["n"]], "row_local": failure is None,
        "failure": failure, "width": a["width"], "m_max": a["m_max"],
        "by_kind": [a["by_kind"], b["by_kind"]],
        "total_bytes": [a["total_bytes"], b["total_bytes"]],
        "bytes_per_row": (b["total_bytes"] - a["total_bytes"])
        / (b["n"] - a["n"]),
        "total_count": [a["total_count"], b["total_count"]],
        "exchanges": [a["exchanges"], b["exchanges"]],
        "launches": [a["launches"], b["launches"]],
    }
    if report["row_local"] != row_local:
        raise AssertionError(
            f"sharding rule {rule!r}: expected "
            f"{'row-local' if row_local else 'n-scale'}, the audit says "
            f"{'row-local' if failure is None else failure}")
    return report


def scaling_model(t_iter_1chip_s: float, mesh: RowMesh, chips=(2, 4, 8),
                  ici_gbps_per_chip: float = NVLINK_GBPS_PER_GPU,
                  latency_s: float = ASSUMED_LATENCY_S,
                  probe_kwargs: Optional[dict] = None) -> dict:
    """Probe inventory + measured one-device iteration time -> projected
    efficiency per GPU count.

    Probes the sharded north-star program at ``nbr`` and ``2 * nbr``
    block rows on ``mesh``, requires n-independence and no tall
    collective, then projects at ``ici_gbps_per_chip`` (NVLink 4's
    published rate a direction) and ``latency_s`` per call.
    """
    kw = dict(probe_kwargs or {})
    nbr = int(kw.pop("nbr", 128))
    small = probe_collectives(mesh, nbr=nbr, **kw)
    large = probe_collectives(mesh, nbr=2 * nbr, **kw)
    assert_n_independent(small, large)
    audit_no_tall_collectives(small, small["n_local"], small["m_max"])
    out = {
        "per_iter_collective_bytes": small["total_bytes"],
        "per_iter_collective_count": small["total_count"],
        "by_kind": small["by_kind"],
        "max_single_bytes": small["max_single_bytes"],
        "m_max_ceiling_bytes": small["m_max_ceiling_bytes"],
        "n_independent": True,
        "probe_n": [small["n"], large["n"]],
        "n_devices": mesh.size,
        "t_iter_1chip_s": t_iter_1chip_s,
        "ici_gbps_per_chip": ici_gbps_per_chip,
        "latency_s": latency_s,
        "projections": [
            projected_efficiency(t_iter_1chip_s, small["total_bytes"],
                                 small["total_count"], c,
                                 ici_gbps_per_chip=ici_gbps_per_chip,
                                 latency_s=latency_s)
            for c in chips
        ],
    }
    out["min_efficiency"] = min(p["efficiency"]
                                for p in out["projections"])
    return out


def main(argv=None) -> int:  # pragma: no cover - a command on the card
    """``python -m fortran_davidson_tpu_torch.parallel.scaling JSON``:
    :func:`scaling_model` on the launcher's group under ``torchrun``, else
    on a one-rank group of the card; rank 0 prints one JSON line. JSON
    keys: ``t_iter_1chip_s`` (required: a measured one-device iteration
    time), ``chips``, ``latency_s``, ``ici_gbps_per_chip``,
    ``probe_kwargs``."""
    import torch.distributed as dist

    from fortran_davidson_tpu_torch.parallel import multihost
    argv = sys.argv[1:] if argv is None else argv
    kwargs = json.loads(argv[0]) if argv else {}
    if "t_iter_1chip_s" not in kwargs:
        print('scaling: pass \'{"t_iter_1chip_s": <measured seconds>}\'',
              file=sys.stderr)
        return 2
    t_iter = float(kwargs.pop("t_iter_1chip_s"))
    mesh = multihost.initialize()
    try:
        out = scaling_model(t_iter, mesh, **kwargs)
    finally:
        dist.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
