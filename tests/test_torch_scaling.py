"""The port's scaling audit (``fortran_davidson_tpu_torch/parallel/
scaling.py``), ``utils.ds.sum_strategy`` and the ``utils`` exports
against the JAX package, on the CPU.

- The inventory of recorded calls equal to ``tests/test_scaling_model.py``'s
  HLO text gives the JAX parser's totals; the audits and the projection
  give the JAX package's results and error texts on the same arguments
  (every unit case of its ``TestAudits`` and ``TestProjection``).
- The recorder: every collective of ``RowMesh`` inside the block, none
  outside, the two sends of a one-rank ring exchange and the norms'
  all-reduce it skips as not moved.
- On a one-rank gloo group in this process: the per-rule report (the
  halo operators, the int8 halo operator and the matrix-free surrogate
  row-local; dense, general BSR, ELL, sliced ELL and the hybrid n-scale)
  and the scaling model. The probes at world sizes 1, 2 and 4 run in the
  spawns of ``tests/test_torch_parallel.py``.
- ``sum_strategy``: unknown names raise; ``"tree"`` folds a tall block as
  a sharded rank does and leaves the default untouched outside its
  block; a refined float32 solve past the cascade's threshold under each
  strategy stays within ±1 iteration and the tolerance of the JAX
  package's solve with the same fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fortran_davidson_tpu as fdt
import fortran_davidson_tpu.utils as jutils
from fortran_davidson_tpu.utils import ds as jds
from fortran_davidson_tpu import parallel as jpar
from fortran_davidson_tpu.models import generators as jgen
from fortran_davidson_tpu.parallel import scaling as jscaling
import fortran_davidson_tpu_torch as fdtt
import fortran_davidson_tpu_torch.utils as tutils
from fortran_davidson_tpu_torch.core.rows import Rows
from fortran_davidson_tpu_torch.models import generators as tgen
from fortran_davidson_tpu_torch.ops import sparse as tsparse
from fortran_davidson_tpu_torch.parallel import (HaloBSROperator, RowMesh,
                                                 RowShardConstraint,
                                                 multihost, scaling)
from fortran_davidson_tpu_torch.parallel import mesh as tmesh
from fortran_davidson_tpu_torch.utils import ds as tds
from tests.test_scaling_model import _HLO

CPU = torch.device("cpu")


def _hlo_records() -> list:
    """The calls of ``_HLO``, recorded: one all-reduce f32[44,44], a
    permute f32[128,64] and an async one f32[32,64]."""
    with scaling.record_collectives() as records:
        for kind, shape in (("all-reduce", (44, 44)),
                            ("collective-permute", (128, 64)),
                            ("collective-permute", (32, 64))):
            tmesh._record(kind, torch.float32, shape, True)
    return records


def test_collective_stats_match_the_hlo_parser():
    got = scaling.collective_stats(_hlo_records())
    want = jscaling.collective_stats(_HLO)
    for key in ("total_bytes", "total_count", "by_kind", "max_single_bytes"):
        assert got[key] == want[key], key
    assert got["largest"] == want["largest"]
    assert scaling.collective_stats([])["total_count"] == 0


def _audit_cases():
    s = jscaling.collective_stats(_HLO)
    big = dict(s, n=1000)
    return {
        # TestAudits: the cap below the 32 KB permute, and above it.
        "tall_fails": lambda m: m.audit_no_tall_collectives(
            s, n_local=64, m_max=16, itemsize=4),
        "small_pass": lambda m: m.audit_no_tall_collectives(
            s, n_local=4096, m_max=64, itemsize=4),
        "n_mismatch": lambda m: m.assert_n_independent(
            big, dict(big, total_bytes=big["total_bytes"] * 2, n=2000)),
        "n_identical": lambda m: m.assert_n_independent(big,
                                                        dict(big, n=2000)),
    }


@pytest.mark.parametrize("case", list(_audit_cases()))
def test_audits_match_jax(case):
    run = _audit_cases()[case]
    outcomes = []
    for module in (jscaling, scaling):
        try:
            run(module)
            outcomes.append(None)
        except AssertionError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case in ("small_pass", "n_identical"))


# TestProjection's cases, the rate and the latency stated: (t_iter, bytes,
# count, chips, latency, replicated_fraction).
PROJECTIONS = {
    "zero_comm": [(0.08, 0, 0, 8, 0.0, 0.0)],
    "monotone": [(0.08, 10_000_000, 100, c, 1e-6, 0.0) for c in (2, 4, 8, 16)],
    "replicated": [(0.1, 0, 0, 10, 0.0, 0.5)],
}


@pytest.mark.parametrize("case", list(PROJECTIONS))
def test_projection_matches_jax(case):
    effs = []
    for t, b, count, chips, lat, frac in PROJECTIONS[case]:
        kw = dict(ici_gbps_per_chip=100.0, latency_s=lat,
                  replicated_fraction=frac)
        got = scaling.projected_efficiency(t, b, count, chips, **kw)
        want = jscaling.projected_efficiency(t, b, count, chips, **kw)
        assert got.keys() == want.keys() and got["chips"] == want["chips"]
        for key in ("t_iter_projected_s", "comm_s", "efficiency"):
            assert abs(got[key] - want[key]) <= 1e-15, key
        effs.append(got["efficiency"])
    if case == "monotone":
        assert effs == sorted(effs, reverse=True)
        assert all(0 < e < 1 for e in effs)
    # The port's defaults: NVLink 4's published rate, an assumed latency.
    d = scaling.projected_efficiency(0.08, 10**9, 0, 2)
    assert d["comm_s"] == pytest.approx(10**9 / 450e9)


def test_recorder_sees_every_collective_in_its_block():
    mesh = RowMesh(group=None, size=1, rank=0, device=CPU)
    x = torch.zeros((64, 3), dtype=torch.float64)
    mesh.ring_exchange(x, 8)
    with scaling.record_collectives() as outer:
        mesh.ring_exchange(x, 8)
        with scaling.record_collectives() as inner:
            RowShardConstraint(mesh, 64).norms(x)
    assert [(r.kind, r.shape, r.bytes, r.moved) for r in outer] == [
        ("collective-permute", (8, 3), 192, False),
        ("collective-permute", (8, 3), 192, False),
        ("all-reduce", (3,), 24, False)]
    assert inner == outer[2:]
    mesh.ring_exchange(x, 8)
    assert len(outer) == 3
    assert scaling.collective_stats(outer)["moved_bytes"] == 0


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process (no spawn), torn down after."""
    assert not dist.is_initialized()
    mesh = multihost.initialize(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _bsr(nbr):
    return fdtt.generate_banded_bsr(nbr, 32, bandwidth=1, coupling=1e-3,
                                    seed=0, device="cpu")


def _coo(n):
    return (*tsparse.generate_local_sparse(n, 6, locality=20.0, seed=41), n)


F64 = dict(method="DPR", tolerance=1e-8, expansion="lowest-k", max_dim_sub=44)
PROBE = scaling.probe_options()
# name -> (build at nbr block rows of 32, row-local, options).
RULES = {
    "halo pallas": (lambda nbr, mesh: HaloBSROperator.from_bsr(
        _bsr(nbr), 1, mesh, backend="pallas"), True, F64),
    "halo pallas-remote": (lambda nbr, mesh: HaloBSROperator.from_bsr(
        _bsr(nbr), 1, mesh, backend="pallas-remote"), True, F64),
    "halo int8": (lambda nbr, mesh: fdtt.generate_banded_bsr_quantized(
        nbr, 32, device="cpu"), True, PROBE),
    "matrix-free": (lambda nbr, mesh: tgen.surrogate_hamiltonian(
        nbr * 32, dtype=torch.float32, device="cpu"), True, PROBE),
    "dense": (lambda nbr, mesh: _bsr(nbr).to_dense(), False, F64),
    "bsr": (lambda nbr, mesh: _bsr(nbr), False, F64),
    "ell": (lambda nbr, mesh: fdtt.ELLOperator.from_coo(
        *_coo(nbr * 32), device="cpu"), False, F64),
    "sell": (lambda nbr, mesh: fdtt.SlicedELLOperator.from_coo(
        *_coo(nbr * 32), device="cpu"), False, F64),
    "hybrid": (lambda nbr, mesh: fdtt.split_band_remainder(
        *_coo(nbr * 32), block_size=16, bandwidth=1, device="cpu"),
        False, F64),
}


def test_rule_report(one_rank):
    # Row-local rules: no byte more at twice the rows. The gathering rules:
    # one all-gather of the (n, k) block an apply, k * itemsize bytes a row.
    for rule, (build, local, opts) in RULES.items():
        rep = scaling.rule_report(rule, build(64, one_rank),
                                  build(128, one_rank), one_rank, local,
                                  **opts)
        assert rep["n"] == [2048, 4096] and rep["row_local"] == local
        if local:
            assert rep["bytes_per_row"] == 0 and rep["failure"] is None
        else:
            assert rep["bytes_per_row"] == 20 * 8
            assert "scales with n" in rep["failure"]
    # A verdict the rule must not get raises.
    with pytest.raises(AssertionError, match="expected row-local"):
        scaling.rule_report("ell", RULES["ell"][0](64, one_rank),
                            RULES["ell"][0](128, one_rank), one_rank, True,
                            **F64)


def test_scaling_model_on_one_rank(one_rank):
    out = scaling.scaling_model(0.075, one_rank, chips=(2, 4, 8),
                                latency_s=2e-5,
                                probe_kwargs=dict(nbr=64, bs=32))
    assert out["n_independent"] and out["probe_n"] == [2048, 4096]
    assert out["n_devices"] == 1 and out["latency_s"] == 2e-5
    effs = [p["efficiency"] for p in out["projections"]]
    assert effs == sorted(effs, reverse=True) and 0 < min(effs) < 1
    assert out["min_efficiency"] == min(effs)
    assert out["m_max_ceiling_bytes"] >= out["per_iter_collective_bytes"]


def test_sum_strategy_names():
    with pytest.raises(ValueError, match="unknown ds sum strategy"):
        with tds.sum_strategy("pairwise"):
            pass
    for bad in ("pairwise", "Tree"):
        for module in (jds, tds):
            with pytest.raises(ValueError, match="unknown ds sum strategy"):
                with module.sum_strategy(bad):
                    pass


class _RankRows(Rows):
    """A sharded rank's fold on one rank: the tree, never the cascade."""
    cascade = False


def test_tree_folds_as_a_sharded_rank():
    n = tds._CASCADE_MIN_ROWS + 40_961
    rng = np.random.default_rng(5)
    x, y = (torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
            for _ in range(2))
    cascade = tds.dot_cols_ds(x, y)
    with tds.sum_strategy("tree"):
        tree = tds.dot_cols_ds(x, y)
        assert tds.gram_chunk(4096 * 3) == 4096
    rank = tds.dot_cols_ds(x, y, rows=_RankRows())
    for a, b in zip(tree, rank):
        assert torch.equal(a, b)
    # Outside the block the default is the cascade again.
    for a, b in zip(tds.dot_cols_ds(x, y), cascade):
        assert torch.equal(a, b)
    with tds.sum_strategy("tree", row_divisor=6):
        assert tds.gram_chunk(4096 * 3) == 2048


REFINED = dict(method="DPR", tolerance=1e-6, relative_tolerance=True,
               max_iterations=40, dtype="float32", expansion="lowest-k",
               refined=True)


@pytest.mark.parametrize("strategy", ["cascade", "tree"])
def test_tall_refined_solve_matches_jax_fold(strategy):
    # The JAX package's one-device engine pins its own fold (the
    # cascade); its fold "tree" on one device is the engine of a
    # one-device mesh. The port's solve under the same fold: iterations
    # within ±1, eigenvalues within the tolerance (relative).
    n = tds._CASCADE_MIN_ROWS + 40_960
    op = tgen.surrogate_hamiltonian(n, dtype=torch.float32, device="cpu")
    with tds.sum_strategy(strategy):
        res = fdtt.eigensolve(op, 4, **REFINED)
    jop = jgen.surrogate_hamiltonian(n, dtype=jnp.float32)
    if strategy == "cascade":
        ref = fdt.eigensolve(jop, 4, **REFINED)
    else:
        ref = jpar.eigensolve_sharded(jop, 4, jpar.default_mesh(1), **REFINED)
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    lam = np.asarray(ref.eigenvalues, np.float64)
    np.testing.assert_allclose(res.eigenvalues.numpy().astype(np.float64),
                               lam, rtol=REFINED["tolerance"], atol=0)


def test_utils_exports_match_jax():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert hasattr(tutils, name), name
    assert tutils.ensure_x64() is None
    assert tutils.canonical_dtype("float64") == torch.float64
