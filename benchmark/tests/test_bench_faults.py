"""A run, with only the look for a chip skipped, driven end to end at a
cell's toy size on the CPU with a fault planted under its timed path:
``correct`` comes out false for each fault the cells can show, and true
without one. The faults of the row-sharded path run on four gloo ranks,
in a four-rank cell of config 5 added as files to a copy of the
benchmark."""

import pytest

from benchmark import harness
from benchmark.tests import toy

ONE_CARD = ["cfg5-f64-k20", "ci-surrogate-f64-k20", "cfg5-f64-k3"]
FAULTS = ("unchanged", "half_batch", "altered", "far_rows")


@pytest.fixture(scope="module")
def four_root(tmp_path_factory):
    return toy.four_rank_root(tmp_path_factory.mktemp("four"))


@pytest.mark.parametrize("workload", ONE_CARD)
def test_sound_run_is_correct(workload):
    res = toy.run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["apply_gap"]["value"] < 1e-14
    assert set(res["metrics"]) == {"solve_s", "solve_p90_s", "setup_s"} - (
        set() if res["attempted"] > 1 else {"solve_p90_s"})


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ONE_CARD)
def test_planted_fault_is_not_correct(workload, fault):
    res = toy.run(workload, solve_hook=f"benchmark.tests.faults:{fault}")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", ONE_CARD)
def test_far_rows_fail_the_apply_alone(workload):
    """Left-out further rows of the apply: the solves' own numbers stay
    within their limits on config 5, whose lowest eigenvectors vanish
    there; the check's apply of the timed operator is what fails."""
    res = toy.run(workload, solve_hook="benchmark.tests.faults:far_rows")
    gap = res["checks"]["apply_gap"]
    assert gap["value"] > 1e3 * gap["limit"], res["checks"]
    if workload != "ci-surrogate-f64-k20":
        assert all(c["value"] <= c["limit"] for name, c in
                   res["checks"].items() if name != "apply_gap")


def test_four_ranks_sound(four_root):
    """The four-rank path (gloo, the exchange route of kernel 8's plain
    version), traced: correct, every rank's rows in the apply's check,
    the row-sharding metrics read."""
    res = toy.run(toy.FOUR, trace=True, root=four_root)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    assert res["checks"]["apply_gap"]["value"] < 1e-14
    assert {"collective_bytes", "collective_wait_ms"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["altered", "lost_halo", "skipped_apply",
                                   "far_rows"])
def test_four_ranks_planted_fault_is_not_correct(four_root, fault):
    """The exchange between ranks left out, and a rank that skips its
    apply, are seen by the apply's check alone: the solves' vectors
    vanish on ranks 1-3 and at every rank boundary."""
    res = toy.run(toy.FOUR, root=four_root,
                  solve_hook=f"benchmark.tests.faults:{fault}")
    assert not res["correct"], res["checks"]
    if fault != "altered":
        gap = res["checks"]["apply_gap"]
        assert gap["value"] > 1e3 * gap["limit"], res["checks"]


def test_a_rank_that_loads_a_forbidden_module_is_named(four_root):
    """A module of JAX's names loaded in a spawned rank's process only
    is found: ``benchmark.run`` then prints no result."""
    _, ranks = toy.ranks(toy.FOUR, root=four_root,
                         solve_hook="benchmark.tests.faults:foreign_module")
    assert [r["forbidden"] for r in ranks] == [[], [], ["flax"], []]
    assert harness.forbidden_in(ranks) == {"rank 2": ["flax"]}
