"""The reading of the program's ``fdt.*`` spans (``benchmark/spans.py``)
on made-up events, and the readers of its keys."""

import inspect

import pytest
from torch.autograd import DeviceType

from benchmark import spans, tracing
from benchmark.tests import toy
from benchmark.tests.test_bench_arithmetic import METRICS, _event, _view

CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def _span(name, t0, t1, corr):
    return _event(name, t0, t1, CPU, corr, kind="user_annotation")


def _call(name, at, corr):
    return _event(name, at, at + 0.01, CPU, corr, kind="cuda_runtime")


def _timeline():
    """One solve in a window, its phases, the ops they launch and the
    host's waits (times in seconds; the expected readings are in
    :func:`test_digest_sets_the_device_against_the_spans`)."""
    return [
        _span(tracing.WINDOW_SPAN, 0.0, 20.0, 1),
        _span("fdt.solve", 1.0, 15.0, 2),
        _span("fdt.init", 1.0, 3.0, 3),
        _span("fdt.apply", 2.0, 2.5, 4),
        _span("fdt.rayleigh_ritz", 3.0, 5.0, 5),
        _span("fdt.host_read", 5.0, 6.0, 6),
        _span("fdt.basis_update", 6.0, 10.0, 7),
        _span("fdt.apply", 7.0, 8.0, 8),
        _span("fdt.residual", 11.0, 14.0, 9),
        _event("aten::mm", 3.2, 3.4, CPU, 20),
        _event("aten::copy_", 5.1, 5.3, CPU, 21),
        # A ctypes launch: linked to no host operation, only to its call.
        _call("cudaLaunchKernel", 2.1, 101),
        _event("banded_spmm_kernel", 2.2, 2.4, GPU, 101, link=0),
        _call("cudaLaunchKernel", 3.3, 102),
        _event("sm90_xmma_gemm_f64", 3.5, 4.5, GPU, 102, link=20),
        # The loop's read: a copy out, then a synchronize (one wait).
        _call("cudaMemcpyAsync", 5.2, 103),
        _event("Memcpy DtoH (Device -> Pageable)", 5.2, 5.25, GPU, 103,
               link=21),
        _call("cudaStreamSynchronize", 5.26, 104),
        _call("cudaLaunchKernel", 6.5, 105),
        _event("elementwise_kernel", 6.6, 6.9, GPU, 105),
        # Launched in an apply nested in the basis update: the apply's.
        _call("cudaLaunchKernel", 7.5, 106),
        _event("banded_spmm_kernel", 7.6, 9.0, GPU, 106),
        # In the solve, in no phase.
        _call("cudaLaunchKernel", 10.5, 107),
        _event("reduce_kernel", 10.6, 10.8, GPU, 107),
        _call("cudaStreamSynchronize", 10.9, 108),
        _call("cudaDeviceSynchronize", 10.95, 112),      # the same wait
        _call("cudaLaunchKernel", 11.85, 109),
        _event("vectorized_elementwise_kernel", 11.9, 12.1, GPU, 109),
        # The harness's, after the solve.
        _call("cudaLaunchKernel", 16.0, 110),
        _event("elementwise_kernel", 16.1, 16.5, GPU, 110),
        _call("cudaDeviceSynchronize", 16.6, 111),
    ]


def test_digest_sets_the_device_against_the_spans():
    d = spans.digest(_timeline())
    assert d["solve_spans"] == 1
    assert d["span_s"] == pytest.approx({
        "fdt.apply": 0.2 + 1.4, "fdt.rayleigh_ritz": 1.0,
        "fdt.host_read": 0.05, "fdt.basis_update": 0.3,
        "fdt.residual": 0.2})
    assert d["unattributed_s"] == pytest.approx(0.2)
    assert d["solve_busy_s"] == pytest.approx(3.35)
    assert d["solve_busy_s"] == pytest.approx(
        sum(d["span_s"].values()) + d["unattributed_s"])
    assert d["span_ops"][0][:2] == ["fdt.apply", "banded_spmm_kernel"]
    assert d["span_ops"][0][2] == pytest.approx(1.6)
    assert sum(v for _, _, v in d["span_ops"]) == pytest.approx(3.35)
    # Idle inside the solve, by the span the host was in at each gap's
    # midpoint; the gap after the solve is the harness's.
    assert d["solve_idle_s"] == pytest.approx(14.0 - 3.35)
    assert d["idle_by_span"] == pytest.approx({
        "fdt.init": 1.2 + 1.1, "fdt.rayleigh_ritz": 0.7,
        "fdt.host_read": 1.35, "fdt.apply": 0.7,
        "fdt.basis_update": 1.6, "fdt.residual": 1.1 + 2.9})
    # The read (copy and synchronize, once) and the synchronize after
    # the unattributed kernel (with the device synchronize that follows
    # it, once); the harness's wait is outside the solve.
    assert d["host_syncs"] == 2
    assert d["syncs_by_span"] == {"fdt.host_read": 1, "fdt.solve": 1}
    assert d["clock_skew_ops"] == 0
    assert d["clock_skew_max_s"] == 0.0


def _moved(events, by, after=None):
    """``events`` with the device's times moved by ``by`` seconds (those
    of operations that start from ``after`` on, where given)."""
    out = []
    for e in events:
        s, f = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == GPU and (after is None or s >= after):
            e = _event(e.name(), s + by, f + by, GPU, e.correlation_id(),
                       link=e.linked_correlation_id())
        out.append(e)
    return out


def test_the_idle_is_placed_on_the_hosts_clock():
    true = spans.digest(_timeline())
    # The device's clock runs 0.3 s ahead of the host's: every operation
    # starts before its launch call, the copy out (launched with no lag)
    # by the whole 0.3 s.
    ahead = spans.digest(_moved(_timeline(), -0.3))
    assert ahead["clock_skew_ops"] == 8
    assert ahead["clock_skew_max_s"] == pytest.approx(0.3)
    for key in ("span_s", "unattributed_s", "solve_busy_s", "solve_idle_s",
                "idle_by_span", "host_syncs", "syncs_by_span"):
        assert ahead[key] == pytest.approx(true[key]), key


def _two_solves():
    """Two solves of one operation each, launched with no lag: the
    first's in its residual, the second's in its residual, each solve's
    end its host read."""
    return [
        _span(tracing.WINDOW_SPAN, 0.0, 10.0, 1),
        _span("fdt.solve", 1.0, 4.0, 2),
        _span("fdt.residual", 1.0, 2.0, 3),
        _span("fdt.host_read", 2.0, 4.0, 4),
        _span("fdt.solve", 5.0, 8.0, 5),
        _span("fdt.residual", 5.0, 6.0, 6),
        _span("fdt.host_read", 6.0, 8.0, 7),
        _call("cudaLaunchKernel", 1.5, 101),
        _event("gemm", 1.5, 2.5, GPU, 101),
        _call("cudaLaunchKernel", 5.5, 102),
        _event("gemm", 5.5, 6.5, GPU, 102),
    ]


def test_a_step_of_the_device_clock_moves_only_the_solves_after_it():
    true = spans.digest(_two_solves())
    assert true["idle_by_span"] == pytest.approx(
        {"fdt.residual": 0.5 + 0.5, "fdt.host_read": 1.5 + 1.5})
    # The device's clock steps 0.4 s ahead between the solves.
    step = spans.digest(_moved(_two_solves(), -0.4, after=5.0))
    assert step["clock_skew_ops"] == 1
    assert step["clock_skew_max_s"] == pytest.approx(0.4)
    assert step["idle_by_span"] == pytest.approx(true["idle_by_span"])
    assert step["solve_idle_s"] == pytest.approx(4.0)
    # Or 0.2 s behind: no operation starts before its call, and the
    # least lag of the second solve reads the offset.
    late = spans.digest(_moved(_two_solves(), 0.2, after=5.0))
    assert late["clock_skew_ops"] == 0
    assert late["idle_by_span"] == pytest.approx(true["idle_by_span"])
    # One shift a solve, from its start to the next's, the first's also
    # before it; none without a solve.
    assert spans.clock_shifts([1.0, 5.0], [(1.5, 1.5), (5.5, 5.1),
                                           (6.0, 5.95), (0.5, 0.4)]) == \
        pytest.approx([0.1, 0.4])
    assert spans.clock_shifts([1.0, 5.0, 9.0], [(1.5, 1.6), (5.5, 5.7),
                                                (7.0, 7.5)]) == \
        pytest.approx([-0.1, -0.2, 0.0])
    assert spans.clock_shifts([], [(1.5, 1.6)]) == []


def test_the_innermost_span_wins():
    d = spans.digest(_timeline())
    # 7.6-9.0 was launched in the apply inside the basis update, 6.6-6.9
    # in the basis update itself.
    assert d["span_s"]["fdt.apply"] == pytest.approx(1.6)
    assert d["span_s"]["fdt.basis_update"] == pytest.approx(0.3)
    line = spans.Timeline([(0.0, 10.0, "a"), (1.0, 5.0, "b"),
                           (2.0, 3.0, "c"), (5.0, 6.0, "d")])
    assert [line.at(t) for t in (0.5, 1.5, 2.5, 4.0, 5.5, 7.0, 11.0)] == \
        ["a", "b", "c", "b", "d", "a", None]


def test_a_ctypes_launch_is_found_through_its_call():
    d = spans.digest(_timeline())
    # banded_spmm_kernel at 2.2-2.4 links to no host operation; its
    # launch call at 2.1 lies in the init's apply.
    assert d["span_s"]["fdt.apply"] > 1.4
    no_call = [e for e in _timeline() if e.correlation_id() != 101
               or e.device_type() == GPU]
    assert spans.digest(no_call)["span_s"]["fdt.apply"] == pytest.approx(1.4)


def test_existing_keys_read_as_without_the_spans():
    plain = [
        _event(tracing.WINDOW_SPAN, 0.0, 10.0, CPU, 1,
               kind="user_annotation"),
        _event(tracing.APPLY_SPAN, 1.0, 2.0, CPU, 2, kind="user_annotation"),
        _event("aten::mm", 3.0, 3.5, CPU, 3),
        _event("cudaStreamSynchronize", 5.0, 8.0, CPU, 4,
               kind="cuda_runtime"),
        _event("banded_kernel", 1.5, 4.0, GPU, link=2),
        _event("sm90_xmma_gemm_f64", 4.0, 5.0, GPU, link=3),
        _event("elementwise_kernel", 5.0, 6.0, GPU, link=3),
        _event("fdt_spmm_unlinked", 9.0, 9.5, GPU, link=0),
    ]
    spanned = plain + [_span("fdt.solve", 0.5, 9.8, 50),
                       _span("fdt.apply", 0.9, 2.1, 51),
                       _span("fdt.rayleigh_ritz", 2.9, 5.5, 52)]
    original = inspect.unwrap(tracing.digest)
    assert original(spanned) == original(plain)
    spans.install()
    spans.install()
    assert inspect.unwrap(tracing.digest) is original
    full = tracing.digest(spanned)
    assert {key: full[key] for key in original(plain)} == original(plain)
    assert full["solve_spans"] == 1
    assert tracing.digest(plain)["solve_spans"] == 0
    assert tracing.digest([]) == {}
    # A program without spans whose device runs ahead of the host: the
    # skew is counted, and nothing else is read.
    ahead = plain + [_call("cudaLaunchKernel", 7.0, 60),
                     _event("elementwise_kernel", 6.9, 7.2, GPU, 60)]
    bare = tracing.digest(ahead)
    assert bare["solve_spans"] == 0 and bare["clock_skew_ops"] == 1
    assert bare["span_s"] == {} and bare["solve_idle_s"] == 0.0


def test_span_readers():
    base = dict(solves=10, span_s={}, unattributed_s=0.0, solve_busy_s=0.0,
                solve_idle_s=0.0, idle_by_span={}, host_syncs=0,
                syncs_by_span={}, clock_skew_ops=0)
    one = dict(base, solve_spans=10, solve_idle_s=0.08, host_syncs=90,
               unattributed_s=0.001, solve_busy_s=2.0, clock_skew_ops=4,
               span_s={"fdt.init": 0.05, "fdt.apply": 0.47,
                       "fdt.rayleigh_ritz": 0.1, "fdt.orthonormalize": 0.6,
                       "fdt.residual": 0.3, "fdt.correction": 0.2,
                       "fdt.basis_update": 0.4})
    two = dict(one, solve_idle_s=0.12, host_syncs=110, unattributed_s=0.003,
               solve_busy_s=2.2, clock_skew_ops=0,
               span_s=dict(one["span_s"], **{"fdt.apply": 0.53}))
    view = _view([{"trace": one}, {"trace": two}])
    for name, ms in (("init_span_ms", 5.0), ("apply_span_ms", 50.0),
                     ("ritz_span_ms", 10.0), ("ortho_span_ms", 60.0),
                     ("residual_span_ms", 30.0), ("correction_span_ms", 20.0),
                     ("basis_span_ms", 40.0), ("solve_idle_ms", 10.0),
                     ("unattributed_span_ms", 0.2),
                     ("solve_busy_ms", 210.0)):
        assert METRICS[name].read(view) == pytest.approx(ms)
    assert METRICS["host_syncs"].read(view) == pytest.approx(10.0)
    # The window's count, not a solve's; a program without spans has it.
    assert METRICS["clock_skew_ops"].read(view) == pytest.approx(2.0)
    assert METRICS["clock_skew_ops"].read(_view([{"trace": dict(
        base, solve_spans=0, clock_skew_ops=3)}])) == 3.0
    # A program without spans, or a run without a trace: nothing to read.
    for name in ("init_span_ms", "solve_idle_ms", "host_syncs",
                 "unattributed_span_ms", "solve_busy_ms"):
        assert METRICS[name].read(_view([{"trace": dict(
            base, solve_spans=0)}])) is None
        assert METRICS[name].read(_view([{"trace": None}])) is None
    # A digest without the spans' keys (the harness's alone).
    assert METRICS["clock_skew_ops"].read(_view([{"trace": {
        "busy_s": 1.0}}])) is None
    assert METRICS["clock_skew_ops"].read(_view([{"trace": None}])) is None


def test_the_table_reads_a_traced_run():
    d = dict(spans.digest(_timeline()), solves=1)
    text = spans.table(d)
    assert "1 solves" in text
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines()
            if line.startswith(("fdt.", "(no"))}
    assert rows["fdt.apply"] == ["1600.000", "700.000", "0.00"]
    assert rows["fdt.host_read"] == ["50.000", "1350.000", "1.00"]
    assert rows["(no"] == ["phase)", "200.000", "0.000", "1.00"]
    assert "spans 3150.000 + unattributed 200.000" in text
    assert spans.table({"solve_spans": 0}).startswith("no fdt.solve")
    # A traced toy run: the program's solve spans reach the digest.
    cell, ranks = toy.ranks("cfg5-f64-k3", seconds=0.3, trace=True)
    trace = ranks[0]["trace"]
    assert trace["solve_spans"] >= 1 and trace["clock_skew_ops"] == 0
    assert f"{trace['solve_spans']} solves" in spans.table(trace)
