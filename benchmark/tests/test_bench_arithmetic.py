"""The window's and the trace's arithmetic: the metric readers on made-up
runs, the roofline counts from shapes, the trace digest on made-up
events."""

import statistics
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import banded, harness, roofline, surrogate, tracing

METRICS = {path.stem: harness.load_module(path, f"metric_{path.stem}")
           for path in (harness.BENCH_DIR / "metrics").glob("*.py")}


def _view(ranks, world=None):
    return harness.RunView(ranks=ranks, world=world or len(ranks))


def test_solve_s_counts_converged_solves_over_the_window():
    lead = {"window_s": 30.5, "converged": 122, "walls": [0.25] * 122}
    assert METRICS["solve_s"].read(_view([lead])) == pytest.approx(0.25)
    assert METRICS["solve_s"].read(_view([dict(lead, converged=0)])) is None


def test_p90_is_the_inclusive_ninth_decile():
    walls = [0.2 + 0.001 * i for i in range(101)]
    lead = {"walls": walls}
    assert METRICS["solve_p90_s"].read(_view([lead])) == pytest.approx(0.29)
    assert METRICS["solve_p90_s"].read(_view([lead])) == \
        statistics.quantiles(walls, n=10, method="inclusive")[8]
    assert METRICS["solve_p90_s"].read(_view([{"walls": [0.2]}])) is None


def test_peak_and_setup_read_the_fullest_rank_and_rank_0():
    ranks = [{"peak_bytes": 3e9, "setup_s": 9.5}, {"peak_bytes": 6e10}]
    assert METRICS["peak_mem_gb"].read(_view(ranks)) == pytest.approx(60.0)
    assert METRICS["setup_s"].read(_view(ranks)) == 9.5


def _trace(**kw):
    base = dict(window_s=2.0, busy_s=1.8, apply_s=0.6, subspace_s=0.8,
                elementwise_s=0.3, collective_s=0.02, solves=10,
                iterations=40, apply_least_s=0.45, collective_bytes=4000)
    base.update(kw)
    return base


def test_per_layer_readers():
    ranks = [{"trace": _trace(), "iterations": [4] * 10},
             {"trace": _trace(busy_s=1.6, apply_s=0.8, collective_s=0.08)}]
    view = _view(ranks)
    assert METRICS["iterations"].read(view) == 4.0
    assert METRICS["apply_device_ms"].read(view) == pytest.approx(70.0)
    assert METRICS["apply_roofline"].read(view) == pytest.approx(
        100 * 0.9 / 1.4)
    assert METRICS["subspace_device_ms"].read(view) == pytest.approx(80.0)
    assert METRICS["elementwise_device_ms"].read(view) == pytest.approx(30.0)
    assert METRICS["device_idle_share"].read(view) == pytest.approx(15.0)
    assert METRICS["collective_wait_ms"].read(view) == pytest.approx(2.0)
    assert METRICS["collective_bytes"].read(view) == pytest.approx(400.0)


def test_readers_return_nothing_where_nothing_was_read():
    one = _view([{"trace": _trace(apply_s=0.0, collective_bytes=None)}])
    assert METRICS["apply_roofline"].read(one) is None
    assert METRICS["apply_device_ms"].read(one) is None
    assert METRICS["collective_wait_ms"].read(one) is None
    assert METRICS["collective_bytes"].read(one) is None
    assert METRICS["device_idle_share"].read(_view([{"trace": None}])) is None


def test_banded_apply_cost_from_shapes():
    params = dict(n_block_rows=78128, block_size=128, bandwidth=1,
                  dtype="float64")
    moved, flops = banded.apply_cost(params, 20, 1)
    n = 78128 * 128
    assert moved == 78128 * 128 * 384 * 8 + 2 * n * 20 * 8
    assert flops == 2 * (3 * 78128 - 2) * 128 * 128 * 20
    least = roofline.least_seconds(moved, flops, "float64")
    assert least == pytest.approx(moved / 3.35e12)      # bytes bound it
    assert 10.0e-3 < least < 10.2e-3           # 33.9 GB over 3.35 TB/s
    moved4, flops4 = banded.apply_cost(dict(params, n_block_rows=4 * 78128),
                                       20, 4)
    assert moved4 == moved + 2 * 128 * 20 * 8           # the halo rows
    assert flops4 == pytest.approx(2 * (3 * 4 * 78128 - 2) / 4 * 128 * 128
                                   * 20)


def test_surrogate_apply_cost_from_shapes():
    moved, flops = surrogate.apply_cost(dict(n=10_000_000, dtype="float64"),
                                        20, 1)
    assert moved == (2 * 10_000_000 * 20 + 3 * 10_000_000) * 8
    assert flops == 2 * 10_000_000 * 20 * 5


def _event(name, t0, t1, device, corr=0, link=0, kind="cpu_op"):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(t0 * 1e9),
        end_ns=lambda: int(t1 * 1e9), device_type=lambda: device,
        is_user_annotation=lambda: kind == "user_annotation",
        activity_type=lambda: kind, correlation_id=lambda: corr,
        linked_correlation_id=lambda: link)


def test_digest_splits_the_window():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event(tracing.WINDOW_SPAN, 0.0, 10.0, cpu, 1, kind="user_annotation"),
        _event(tracing.APPLY_SPAN, 1.0, 2.0, cpu, 2, kind="user_annotation"),
        _event("aten::mm", 3.0, 3.5, cpu, 3),
        _event("cudaStreamSynchronize", 5.0, 8.0, cpu, 4, kind="cuda_runtime"),
        _event("banded_kernel", 1.5, 4.0, gpu, link=2),        # the apply
        _event("sm90_xmma_gemm_f64", 4.0, 5.0, gpu, link=3),   # subspace
        _event("elementwise_kernel", 5.0, 6.0, gpu, link=3),
        _event("ncclDevKernel_AllReduce", 6.0, 6.5, gpu, link=99),
        _event("fdt_spmm_unlinked", 9.0, 9.5, gpu, link=0),     # by name
        _event("outside", 11.0, 12.0, gpu, link=3),
    ]
    d = tracing.digest(events)
    assert d["window_s"] == pytest.approx(10.0)
    assert d["busy_s"] == pytest.approx(2.5 + 1.0 + 1.0 + 0.5 + 0.5)
    assert d["apply_s"] == pytest.approx(3.0)
    assert d["subspace_s"] == pytest.approx(1.0)
    assert d["elementwise_s"] == pytest.approx(1.0)
    assert d["collective_s"] == pytest.approx(0.5)
    assert d["unlinked_ops"] == 2
    gaps = dict(d["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2.5)
    assert sum(gaps.values()) == pytest.approx(10.0 - d["busy_s"])
    assert d["device_ops"][0][0] == "banded_kernel"


def test_classify_by_name():
    assert tracing.classify("void gemm_kernel<double>", False) == "subspace"
    assert tracing.classify("syevj_batched", False) == "subspace"
    assert tracing.classify("ncclKernel_AllReduce", False) == "collective"
    assert tracing.classify("vectorized_elementwise", False) == "elementwise"
    assert tracing.classify("vectorized_elementwise", True) == "apply"
    assert tracing.classify("banded_spmm", None) == "apply"
    # The port's sparse products are the apply's whatever their link.
    assert tracing.classify("banded_spmm_kernel<Push>", False) == "apply"


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["fortran_davidson_tpu_torch", "fortran_davidson_tpu_torch.ops",
              "jaxtyping", "torch"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(
        ["fortran_davidson_tpu.ops"]) == ["fortran_davidson_tpu"]
