"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a cell, a mix and a metric by name in files of their own."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/") and not path.endswith("_torch")
    assert len(SPEC["command"]) <= 32
    assert all(_line(word) for word in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_time_fits_with_24_cells():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and _line(conf["why"])
    assert _line(conf["source"]) and conf["source"].startswith("https://")
    assert conf["file"].startswith(SPEC["paths"][0] + "/")
    params = json.loads((ROOT / conf["file"]).read_text())
    assert params["name"] == conf["name"]
    assert (ROOT / conf["file"]).with_suffix(".py").is_file()
    assert len(conf["reduced"]) <= 16
    for key in conf["reduced"]:
        assert NAME.match(key) and key in params
        assert not key.endswith(("_dim", "_rank", "_size"))
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
    files = [c["file"] for c in SPEC["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_workloads(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert work["chips"] in (1, 4) and _line(work["why"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert pairs.count((work["config"], work["traffic"])) == 1
    cell = harness.find_cell(work["name"])
    reported = {m["name"] for m, _, kind in cell.metrics
                if kind == "end_to_end"}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(kind == "per_layer" for _, _, kind in cell.metrics)
    limits = json.loads((ROOT / "benchmark" / "limits"
                         / f"{work['name']}.json").read_text())
    assert limits["residual"] == 1e-8   # the tolerance the traffic states
    assert cell.traffic["options"]["tolerance"] == 1e-8


def test_four_chip_cells_within_a_quarter_or_one():
    fours = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert fours <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in SPEC["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    for w in metric.get("workloads", []):
        assert w in {x["name"] for x in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert names.count(metric["name"]) == 1


def test_setup_bound():
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_a_new_cell_is_files_only(tmp_path):
    """A cell, a mix, a limit file and a per-layer metric added in a copy
    of the benchmark as new files and entries: the harness finds them by
    name, and no file that was there changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "cfg5-f64-k7", "config": "cfg5-bsr-10m",
                              "traffic": "f64-k7", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "first_wall_s", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "loop control", "moves": "solve_s",
                              "workloads": ["cfg5-f64-k7"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((copy / "benchmark/traffic/f64-k3.json").read_text())
    traffic.update(name="f64-k7", lowest=7)
    (copy / "benchmark/traffic/f64-k7.json").write_text(json.dumps(traffic))
    shutil.copy(copy / "benchmark/limits/cfg5-f64-k3.json",
                copy / "benchmark/limits/cfg5-f64-k7.json")
    (copy / "benchmark/metrics/first_wall_s.py").write_text(
        "def read(run):\n    return run.lead['walls'][0]\n")
    cell = harness.find_cell("cfg5-f64-k7", root=copy)
    assert cell.traffic["lowest"] == 7 and cell.chips == 1
    assert cell.params["n_block_rows"] == 78128
    names = [m["name"] for m, _, _ in cell.metrics]
    assert "first_wall_s" in names and "collective_bytes" not in names
    reader = next(mod for m, mod, _ in cell.metrics
                  if m["name"] == "first_wall_s")
    assert reader.read(harness.RunView(ranks=[{"walls": [0.25, 0.5]}],
                                       world=1)) == 0.25
    after = {p: p.read_bytes() for p in before}
    assert after == before
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell", root=copy)
