"""What a run loads: each cell's whole module graph, driven at its toy
size on the CPU in a fresh process (and the four-rank cell of
``toy.four_rank_root`` in its four), loads no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``fortran_davidson_tpu``
(compared whole: the port's name begins with the JAX package's); and
the reference loads nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("workload", CELLS + ["cfg5x4-f64-k20"])
def test_a_run_loads_no_jax(workload):
    last = _python(
        "import json, sys, tempfile\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "from benchmark.tests import toy\n"
        f"root = (toy.four_rank_root(Path(tempfile.mkdtemp())) "
        f"if {workload!r} == toy.FOUR else toy.ROOT)\n"
        f"cell, ranks = toy.ranks({workload!r}, seconds=0.2, trace=True, "
        "root=root)\n"
        "res = harness.assemble(cell, ranks, True)\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([res['correct'], len(ranks),\n"
        "                  harness.forbidden_in(ranks),\n"
        "                  [r['forbidden'] for r in ranks],\n"
        "                  'fortran_davidson_tpu_torch' in mods]))\n")
    correct, world, forbidden, each, port = json.loads(last)
    assert correct and forbidden == {} and port
    assert each == [[]] * world and world == (4 if "x4" in workload else 1)


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_loads_nothing_of_the_port(workload):
    """The cell's reference half (inputs, reference apply, reference
    eigenvalues, the comparison) alone."""
    last = _python(
        "import json, sys, torch\n"
        "from benchmark import harness, reference\n"
        "from benchmark.tests import toy\n"
        f"cell = harness.find_cell({workload!r}, "
        f"overrides=toy.OVERRIDES[{workload!r}])\n"
        "p, k = cell.params, cell.traffic['lowest']\n"
        "inputs = cell.config.make_inputs(p, 5, 'cpu', 0, 1) "
        "if cell.chips == 1 else None\n"
        "if inputs is None:\n"
        "    p = dict(p, n_block_rows=p['n_block_rows'] // cell.chips)\n"
        "    inputs = cell.config.make_inputs(p, 5, 'cpu', 0, 1)\n"
        "ref = cell.config.reference_eigenvalues(inputs, p, k)\n"
        "n = inputs['blocks'].shape[0] * inputs['blocks'].shape[1] "
        "if 'blocks' in inputs else inputs['t'].shape[0]\n"
        "x = torch.linalg.qr(torch.randn(n, k, dtype=torch.float64))[0]\n"
        "vals = reference.readings([ref], ref, [(torch.from_numpy(ref), x)],\n"
        "    lambda v: cell.config.reference_apply(inputs, p, v,\n"
        "                                          reference.Comm()),\n"
        "    reference.Comm())\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([vals['eig_gap'], sorted(mods & {\n"
        "    'fortran_davidson_tpu_torch', 'fortran_davidson_tpu', 'jax'})]))\n")
    gap, loaded = json.loads(last)
    assert gap == 0.0 and loaded == []
