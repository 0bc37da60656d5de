"""The harness loads neither JAX nor the JAX package, and prints the
result line every run prints."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import _tiny

REPO = Path(__file__).resolve().parents[2]


def test_every_cell_loads_without_jax():
    code = (
        "import json, sys\n"
        "from benchmark import harness\n"
        "import benchmark.run, benchmark.readings\n"
        "spec = json.load(open('BENCHMARK.json'))\n"
        "for w in spec['workloads']:\n"
        "    s = harness.cell_spec(w['name'])\n"
        "    harness.engine(s, 1, 'cpu')\n"
        "    for m in s['per_layer']:\n"
        "        harness.reader(m['name'])\n"
        "import benchmark.reference.acquisition, "
        "benchmark.reference.cruise_block\n"
        "import sydr_tpu_torch.receiver.session, "
        "sydr_tpu_torch.ops.acquisition, sydr_tpu_torch.ops.step_graph\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sydr_tpu_torch_like", sys)
    assert "sydr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sydr_tpu.fake", sys)
    assert "sydr_tpu" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_receiver():
    for path in (REPO / "benchmark").rglob("*.py"):
        rel = path.relative_to(REPO).as_posix()
        if rel.startswith(("benchmark/reference/", "benchmark/sky.py",
                           "benchmark/cacode.py", "benchmark/roofline.py")):
            text = path.read_text()
            assert not re.search(r"^\s*(import|from)\s+sydr_tpu", text,
                                 re.M), rel


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", [_tiny.COLD, _tiny.CRUISE])
def test_result_line_has_the_required_keys(workload, trace):
    result, lines = _tiny.run(workload, trace=trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
    assert list(result) == keys + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["correct"] is True
    json.dumps(result)
    if not trace:
        spec = _tiny.spec(workload)
        assert set(result["metrics"]) == {m["name"]
                                          for m in spec["end_to_end"]}
    # The numbers compared come last on standard error, each with its limit.
    checks = [ln for ln in lines if ln.startswith("check ")]
    assert lines[-len(checks):] == checks
    assert len(checks) == len(result["checks"])


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", _tiny.COLD,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [_tiny.COLD, _tiny.CRUISE])
def test_cell_runs_on_the_card(workload):
    """One short run of each cell through the command, on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
