"""A configuration, a traffic mix, a per-layer metric and a cell are added
as new files and entries only: in a temporary copy of the benchmark the
harness finds each by its name with no file that was there edited and
no entry of BENCHMARK.json changed. (The contract asks a later PR to
name a new cell in the ``workloads`` list of an end-to-end metric that
only some cells report, such as detect_p50_ms; the harness does not read
those lists: a driver says which end-to-end metrics it takes.) And the
command, with no card, fails and prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

PB = harness.PB_DIR
ROOT = harness.ROOT


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return tmp_path


def add_dummies(root):
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "yunet_n.json").read_text())
    cfg["name"] = "dummy_cfg"
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "detect_b1_640.json").read_text())
    mix["pool"] = 4
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "dummy_metric.py").write_text(
        "def read(drv):\n    return 42.0 if drv.scope == 'dummy' else None\n")
    (pb / "limits" / "dummy.cell.json").write_text(json.dumps(
        {"limits": {"score_gap": 0.5}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "https://x.y/z",
                            "file": "portbench/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy_metric.detect", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "detect_p50_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def entries(spec):
    """Every entry of BENCHMARK.json, keyed by its list and name."""
    return {(k, e["name"]): e for k, v in spec.items()
            if isinstance(v, list) for e in v if isinstance(e, dict)}


RESOLVE = """
import json, types
from portbench import harness
b = harness.Bench()
cell = b.workload("dummy.cell")
mix = b.traffic(cell["traffic"])
drv = harness.driver_class(mix["driver"])(b.config(cell["config"]), mix,
                                          1, "cpu")
print(json.dumps({
    "config": b.config(cell["config"])["name"], "pool": mix["pool"],
    "driver": type(drv).__module__, "limits": b.limits("dummy.cell"),
    "e2e": [m["name"] for m in b.end_to_end("dummy.cell")],
    "per_layer": [m["name"] for m in b.per_layer("dummy.cell")],
    "dummy": harness.metric_reader("dummy_metric.detect")(
        types.SimpleNamespace(scope="dummy")),
    "file": harness.metric_reader("dummy_metric.detect").__module__}))
"""


def test_new_files_and_entries_resolve_by_name(copy):
    before = digests(copy / "portbench")
    spec_before = entries(json.loads((copy / "BENCHMARK.json").read_text()))
    add_dummies(copy)
    after = digests(copy / "portbench")
    assert {k: after[k] for k in before} == before
    spec_after = entries(json.loads((copy / "BENCHMARK.json").read_text()))
    assert {k: spec_after[k] for k in spec_before} == spec_before
    assert set(spec_after) - set(spec_before) == {
        ("configs", "dummy_cfg"), ("workloads", "dummy.cell"),
        ("per_layer", "dummy_metric.detect")}
    assert set(after) - set(before) == {
        "configs/dummy_cfg.json", "traffic/dummy_mix.json",
        "metrics/dummy_metric.py", "limits/dummy.cell.json"}
    r = subprocess.run([sys.executable, "-c", RESOLVE], cwd=copy,
                       env={**os.environ, "PYTHONPATH": str(copy)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["config"] == "dummy_cfg" and got["pool"] == 4
    assert got["driver"] == "portbench.drivers.detect"
    assert got["limits"] == {"score_gap": 0.5}
    assert got["e2e"] == ["detect_p50_ms", "detect_p95_ms", "setup_s"]
    assert "dummy_metric.detect" in got["per_layer"]
    assert "idle_pct.detect" in got["per_layer"]
    assert got["dummy"] == 42.0
    assert got["file"] == "portbench.metrics.dummy_metric"


def test_no_card_no_result(copy):
    """On a machine without a CUDA card the command exits with 2 and
    prints nothing on standard output."""
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "n.detect.b1", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert r.returncode == 2 and r.stdout == "", (r.returncode, r.stdout)


def test_only_the_benchmark_files_fail(copy):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files (no program), the command fails and prints no result."""
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "n.detect.b1", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=copy,
                       env={**os.environ, "PYTHONPATH": str(copy)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
