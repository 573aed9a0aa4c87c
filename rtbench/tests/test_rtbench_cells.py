"""Every cell of BENCHMARK.json end to end on the CPU at a tiny size, and a
configuration, traffic mix and metric added as files."""

from __future__ import annotations

import json
import os

import pytest
from conftest import ROOT, run_cell, with_fit

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = with_fit(json.load(f))
CELLS = [w["name"] for w in MANIFEST["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_the_contracts_line(bench_copy, cell):
    rc, line, err = run_cell(bench_copy, "--workload", cell, "--seed", "3000000017",
                             "--seconds", "1", "--trace", "0", "--size", "32x18")
    assert rc == 0, err[-2000:]
    assert list(line) == KEYS
    want = {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert line["checks"] and all(set(c) == {"value", "limit"} for c in line["checks"].values())
    # the numbers compared are the last lines of standard error too
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_traced_run_reports_per_layer_metrics(bench_copy):
    rc, line, err = run_cell(bench_copy, "--workload", "demo-1080p-fit", "--seed", "7",
                             "--seconds", "1", "--trace", "1", "--size", "32x18")
    assert rc == 0, err[-2000:]
    # on the CPU only the host-clock readings have something to read
    assert set(line["metrics"]) == {"capture_s", "capture_graph_s"}


def test_added_files_are_found_by_name(bench_copy):
    """A later PR adds a cell by files and manifest entries only."""
    rt = bench_copy / "rtbench"
    cfg = json.loads((rt / "configs" / "demo-1080p.json").read_text())
    cfg["name"] = "demo-small"
    cfg["render"].update(width=48, height=27)
    (rt / "configs" / "demo-small.json").write_text(json.dumps(cfg))
    mix = json.loads((rt / "traffic" / "viewer-30fps.json").read_text())
    (rt / "traffic" / "viewer-60fps.json").write_text(json.dumps(dict(mix, fps=60)))
    (rt / "metrics" / "traced_frames.view.py").write_text(
        "def read(ctx):\n    return ctx['units'] if ctx['kind'] == 'view' else None\n")
    (rt / "limits" / "demo-small.view60.json").write_text(
        (rt / "limits" / "demo-1080p-view.json").read_text())
    man = json.loads((bench_copy / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="demo-small",
                               file="rtbench/configs/demo-small.json"))
    man["workloads"].append(dict(name="demo-small.view60", config="demo-small",
                                 traffic="viewer-60fps", chips=1, why="a test cell"))
    for m in man["end_to_end"]:
        if "demo-1080p-view" in m.get("workloads", []):
            m["workloads"].append("demo-small.view60")
    man["per_layer"].append(dict(name="traced_frames.view", unit="frames", better="higher",
                                 source="host_clock", layer="entry", moves="frames_per_s",
                                 workloads=["demo-small.view60"]))
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(man))
    rc, line, err = run_cell(bench_copy, "--workload", "demo-small.view60", "--seed", "11",
                             "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-2000:]
    assert line["metrics"]["traced_frames.view"] == {"value": 2, "unit": "frames"}
    assert "rtbench: setup" in err


def test_no_card_no_result(bench_copy):
    """Without a CUDA card a run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env_root = bench_copy
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=env_root, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_no_program_no_result(bench_copy):
    """In a directory of BENCHMARK.json and rtbench/ alone, the program is
    missing: the run exits non-zero and prints no result."""
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=bench_copy,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS[:-1])
def test_cell_on_the_card(cell):
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", cell, "--seed", "5",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
