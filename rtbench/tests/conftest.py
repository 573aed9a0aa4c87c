"""The benchmark's own CPU tests (run with ``python -m pytest rtbench/tests``).

``bench_copy`` makes a copy of the benchmark (BENCHMARK.json and
rtbench/) with its traffic mixes shortened for the CPU, in which the
tests run cells and add files; the program is imported from the repo.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a traffic mix's values shortened for a CPU run at a tiny size
QUICK = dict(check_span_s=0.1, trace_skip=1, trace_units=2, first_steps=3)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


# the fit cell: out of BENCHMARK.json while the program's captured step
# gives a NaN gradient at some poses (PERF.md §7); its loop, limits and
# metrics stay, and the tests run it from a copy of the manifest
FIT = dict(
    workload=dict(name="demo-1080p-fit", config="demo-1080p", traffic="fit-fixed-pose", chips=1,
                  why="the captured inverse-rendering step"),
    end_to_end=[dict(name="step_ms", unit="ms", better="lower", bound=0.05, source="host_clock",
                     workloads=["demo-1080p-fit"])],
    per_layer=[dict(name=n, unit=u, better=b, source="device_trace", layer=lay,
                    moves="step_ms", workloads=["demo-1080p-fit"])
               for n, u, b, lay in (("device_ms.fit", "ms", "lower", "train step"),
                                    ("idle_share.fit", "%", "lower", "device"),
                                    ("step_probe_roofline.fit", "%", "higher", "kernels"),
                                    ("step_consume_roofline.fit", "%", "higher", "kernels"),
                                    ("mfu.fit", "%", "higher", "kernels"))])


def with_fit(manifest):
    """The manifest with the fit cell and its metrics (the fit's first
    call records the program's capture spans too)."""
    manifest["workloads"].append(FIT["workload"])
    manifest["end_to_end"] += FIT["end_to_end"]
    manifest["per_layer"] += FIT["per_layer"]
    for m in manifest["per_layer"]:
        if m["name"] == "capture_graph_s":
            m["workloads"].append(FIT["workload"]["name"])
    return manifest


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark at tmp_path with quick traffic mixes and the
    fit cell."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(with_fit(json.load(f))))
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for p in (tmp_path / "rtbench" / "traffic").iterdir():
        mix = json.loads(p.read_text())
        mix.update({k: v for k, v in QUICK.items() if k in mix})
        p.write_text(json.dumps(mix))
    return tmp_path


def run_cell(root, *args, timeout=600):
    """``python3 rtbench/run.py`` in ``root`` on the CPU → (returncode, the
    last line of standard output parsed or None, standard error)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "rtbench/run.py", *args, "--device", "cpu"], cwd=root,
                       env=env, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
