"""The readers of the program's own spans and counters (rtbench/spans.py,
``host_self_ms.view``, ``host_wait_ms.view``, ``lane_use.view``,
``capture_graph_s``): on synthetic frame records, ultra's two programs
among them; None where the program has no tracer; the tracer off in an
untraced run and read in a traced one on the CPU."""

from __future__ import annotations

import collections
import importlib
import json
import os
import subprocess
import sys
import types

import pytest
from conftest import ROOT

from rtbench import spans
from rtbench.run import readers

Span = collections.namedtuple("Span", "name start end parent unit")
NEW = ["host_self_ms.view", "host_wait_ms.view", "lane_use.view", "capture_graph_s"]
VIEW = dict(kind="view")
MS = 1_000_000


def _frame(i, profiled, pose, frame, waits, lanes, rows, capture=0):
    """A frame record: a pose of ``pose`` ms, a root of ``frame`` ms that
    holds a capture of ``capture`` ms and waits of the given ms."""
    t = 10_000 * MS * i
    out = [Span("txr.pose", t, t + pose * MS, None, i)]
    t0 = t = out[0].end + MS
    out.append(Span("txr.frame", t0, t0 + frame * MS, None, i))
    if capture:
        out.append(Span("txr.capture", t, t + capture * MS, 1, i))
        t = out[-1].end
    for w in waits:
        out.append(Span("txr.wait_live", t, t + w * MS, 1, i))
        t = out[-1].end
    return dict(id=i, unit="txr.frame", spans=out, profiled=profiled,
                counters=dict(lanes=list(lanes), rows=list(rows), steps=[1] * len(rows)))


# a capture frame, two profiled frames, two of the window's untraced
# frames; each of those a base pass and an edge pass (ultra)
RECORDS = [
    _frame(0, False, 1, 500, [1], [100, 40], [100, 100], capture=400),
    _frame(1, True, 3, 30, [9, 9], [100, 40, 3, 8], [100, 100, 64, 8]),
    _frame(2, True, 3, 30, [9], [100, 40, 8], [100, 100, 8]),
    _frame(3, False, 1, 10, [2, 1], [100, 40, 10, 0, 8, 8, 2], [100, 100, 64, 64, 8, 8, 8]),
    _frame(4, False, 2, 12, [3], [100, 50, 0, 8, 1], [100, 100, 64, 8, 8]),
]


@pytest.fixture(scope="module")
def read():
    """{metric: its reader's read}."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    mods = readers([m for m in man["per_layer"] if m["name"] in NEW])
    assert sorted(mods) == sorted(NEW)
    return {k: m.read for k, m in mods.items()}


def test_readers_read_the_window_frames(read, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: RECORDS)
    # frames 3 and 4: (1 + 10 − 3) and (2 + 12 − 3) ms of the host's own
    assert read["host_self_ms.view"](VIEW) == pytest.approx((8 + 11) / 2)
    assert read["host_wait_ms.view"](VIEW) == pytest.approx((3 + 3) / 2)
    # both programs of both frames: 168 + 159 lanes in 352 + 280 rows
    assert read["lane_use.view"](VIEW) == pytest.approx(100.0 * 327 / 632)
    assert read["capture_graph_s"](VIEW) == pytest.approx(0.4)
    assert all(read[k](dict(kind="fit")) is None for k in NEW[:3])


def test_readers_without_frames(read, monkeypatch):
    # no profiled frame (an untraced window), or none after the profiled ones
    for recs in ([RECORDS[0], RECORDS[3]], RECORDS[:3], []):
        monkeypatch.setattr(spans, "records", lambda: recs)
        assert all(read[k](VIEW) is None for k in NEW[:3])
    monkeypatch.setattr(spans, "records", lambda: RECORDS[1:])
    assert read["capture_graph_s"](VIEW) is None


def test_no_tracer_reads_none(read, monkeypatch):
    """The parent's program: a profiling module without the tracer."""
    monkeypatch.setitem(sys.modules, "txr_torch.utils.profiling", types.ModuleType("profiling"))
    try:
        fresh = importlib.reload(spans)
        assert fresh.TRACER is None and fresh.records() is None
        assert all(read[k](VIEW) is None for k in NEW)
    finally:
        monkeypatch.undo()
        importlib.reload(spans)


PROBE = """
import json, runpy, sys
sys.argv = ["rtbench/run.py", *sys.argv[1:]]
try:
    runpy.run_path("rtbench/run.py", run_name="__main__")
except SystemExit as e:
    rc = e.code
from txr_torch.utils import profiling
print(json.dumps(dict(rc=rc, on=profiling.enabled(), records=len(profiling.records()))),
      file=sys.stderr)
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_tracer_on_in_traced_runs_alone(bench_copy, trace):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", PROBE, "--workload", "demo-1080p-view", "--seed",
                        "3000000017", "--seconds", "8" if trace else "1", "--trace", str(trace),
                        "--size", "32x18", "--device", "cpu"], cwd=bench_copy, env=env,
                       capture_output=True, text=True, timeout=600)
    probe = json.loads(p.stderr.strip().splitlines()[-1])
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert probe["rc"] == 0, p.stderr[-2000:]
    assert probe["on"] == bool(trace) and (probe["records"] > 0) == bool(trace)
    if trace:
        got = line["metrics"]
        assert set(NEW) <= set(got), got
        assert 0 < got["lane_use.view"]["value"] <= 100
        # the program's spans lie inside the harness's span of each frame
        assert got["host_self_ms.view"]["value"] + got["host_wait_ms.view"]["value"] <= (
            got["host_ms.view"]["value"])
