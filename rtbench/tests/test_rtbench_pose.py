"""The reader of ``pose_replayed.view`` (100 · Σ ``pose_replays`` ÷ Σ
``poses`` over the window's untraced frames): on synthetic frame records
with and without the pose's counters, on the program's own records of a
CPU pose (no graph there: 0), and None where the program has no tracer."""

from __future__ import annotations

import importlib
import json
import os
import sys
import types

import pytest
from conftest import ROOT

from rtbench import spans
from rtbench.run import readers

NAME = "pose_replayed.view"
VIEW = dict(kind="view")


def _frame(i, profiled, poses=0, replays=0):
    counters = dict(lanes=[100], rows=[128], steps=[1])
    if poses:
        counters["poses"] = [1] * poses
    if replays:
        counters["pose_replays"] = [1] * replays
    return dict(id=i, unit="txr.frame", spans=[], profiled=profiled, counters=counters)


@pytest.fixture(scope="module")
def read():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    (mod,) = readers([m for m in man["per_layer"] if m["name"] == NAME]).values()
    return mod.read


@pytest.mark.parametrize("replays,want", [((1, 1), 100.0), ((1, 0), 50.0), ((0, 0), 0.0)])
def test_reads_the_window_frames(read, monkeypatch, replays, want):
    # a profiled frame's pose is not the window's
    recs = [_frame(0, False, 1), _frame(1, True, 1, 0), _frame(2, True, 1, 0)]
    recs += [_frame(3 + k, False, 1, r) for k, r in enumerate(replays)]
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read(VIEW) == pytest.approx(want)
    assert read(dict(kind="fit")) is None


def test_without_the_counters_or_frames(read, monkeypatch):
    # a program that counts no pose; no frame after the profiled ones
    for recs in ([_frame(0, True), _frame(1, False), _frame(2, False)],
                 [_frame(0, False, 1, 1), _frame(1, True, 1, 1)], []):
        monkeypatch.setattr(spans, "records", lambda: recs)
        assert read(VIEW) is None


def test_reads_the_programs_counters(read, monkeypatch):
    """The program's own records of three CPU poses, each before a frame
    unit, the first frame marked profiled: two window poses, no replay."""
    import torch

    from txr_torch.apps import demo
    from txr_torch.utils import profiling

    scene, handles = demo.build_scene(8, 8)
    was = profiling.tracing(True)
    profiling.reset()
    try:
        for t in (60.0, 60.5, 61.0):
            with torch.no_grad():
                demo.update_scene(scene, handles, 0.0, t)
            with profiling.unit("txr.frame"):
                pass
        recs = profiling.records()
    finally:
        profiling.tracing(was)
        profiling.reset()
    recs = [dict(r, profiled=i == 0) for i, r in enumerate(recs)]
    assert [r["counters"]["poses"] for r in recs] == [[1]] * 3
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert read(VIEW) == 0.0


def test_no_tracer_reads_none(read, monkeypatch):
    """The parent's program: a profiling module without the tracer."""
    monkeypatch.setitem(sys.modules, "txr_torch.utils.profiling", types.ModuleType("profiling"))
    try:
        fresh = importlib.reload(spans)
        assert fresh.TRACER is None and fresh.records() is None
        assert read(VIEW) is None
    finally:
        monkeypatch.undo()
        importlib.reload(spans)
