"""The eager route's per-layer readers (``eager_sweep_ms.view``,
``nearest_rate.view``) on synthetic readings: their arithmetic, and None
without a profile, without the kernel (a probe-route frame), outside a
view cell, and for ``nearest_rate.view`` without the program's counters."""

from __future__ import annotations

import json
import os

import pytest
from conftest import ROOT

from rtbench import spans
from rtbench.run import readers

NEW = ["eager_sweep_ms.view", "nearest_rate.view"]


def _ctx(nearest=0.003, shadow=0.005, kind="view"):
    prof = dict(busy_s=0.8, window_s=0.9,
                kernel_s=dict(nearest_hit_kernel=nearest, shadow_sweep_kernel=shadow))
    return dict(kind=kind, units=2, profile=prof, host_ms=[], wall_ms=90.0, capture_s=9.0,
                least_ms={})


def _record(profiled, pairs):
    return dict(id=0, unit="txr.frame", spans=[], profiled=profiled,
                counters=dict(pairs=list(pairs)))


# a set-up frame, then two of the window's frames that the profiler ran
# through, then one after it
RECORDS = [_record(False, [1, 2]), _record(True, [4e9, 2e9]), _record(True, [3e9, 1e9]),
           _record(False, [7, 8])]


@pytest.fixture(scope="module")
def read():
    """{metric: its reader}, loaded as run.py loads them."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    mods = readers([m for m in man["per_layer"] if m["name"] in NEW])
    assert sorted(mods) == sorted(NEW)
    return mods


def test_readers_name_the_eager_kernels(read):
    assert read["eager_sweep_ms.view"].KERNELS == ("nearest_hit_kernel", "shadow_sweep_kernel")
    assert read["nearest_rate.view"].KERNELS == ("nearest_hit_kernel",)


def test_eager_sweep_ms(read):
    r = read["eager_sweep_ms.view"].read
    # 8 ms of both kernels over 2 traced frames
    assert r(_ctx()) == pytest.approx(4.0)
    assert r(_ctx(shadow=0.0)) == pytest.approx(1.5)
    for ctx in (_ctx(nearest=0.0, shadow=0.0), dict(_ctx(), profile=None), dict(_ctx(), units=0),
                _ctx(kind="fit")):
        assert r(ctx) is None


def test_nearest_rate(read, monkeypatch):
    r = read["nearest_rate.view"].read
    monkeypatch.setattr(spans, "records", lambda: RECORDS)
    # 5e9 pairs a frame over 1.5 ms of nearest_hit_kernel a frame
    assert r(_ctx()) == pytest.approx(5e9 / 1.5e-3 / 1e9)
    for ctx in (_ctx(nearest=0.0), dict(_ctx(), profile=None), dict(_ctx(), units=0),
                _ctx(kind="fit")):
        assert r(ctx) is None
    # no pairs counted, no profiled frame, no tracer
    for recs in ([_record(False, [1]), _record(True, [])], RECORDS[:1], None):
        monkeypatch.setattr(spans, "records", lambda: recs)
        assert r(_ctx()) is None
