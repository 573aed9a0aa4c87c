"""The trace reading copied from the program's profile_frame.py, on a
synthetic chrome trace."""

from __future__ import annotations

import json

import pytest

from rtbench import traces


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def X(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


EVENTS = [
    X(traces.MARK, "user_annotation", 100.0, 1000.0),
    X("cudaGraphLaunch", "cuda_runtime", 90.0, 40.0),
    X("aten::_foreach_copy_", "cpu_op", 300.0, 250.0),
    X("(anonymous namespace)::step_probe_kernel(txr::Meta, float const*)", "kernel", 50.0, 100.0),
    X("(anonymous namespace)::step_probe_kernel_x(int)", "kernel", 160.0, 40.0),
    X("void at::native::vectorized_elementwise_kernel<4>(int)", "kernel", 180.0, 60.0),
    X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 700.0, 300.0),
    X("(anonymous namespace)::step_consume_kernel(Ctx)", "kernel", 1050.0, 200.0),
]


def test_marked_span_busy_kernels_gaps():
    got = traces.read(FakeProfile(EVENTS), ["step_probe_kernel", "step_consume_kernel"])
    assert got["window_s"] == pytest.approx(1000e-6)
    # inside [100, 1100]: 50 of the probe, [160, 240] overlapped, 300 of the
    # copy, 50 of the consume
    assert got["busy_s"] == pytest.approx((50 + 80 + 300 + 50) * 1e-6)
    assert got["kernel_s"]["step_probe_kernel"] == pytest.approx(50e-6)
    assert got["kernel_s"]["step_consume_kernel"] == pytest.approx(50e-6)
    assert got["device_ops"][0] == ["Memcpy DtoH (Device -> Pinned)", pytest.approx(300e-6)]
    # the longest gap, [240, 700], is the host's foreach copy; the mark
    # itself names no gap
    assert got["idle_gaps"][0] == ["aten::_foreach_copy_", pytest.approx(460e-6)]
    assert [g[1] for g in got["idle_gaps"]] == sorted((g[1] for g in got["idle_gaps"]),
                                                       reverse=True)


def test_no_mark_or_no_device_event_reads_nothing():
    assert traces.read(FakeProfile(EVENTS[1:]), []) is None
    assert traces.read(FakeProfile(EVENTS[:3]), []) is None


def test_kernel_names_match_whole():
    assert traces.is_kernel("ns::step_consume_kernel(Ctx)", "step_consume_kernel")
    assert not traces.is_kernel("ns::step_consume_rays_kernel(Ctx)", "step_consume_kernel")
