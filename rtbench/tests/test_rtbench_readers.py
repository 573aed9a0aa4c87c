"""The fit's per-layer readers (``rtbench/metrics/*.fit.py``) on synthetic
readings: each reads its own kind of cell alone, with the arithmetic of its
view twin; and the lane tally that prices the fit's step is the posed
frame's."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch
from conftest import ROOT

METRICS = os.path.join(ROOT, "rtbench", "metrics")
PAIRS = [("step_probe_roofline.py", "step_probe_roofline.fit.py"),
         ("step_consume_roofline.py", "step_consume_roofline.fit.py"),
         ("mfu.view.py", "mfu.fit.py")]


def _reader(name):
    spec = importlib.util.spec_from_file_location("rtbench_reader_" + name.replace(".", "_"),
                                                  os.path.join(METRICS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(kind):
    prof = dict(busy_s=0.8, window_s=0.9,
                kernel_s=dict(step_probe_kernel=0.004, step_consume_kernel=0.002,
                              step_consume_rays_kernel=0.0004))
    return dict(kind=kind, units=2, profile=prof, host_ms=[], wall_ms=430.0, capture_s=9.0,
                least_ms=dict(step_probe=0.3, glossy_rays=0.02, step_consume=0.4))


@pytest.mark.parametrize("view,fit", PAIRS)
def test_fit_reader_reads_the_fit_alone_as_its_view_twin_reads_the_view(view, fit):
    v, f = _reader(view), _reader(fit)
    assert f.KERNELS == v.KERNELS and f.PRICED and v.PRICED
    assert f.read(_ctx("view")) is None and v.read(_ctx("fit")) is None
    got, want = f.read(_ctx("fit")), v.read(_ctx("view"))
    assert got == want and 0.0 < got <= 100.0


def test_rooflines_of_the_fit():
    ctx = _ctx("fit")
    # 0.3 ms of least time over 2 ms of probe a step (4 ms over 2 steps)
    assert _reader("step_probe_roofline.fit.py").read(ctx) == pytest.approx(15.0)
    assert _reader("step_consume_roofline.fit.py").read(ctx) == pytest.approx(
        100.0 * 0.42 / 1.2)
    assert _reader("mfu.fit.py").read(ctx) == pytest.approx(100.0 * 0.72 / 430.0)
    for name in ("step_probe_roofline.fit.py", "step_consume_roofline.fit.py", "mfu.fit.py"):
        assert _reader(name).read(dict(ctx, profile=None)) is None
        assert _reader(name).read(dict(ctx, least_ms={})) is None


def test_fit_tally_is_the_posed_frames():
    from rtbench import loops, scenedata
    from rtbench.reference import render as ref

    torch.set_num_threads(2)
    cfg = scenedata.load_config("demo-1080p")
    with open(os.path.join(ROOT, "rtbench", "traffic", "fit-fixed-pose.json")) as f:
        traffic = json.load(f)
    dev = torch.device("cpu")
    loop = loops.Fit(cfg, traffic, 3000000017, dev, size=(32, 18))
    loop._build_inputs()
    T = ref.Textures(cfg, loop.raw, torch.float64)
    got = []
    ref.loss_and_grad(ref.Scene(cfg, loop.t, torch.float64, dev, requires_grad=True), T,
                      loop.settings, chunk=256, tally=got)
    want = []
    with torch.no_grad():
        ref.render(ref.Scene(cfg, loop.t, torch.float64, dev), T, loop.settings, 256, tally=want)
    assert got and got == want
