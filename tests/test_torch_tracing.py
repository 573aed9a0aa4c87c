"""The port's tracer (utils/profiling.py) on the CPU.

* off (the default): ``render_jit`` leaves no record, and every span is one
  shared null context;
* on: one record per ``render_jit`` call and per captured train step
  (``diff.optimize._Fit.step``), its spans in the frame's order (pose,
  root, key, load, capture at a key's first call, heads, steps and waits,
  tails, out), none overlapping another but the warm-up's inside the
  capture, all of the record's id;
* the bounce loop's counters: the live lanes entering each step equal a
  recount of the op-by-op ``render``'s live lanes, one step late (the
  loop's one extra step reads 0), also where the loop stops at
  ``max_steps`` (the last count is then read after the tail, under
  ``txr.wait_last``); ``rows`` is each step's capacity (R on the CPU),
  over both programs of an edge-AA frame; ``compacted`` adds 1 a step run
  below its unit's rays (capacities forced as the card's); an eager step
  adds the nearest-hit and shadow sweeps it called to ``nearest_calls`` and
  ``shadow_calls``, which a probe-route step leaves out;
* under ``torch.profiler``, each span but the root shows once as a
  ``user_annotation`` of its name, its length the in-memory span's.
"""

import collections
import dataclasses
import json
import re

import pytest
import torch

from txr_torch.apps import demo as tdemo
from txr_torch.apps import inverse as tinv
from txr_torch.diff import optimize as om
from txr_torch.kernels.nearest_hit import nearest_hit_sweep
from txr_torch.kernels.shadow_sweep import shadow_sweep
from txr_torch.render import graphs
from txr_torch.render import render as rr
from txr_torch.render import trace as tr
from txr_torch.render.texture import TextureSet, with_mips
from txr_torch.render.trace import RenderConfig
from txr_torch.utils import profiling

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 64, 36
# test_torch_train_jit.py's fit: a sphere moved, resized and recoloured
TRUE = ((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
GUESS = ((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2))
INV = dict(width=24, height=24, iterations=2, refractive_glossy=False)
# the demo's depth: every lane dies before max_steps
CFG = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
# the frame's spans in order, a program's and its chunk's head (or tail)
# collapsed to one letter, and its steps and waits to one "S": the tail
# reads the last count (W) where the loop stopped at max_steps
ORDER = re.compile(r"^P?FKL(C[HT]*)?(HST(WT)?)+O$")
LETTER = {"txr.pose": "P", "txr.frame": "F", "txr.key": "K", "txr.load": "L",
          "txr.capture": "C", "txr.head": "H", "txr.step": "S", "txr.wait_live": "W",
          "txr.wait_last": "W", "txr.tail": "T", "txr.out": "O"}


@pytest.fixture(scope="module")
def demo():
    scene, handles = tdemo.build_scene(W, H)
    return scene, handles, with_mips(tdemo.demo_textures())


@pytest.fixture
def tracer():
    """The tracer on, with no record; off and empty again afterwards."""
    rr.clear_jit_cache()
    profiling.reset()
    profiling.tracing(True)
    yield profiling
    profiling.tracing(False)
    profiling.reset()


def _frame(demo, cfg, t=60.0):
    scene, handles, tex = demo
    with torch.no_grad():
        return rr.render_jit(tdemo.update_scene(scene, handles, 0.0, t), tex, cfg, device="cpu")


def _letters(rec):
    out = re.sub(r"(.)\1+", r"\1", "".join(LETTER[s.name] for s in rec["spans"]))
    return re.sub(r"[SW]+", lambda m: m.group(0)[0], out)


def _top_level(rec):
    """The record's spans but its root and the spans inside the capture."""
    capture = {i for i, s in enumerate(rec["spans"]) if s.name == "txr.capture"}
    return [s for s in rec["spans"] if s.name != "txr.frame" and s.parent not in capture]


def _units(cfg):
    (frame,) = [f for k, f in rr._FRAMES.items() if k[1] == cfg]
    return [u for p in frame.programs for u in p.units.values()]


def test_off_leaves_no_record(demo):
    profiling.reset()
    assert not profiling.enabled()
    _frame(demo, CFG)
    assert profiling.records() == [] and profiling._open is None
    assert profiling.span("txr.a") is profiling.span("txr.b") is profiling._NULL
    assert profiling.unit("txr.frame") is profiling._NULL
    profiling.count("lanes", 1)
    assert profiling._open is None


def test_one_record_per_frame_in_order(demo, tracer):
    for k in range(2):
        _frame(demo, CFG, 60.0 + k / 30)
    recs = tracer.records()
    assert [r["unit"] for r in recs] == ["txr.frame"] * 2
    assert recs[0]["id"] != recs[1]["id"]
    for n, rec in enumerate(recs):
        assert {s.unit for s in rec["spans"]} == {rec["id"]}
        assert ORDER.match(_letters(rec)), _letters(rec)
        assert ("C" in _letters(rec)) == (n == 0)
        assert rec["counters"].get("captures") == ([1] if n == 0 else None)
        assert not rec["profiled"]
        spans = rec["spans"]
        assert all(s.start <= s.end for s in spans)
        (root,) = [s for s in spans if s.name == "txr.frame"]
        # the pose comes before the call; the rest lies inside it
        assert spans[0].name == "txr.pose" and spans[0].end <= root.start
        assert all(root.start <= s.start and s.end <= root.end for s in spans[2:])
        top = _top_level(rec)
        assert all(a.end <= b.start for a, b in zip(top, top[1:]))


def test_one_record_per_train_step(tracer):
    cfg = RenderConfig(**INV)
    target = rr.render(tinv.make_scene(*TRUE), TextureSet(), cfg, device="cpu")
    tracer.reset()
    fit = om._Fit(tinv.make_scene(*GUESS), TextureSet(), cfg, target, device="cpu")
    for i in range(2):
        fit.step(i)
    fit.close()
    recs = tracer.records()
    assert [r["unit"] for r in recs] == ["txr.train_step"] * 2
    first = [s.name for s in recs[0]["spans"]]
    # the fit's first load belongs to its first step, which captures
    assert first[:3] == ["txr.key", "txr.load", "txr.train_step"]
    assert "txr.capture" in first and "txr.capture" not in [s.name for s in recs[1]["spans"]]
    for rec in recs:
        assert {s.unit for s in rec["spans"]} == {rec["id"]}
        assert len(rec["counters"]["rows"]) == sum(rec["counters"]["steps"]) > 0


def _recount(demo, cfg, monkeypatch, t=60.0):
    """The live lanes before each bounce step of the op-by-op render."""
    scene, handles, tex = demo
    seen, make = [], tr.make_step

    def counting(*args, **kw):
        step = make(*args, **kw)

        def run(st):
            seen.append(int(st["alive"].sum()))
            return step(st)
        return run

    with monkeypatch.context() as m:
        m.setattr(tr, "make_step", counting)
        rr.render(tdemo.update_scene(scene, handles, 0.0, t), tex, cfg, device="cpu")
    return seen


@pytest.mark.parametrize("cfg", [CFG, RenderConfig(width=W, height=H, iterations=2,
                                                   extra_refraction_steps=1)],
                         ids=["to_the_last_live_lane", "to_max_steps"])
def test_lane_counters_equal_a_recount(demo, tracer, monkeypatch, cfg):
    _frame(demo, cfg)
    (rec,) = tracer.records()
    c = rec["counters"]
    want = _recount(demo, cfg, monkeypatch)
    lanes = c["lanes"]
    # the loop reads each count one step late: at most one extra step,
    # on no live lane
    assert lanes[:len(want)] == want and lanes[len(want):] in ([], [0])
    stopped = len(want) == cfg.max_steps
    assert stopped == (cfg is not CFG)
    assert ("txr.wait_last" in [s.name for s in rec["spans"]]) == stopped
    assert c["rows"] == [W * H] * sum(c["steps"]) and len(lanes) == len(c["rows"])
    assert 0 < 100.0 * sum(lanes) / sum(c["rows"]) <= 100.0


def test_lane_counters_of_both_programs(demo, tracer):
    cfg = CFG.with_aa_preset("ultra")
    _frame(demo, cfg)
    (rec,) = tracer.records()
    c = rec["counters"]
    units = _units(cfg)
    assert len(units) == 2
    assert c["rows"] == [u.R for u in units for _ in u.steps_run]
    assert c["lanes"][0] == units[0].R and c["lanes"][len(units[0].steps_run)] == units[1].R
    assert all(0 <= n <= r for n, r in zip(c["lanes"], c["rows"]))


def test_spans_in_the_profilers_trace(demo, tracer, tmp_path):
    _frame(demo, CFG)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame(demo, CFG, 61.0)
    _frame(demo, CFG, 62.0)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    shown = sorted((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("txr."))
    recs = tracer.records()
    assert [r["profiled"] for r in recs] == [False, True, False]
    mine = sorted(((s.name, (s.end - s.start) / 1e3) for s in recs[1]["spans"]
                   if s.name != "txr.frame"), key=lambda e: e[0])
    assert collections.Counter(e[0] for e in shown) == collections.Counter(n for n, _ in mine)
    # same name: in order of start in both
    by_name = collections.defaultdict(list)
    for name, _, us in shown:
        by_name[name].append(us)
    for name, us in mine:
        got = by_name[name].pop(0)
        assert got <= us + 2.0 and us - got <= max(500.0, 0.05 * us), (name, got, us)


def test_compacted_counter_counts_the_steps_below_capacity(demo, tracer, monkeypatch):
    """With the card's compacted capacities forced (the CPU steps every
    lane), ``compacted`` adds 1 for each step of either program run below
    its unit's rays, and nothing for the others."""
    monkeypatch.setattr(graphs, "capacities",
                        lambda R, dev: [R] + [c for c in (1024, 512, 256, 128) if c < R])
    cfg = CFG.with_aa_preset("ultra")
    try:
        _frame(demo, cfg)
        (rec,) = tracer.records()
        units = _units(cfg)
    finally:
        rr.clear_jit_cache()
    c = rec["counters"]
    below = [C for u in units for C in u.steps_run if C < u.R]
    assert len(units) == 2 and len(below) >= 2, [u.steps_run for u in units]
    assert c["compacted"] == [1] * len(below)
    assert len(c["rows"]) == sum(len(u.steps_run) for u in units)


def test_tiles_and_pairs_counters(demo, tracer):
    """Each step adds its live lanes entering times the scene's slots to
    ``pairs``, and the table tiles its probe launches staged to ``tiles``:
    on the CPU, whose twin sweeps the table whole, 1 a probe call, as many
    as ``unfilled`` counts in a forward frame; and the probe calls whose
    shadow pass took lights in groups (a step's tally, ``_call_tallies``)
    to ``grouped``: none, as the table is swept whole."""
    scene = demo[0]
    _frame(demo, CFG)
    (rec,) = tracer.records()
    c = rec["counters"]
    slots = sum(scene.counts[k] for k in ("planes", "spheres", "surfaces", "boxes", "toruses",
                                          "rings", "lights_point"))
    assert slots == 13
    assert c["pairs"] == [n * slots for n in c["lanes"]]
    assert c["tiles"] == c["unfilled"] and sum(c["tiles"]) == 2 * sum(c["steps"])
    assert "grouped" in graphs._call_tallies() and "grouped" not in c


@pytest.mark.parametrize("fused,glossy,per_step", [("off", True, 2), ("off", False, 1),
                                                   ("auto", True, 0)])
def test_sweep_call_counters(demo, tracer, fused, glossy, per_step):
    """Each eager step adds the nearest-hit and shadow sweeps it called, as
    its capacity's step made them, to ``nearest_calls`` and ``shadow_calls``:
    one each for the step's hit and shade, and one more each for the glossy
    pass, whose every lane a fixed-shape step traces.  They are every sweep
    call of the frame.  The probe route's steps call neither."""
    cfg = dataclasses.replace(CFG, fused=fused, refractive_glossy=glossy)
    before = nearest_hit_sweep.calls, shadow_sweep.calls
    _frame(demo, cfg)
    made = nearest_hit_sweep.calls - before[0], shadow_sweep.calls - before[1]
    (rec,) = tracer.records()
    c = rec["counters"]
    assert sum(c["steps"]) > 1
    for name, calls in zip(("nearest_calls", "shadow_calls"), made):
        assert c.get(name, []) == [per_step] * (sum(c["steps"]) if per_step else 0)
        assert sum(c.get(name, [])) == calls
