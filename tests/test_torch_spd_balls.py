"""The SPD ``balls`` scene (the sphereflake of E. Haines's Standard
Procedural Databases at size factor 4: 7,381 spheres, a floor, three point
lights), the benchmark's ``spd-balls-1080p`` configuration, on the port.

On the CPU (tier 1):

* ``scripts/gen_spd_balls.py`` writes the configuration file byte for byte;
* the flake in the file: 1, 9, 81, 729 and 6,561 spheres a level, each a
  third of its parent's radius and touching it (|c − p| = r_p + r_c),
  listed depth first as ``balls.c`` writes them, the first child where the
  SPD puts it;
* ``render_jit`` of the configuration at 32×18 against the benchmark's
  float64 reference (``rtbench/reference/render.py``), and the tracer's
  ``tiles`` and ``pairs`` counters of that frame: 1 a probe call (the twin
  sweeps the table whole), the live lanes entering each step times the
  scene's 7,385 slots (7,381 spheres, the floor, 3 light bulbs); and no
  ``grouped`` call (the twin takes no light groups).

On the card (marker ``card``; no JAX, so the file runs alone there:
``python -m pytest --noconftest -m card tests/test_torch_spd_balls.py``):

* the step probe on the 7,381-sphere table, which it sweeps in tiles,
  against ``step_probe_ref`` within ``chip_smoke.py`` phase 2's limits
  (``compare_probe``), both shading variants; without fill rows, the rows
  a reader reads are the filled launch's bit for bit, the others unwritten;
* the tracer's ``grouped`` counts every probe call of a balls frame (its
  shadow pass takes a lane's lights in groups) and none of a demo frame;
* a 1080p ``render_jit`` frame against the reference within the cell's
  limits (``rtbench/limits/spd-balls-1080p-view.json``);
* the eager route (``fused="off"``): every nearest-hit and shadow-sweep
  call of a small frame, launched on the card, against the CPU twins
  within ``chip_smoke.py``'s limits of those kernels.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rtbench import check, scenedata, system
from rtbench.reference import render as ref
from txr_torch.kernels import step_probe as sp
from txr_torch.render import graphs
from txr_torch.render import render as rr
from txr_torch.utils import profiling

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "spd-balls-1080p"
LEVELS = (1, 9, 81, 729, 6561)
# the CPU frame against the float64 reference at 32×18 (readings 0.1198,
# 0.0150: a pixel here spans dozens of the smallest spheres' silhouettes)
CPU_FRAME_OFF, CPU_U8_OFF = 0.15, 0.05


def _generator():
    spec = importlib.util.spec_from_file_location(
        "gen_spd_balls", os.path.join(ROOT, "scripts", "gen_spd_balls.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cfg():
    return scenedata.load_config(NAME)


def test_the_generator_writes_the_file():
    with open(os.path.join(ROOT, "rtbench", "configs", f"{NAME}.json")) as f:
        assert f.read() == _generator().text()


def test_the_flake_is_balls_c(cfg):
    sc = cfg["scene"]
    spheres = sc["spheres"]
    assert len(spheres) == 7381 and [b["name"] for b in sc["boxes"]] == ["floor"]
    assert not any(sc.get(k) for k in ("planes", "surfaces", "toruses", "rings"))
    level_of = {0.5 / 3 ** k: k for k in range(5)}
    per_level = [0] * 5
    path = []      # the spheres from the root to the last one listed
    for s in spheres:
        c, r = np.array(s["pos"]), s["radius"]
        (lvl,) = [k for rr_, k in level_of.items() if abs(r - rr_) <= 1e-8 * rr_]
        per_level[lvl] += 1
        # depth first: a sphere's parent is the last sphere a level up
        assert lvl <= len(path)
        path = path[:lvl] + [(c, r)]
        if lvl:
            pc, pr = path[lvl - 1]
            assert abs(np.linalg.norm(c - pc) - (pr + r)) <= 1e-6
            assert abs(r * 3.0 - pr) <= 1e-8
            if lvl > 1:     # none grows back into its grandparent
                gc, gr = path[lvl - 2]
                assert np.linalg.norm(c - gc) > gr + r
    assert tuple(per_level) == LEVELS
    assert spheres[0]["pos"] == [0.0, 0.0, 0.0] and spheres[0]["radius"] == 0.5
    assert np.allclose(spheres[1]["pos"], [0.272166, 0.272166, 0.544331], atol=1e-6)
    assert abs(spheres[1]["radius"] - 0.166667) <= 1e-6
    floor = sc["boxes"][0]
    assert floor["pos"][2] + floor["form"][2] == pytest.approx(-0.5, abs=1e-9)
    assert floor["form"][:2] == [12.0, 12.0]
    assert cfg["reduced"] == [] and cfg["render"]["width"] == 1920


@pytest.fixture(scope="module")
def cpu_frame(cfg):
    """The configuration's render_jit frame at 32×18 on the CPU, traced →
    (image, the frame's record, the reference's float64 image)."""
    W, H = 32, 18
    scene, handles = system.scene(cfg, torch.device("cpu"))
    assert handles is None
    rr.clear_jit_cache()
    profiling.reset()
    profiling.tracing(True)
    try:
        with torch.no_grad():
            img = rr.render_jit(scene, system.textures(cfg, {}), system.render_config(cfg, W, H),
                                device="cpu")
        (rec,) = profiling.records()
    finally:
        profiling.tracing(False)
        profiling.reset()
        rr.clear_jit_cache()
    S = ref.Scene(cfg, 0.0, torch.float64, torch.device("cpu"))
    want = ref.render(S, ref.Textures(cfg, {}, torch.float64), ref.settings(cfg, W, H))
    return img, rec, want


def test_cpu_frame_is_the_references(cpu_frame):
    img, _, want = cpu_frame
    u8 = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    got = check.frame_numbers(img.double(), u8, want.double())
    assert got["frame_off"] <= CPU_FRAME_OFF and got["u8_off"] <= CPU_U8_OFF, got
    assert torch.isfinite(img).all()


def test_tiles_and_pairs_counters(cpu_frame, cfg):
    _, rec, _ = cpu_frame
    c = rec["counters"]
    slots = len(cfg["scene"]["spheres"]) + 1 + len(cfg["scene"]["lights_point"])
    assert slots == 7385
    assert c["pairs"] == [n * slots for n in c["lanes"]]
    # the CPU's twin sweeps the table whole: 1 a probe call, and every
    # probe of a forward step stores no fills (2 a step: the step's probe,
    # the glossy probe); its shadow pass takes no light groups
    assert c["tiles"] == c["unfilled"] == [2] * sum(c["steps"])
    assert "grouped" in graphs._call_tallies() and "grouped" not in c


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rays(scene, W, H, n_random, seed=0):
    """The camera's primary rays at W×H, then ``n_random`` random rays
    from around the flake."""
    from txr_torch.render.raygen import primary_rays

    ro, rd = primary_rays(scene.camera, W, H, 1)
    g = torch.Generator(device=ro.device).manual_seed(seed)
    o = (torch.rand(n_random, 3, generator=g, device=ro.device) - 0.5) * 3.0
    d = torch.nn.functional.normalize(torch.randn(n_random, 3, generator=g, device=ro.device),
                                      dim=-1)
    return torch.cat([ro, o]).contiguous(), torch.cat([rd, d]).contiguous()


@pytest.mark.card
@pytest.mark.parametrize("shade_flipped", [True, False])
def test_tiled_probe_is_the_twins(card, cfg, shade_flipped):
    from txr_torch.kernels.scene_table import pack_scene, set_flags

    cs = _chip_smoke()
    scene, _ = system.scene(cfg, card)
    buf, hdr = pack_scene(scene, None)
    hdr = set_flags(hdr, shade_flipped=shade_flipped)
    ro, rd = _rays(scene, 480, 270, 1 << 14)
    before = sp.step_probe.tiles, sp.step_probe.grouped
    f, i = sp.launch(buf, hdr, ro, rd)
    assert sp.step_probe.tiles - before[0] > 1       # swept in tiles
    assert sp.step_probe.grouped - before[1] == 1    # its lights in groups
    n = 1 << 15                  # the twin on a share of the lanes
    pick = torch.randperm(ro.shape[0], device=card)[:n]
    fr, ir = sp.step_probe_ref(buf, hdr, ro[pick].contiguous(), rd[pick].contiguous())
    ok, stats = cs.compare_probe(f[:, pick], i[:, pick], fr, ir, scene.counts)
    assert ok, stats
    assert int((fr[0] < 1e30).sum()) > n // 4
    # without fill rows, the rows a reader reads are the filled launch's
    f0 = torch.full_like(f, float("nan"))
    i0 = torch.full_like(i, 0x7FC00000)
    cs.probe_into(buf, set_flags(hdr, shade_flipped=shade_flipped, fill=False), ro, rd, 0.0,
                  None, f0, i0)
    hit = f[0] < 1e30
    shades = hit & (i[0] < sum(scene.counts[k] for k in sp.SLOT_ORDER)
                    - scene.counts["lights_point"])
    bits = lambda v: v.contiguous().view(torch.int32)
    assert torch.equal(bits(f0[0]), bits(f[0]))
    assert torch.equal(bits(f0[:23, hit]), bits(f[:23, hit])) and torch.equal(i0[:, hit], i[:, hit])
    assert torch.equal(bits(f0[:, shades]), bits(f[:, shades]))
    assert torch.isnan(f0[1:, ~hit]).all() and torch.isnan(f0[23:, hit & ~shades]).all()


@pytest.mark.card
def test_grouped_counter_on_the_card(card, cfg):
    """The tracer's ``grouped`` counts every probe call of a balls frame
    (its table is swept in tiles, 3 lights each shaded with shadows) and
    none of a demo frame (its table staged whole)."""
    from txr_torch.apps import demo as tdemo
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig

    scene, _ = system.scene(cfg, card)
    dscene, handles = tdemo.build_scene(480, 270)
    dscene = tdemo.update_scene(dscene.to(card), handles, 0.0, 60.5)
    frames = [(scene, system.textures(cfg, {}), system.render_config(cfg, 480, 270)),
              (dscene, with_mips(tdemo.demo_textures().to(card)), RenderConfig(width=480, height=270))]
    counters = []
    rr.clear_jit_cache()
    profiling.reset()
    profiling.tracing(True)
    try:
        for sc, tex, rc in frames:
            with torch.no_grad():
                rr.render_jit(sc, tex, rc, device=card)
        counters = [rec["counters"] for rec in profiling.records()]
    finally:
        profiling.tracing(False)
        profiling.reset()
        rr.clear_jit_cache()
    balls, demo = counters
    assert sum(balls["steps"]) >= 2 and sum(balls["tiles"]) > sum(balls["unfilled"])
    assert balls["grouped"] == balls["unfilled"]
    assert sum(demo["steps"]) >= 2 and sum(demo["tiles"]) == sum(demo["unfilled"])
    assert "grouped" not in demo


@pytest.mark.card
def test_1080p_frame_is_the_references(card, cfg):
    W, H = cfg["render"]["width"], cfg["render"]["height"]
    scene, _ = system.scene(cfg, card)
    rr.clear_jit_cache()
    with torch.no_grad():
        img = rr.render_jit(scene, system.textures(cfg, {}), system.render_config(cfg),
                            device=card).clone()
    rr.clear_jit_cache()
    u8 = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    S = ref.Scene(cfg, 0.0, torch.float64, card)
    with torch.no_grad():
        want = ref.render(S, ref.Textures(cfg, {}, torch.float64), ref.settings(cfg, W, H))
    got = check.frame_numbers(img.double().cpu(), u8.cpu(), want.double().cpu())
    with open(os.path.join(ROOT, "rtbench", "limits", "spd-balls-1080p-view.json")) as f:
        limits = json.load(f)
    assert got["frame_off"] <= limits["frame_off"] and got["u8_off"] <= limits["u8_off"], got


@pytest.mark.card
def test_eager_route_kernels_are_the_twins(card, cfg, monkeypatch):
    from txr_torch.kernels import nearest_hit as nh
    from txr_torch.kernels import shadow_sweep as ss
    from txr_torch.render import render as rmod

    cs = _chip_smoke()
    calls = {"nh": [], "ss": []}

    def spy(kind, fn):
        def wrapped(*a):
            calls[kind].append(a)
            return fn(*a)
        return wrapped

    nh_ref, ss_ref = nh.nearest_hit_ref, ss.shadow_sweep_ref
    monkeypatch.setattr(nh, "nearest_hit_ref", spy("nh", nh_ref))
    monkeypatch.setattr(ss, "shadow_sweep_ref", spy("ss", ss_ref))
    scene, _ = system.scene(cfg, torch.device("cpu"))
    rc = dataclasses.replace(system.render_config(cfg, 48, 27), fused="off")
    with torch.no_grad():
        rmod.render(scene, system.textures(cfg, {}), rc, device="cpu")
    monkeypatch.undo()
    assert calls["nh"] and calls["ss"]
    for buf, hdr, ro, rd, *alive in calls["nh"]:
        alive = alive[0] if alive else None
        want = nh_ref(buf, hdr, ro, rd, alive)
        to = lambda x: None if x is None else x.to(card).contiguous()
        got = nh.launch(to(buf), hdr, to(ro), to(rd), to(alive))
        ok, stats = cs.compare_nearest(got[0].cpu(), got[1].cpu(), *want)
        # a call whose rays all miss has no slot to agree on
        assert ok or (stats["lanes_agree"] == 1.0 and not (want[0] < 1e30).any()), stats
    for buf, hdr, ro, rd, dist, *need in calls["ss"]:
        need = need[0] if need else None
        want = ss_ref(buf, hdr, ro, rd, dist, need)
        to = lambda x: None if x is None else x.to(card).contiguous()
        got = ss.launch(to(buf), hdr, to(ro), to(rd), to(dist), to(need))
        got = tuple(None if x is None else x.cpu() for x in got)
        ok, stats = cs.compare_shadow(got, want)
        assert ok, stats
