"""The port's work model (txr_torch/utils/flops.py) vs the JAX package's
(txr/utils/flops.py), and its launch prices against the work the kernels'
twins do.

* The per-ray prices and the frame's flops per ray equal JAX's exactly, on
  the demo scene's counts and on a scene with planes (one-sided and
  two-sided).
* The port's bounce steps at 48×27 (what ``live_fractions`` counts) keep
  the lanes of the JAX package's ``make_step`` loop (bench.py:355-361, the
  jnp body on the CPU) alive step by step, but for the lanes whose rays
  part at a torus (at most 2.5 % of them, each crossing the torus's bounding
  sphere at the step it parts).
* Every kernel call of one 48×27 frame, on the probe route and on the eager
  route (the nearest-hit and shadow-sweep kernels), is priced at no more
  than the full work of its twin on the same lanes, and at more than zero
  where a lane lives; a line the model prices as crossing a torus's
  bounding sphere is one the kernel's cull keeps; each lane-map call of a
  render_jit frame with compacted steps is priced once, by its bytes.
* The work model imports neither JAX nor the JAX package, in a fresh
  interpreter.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.render import trace as jtr
from txr.render.raygen import primary_rays as jprimary_rays
from txr.render.texture import with_mips as jwith_mips
from txr.scene import factories as jfactories
from txr.utils import flops as jflops
from txr_torch.apps import demo as tdemo
from txr_torch.kernels import primitives as prim
from txr_torch.kernels.scene_table import pack_scene, sections
from txr_torch.kernels.step_probe import n_rows
from txr_torch.render import trace as ttr
from txr_torch.render.raygen import primary_rays
from txr_torch.render.render import render
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig
from txr_torch.scene import factories as tfactories
from txr_torch.utils import flops

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 48, 27


def _planes_scene(fac):
    """Two planes, spheres, a box, a torus, a ring and both kinds of light,
    built by a package's SceneBuilder."""
    b = fac.SceneBuilder(camera_pos=(0.0, 1.0, -6.0))
    m = fac.material((0.8, 0.3, 0.2), specular=20, reflect=0.2)
    b.add_plane((0.0, 1.0, 0.0), (0.0, -1.0, 0.0), m)
    b.add_plane((0.0, 0.0, -1.0), (0.0, 0.0, 9.0), m)
    b.add_sphere((0.0, 0.0, 4.0), 1.0, m)
    b.add_sphere((2.0, 0.5, 5.0), 0.7, m)
    b.add_box((-2.0, 0.0, 5.0), (0.5, 0.5, 0.5), m)
    b.add_torus((0.0, 1.5, 6.0), (1.0, 0.3), m)
    b.add_ring((0.0, 2.5, 6.0), 0.5, 1.0, m)
    b.add_light_point((3.0, 5.0, 0.0), (1.0, 1.0, 1.0), 25.0)
    b.add_light_direct((0.3, -1.0, 0.2), (1.0, 1.0, 1.0), 0.6)
    return b.build()


@pytest.mark.parametrize("which", ["demo", "planes"])
def test_prices_match_jax(which):
    if which == "demo":
        jscene, tscene = jdemo.build_scene(W, H)[0], tdemo.build_scene(W, H)[0]
    else:
        jscene, tscene = _planes_scene(jfactories), _planes_scene(tfactories)
    jc, tc = dict(jscene.counts), dict(tscene.counts)
    assert tc == jc
    assert flops.TEST_FLOPS == jflops.TEST_FLOPS and flops.ACCEPT_FLOPS == jflops.ACCEPT_FLOPS
    n_lights = tc["lights_point"] + tc["lights_direct"]
    assert flops.sweep_flops(tc) == jflops.sweep_flops(jc)
    for one_side in (True, False):
        assert flops.shadow_flops(tc, one_side) == jflops.shadow_flops(jc, one_side)
    for shadows in (True, False):
        assert flops.step_flops(tc, n_lights, shadows) == jflops.step_flops(jc, n_lights, shadows)
    live = [1.0, 0.3, 0.1, 0.02, 0.0]
    for shadows in (True, False):
        tcfg = RenderConfig(width=W, height=H, shadow_enabled=shadows)
        jcfg = jtr.RenderConfig(width=W, height=H, shadow_enabled=shadows)
        assert (flops.frame_flops_per_ray(tscene, tcfg, live)
                == jflops.frame_flops_per_ray(jscene, jcfg, live))
    if which == "planes":
        assert tc["planes"] == 2 and flops.shadow_flops(tc, False) > flops.shadow_flops(tc)


def _close(a, b):
    return np.all(np.abs(a - b) <= 1e-3 * (1.0 + np.abs(b)), axis=-1)


def test_live_fractions_match_jax_make_step():
    """Step by step, the port's live lanes are JAX's but for lanes whose
    rays part at a step whose ray crosses the torus's bounding sphere: the
    JAX package's float32 root polish on the expanded quartic finds hits
    near the torus's silhouette that the port's factored polish (and the
    f64 oracle) do not (txr_torch/geometry/torus.py).  ``live_fractions``
    counts the port's live lanes before each step."""
    cfg = dict(width=W, height=H, iterations=5, extra_refraction_steps=6)
    jscene, _ = jdemo.build_scene(W, H)
    jcfg = jtr.RenderConfig(**cfg, ray_chunk=0, gating=False)
    jstep = jax.jit(jtr.make_step(jscene, jax.jit(jwith_mips)(jdemo.demo_textures()), jcfg))
    jst = jtr.initial_state(*jprimary_rays(jscene.camera, W, H, 1))
    tscene, _ = tdemo.build_scene(W, H)
    textures = with_mips(tdemo.demo_textures())
    tcfg = RenderConfig(**cfg)
    tstep = ttr.make_step(tscene, textures, tcfg, pack_scene(tscene, textures.atlas))
    tst = ttr.initial_state(*primary_rays(tscene.camera, W, H, 1))
    _, sec = sections(*pack_scene(tscene, None))
    parted = np.zeros(W * H, bool)
    counts = []
    for _ in range(jcfg.max_steps):
        counts.append(int(tst["alive"].sum()))
        (cross,) = flops._crossing(sec, tst["ro"].double(), tst["rd"].double())
        jst = jstep(jst)
        with torch.no_grad():
            tst = tstep(tst)
        j = {k: np.asarray(v) for k, v in jst.items()}
        t = {k: v.numpy() for k, v in tst.items()}
        same = ((j["alive"] == t["alive"]) & (j["missed"] == t["missed"])
                & (j["bounces"] == t["bounces"]) & _close(t["ro"], j["ro"])
                & _close(t["rd"], j["rd"]))
        new = ~same & ~parted
        assert cross.numpy()[new].all(), np.nonzero(new & ~cross.numpy())
        parted |= new
        assert (j["alive"] == t["alive"])[~parted].all()
    assert parted.sum() <= 0.025 * W * H, parted.sum()      # 23 of 1296 lanes
    got = flops.live_fractions(tscene, tdemo.demo_textures(), tcfg, device="cpu")
    assert [round(f * W * H) for f in got] == counts
    assert got[0] == 1.0 and 0 < got[1] < 1


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_launch_prices_at_most_twin_work(fused):
    scene, _ = tdemo.build_scene(W, H)
    cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6, fused=fused)
    textures = with_mips(tdemo.demo_textures())
    with torch.no_grad(), flops.priced_launches() as calls:
        render(scene, textures, cfg, device="cpu")
    c = scene.counts
    L = c["lights_point"] + c["lights_direct"]
    table = pack_scene(scene, textures.atlas)[0].numel() * 4
    full = dict(step_probe=(flops.step_flops(c, L), 24 + 4 * n_rows(c) + 12),
                glossy_rays=flops.glossy_lane_most(),
                step_consume=flops.consume_lane_most(c),
                nearest_hit=(flops.sweep_flops(c), 24 + 8),
                shadow_sweep=(flops.shadow_flops(c), 28 + 4 + 12 * c["rings"]))
    kernels = {"auto": {"step_probe", "glossy_rays", "step_consume"},
               "off": {"nearest_hit", "shadow_sweep"}}[fused]
    assert {k["kernel"] for k in calls} == kernels
    for call in calls:
        ops, nbytes = full[call["kernel"]]
        assert call["ops"] <= call["live"] * ops, call
        assert call["bytes"] <= call["lanes"] * nbytes + table, call
        assert (call["ops"] > 0) == (call["live"] > 0), call
        assert call["bound_ms"] == flops.bound_ms(call["ops"], call["bytes"])
    # the cuts priced something less than the full work somewhere
    assert sum(k["ops"] for k in calls) < sum(k["live"] * full[k["kernel"]][0] for k in calls)


def test_torus_crossing_within_kernel_cull():
    scene, _ = tdemo.build_scene(W, H)
    buf, hdr = pack_scene(scene, None)
    _, sec = sections(buf, hdr)
    rng = np.random.default_rng(0)
    TO = sec["toruses"]
    centre = TO[0, 0:3].astype(np.float64)
    ro = centre + rng.normal(size=(20000, 3)) * 40.0
    aim = centre + rng.normal(size=(20000, 3)) * float(TO[0, 7] + TO[0, 8]) * 1.5
    rd = (aim - ro) / np.linalg.norm(aim - ro, axis=-1, keepdims=True)
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    (cross,) = flops._crossing(sec, o, d)
    o32, d32 = o.float().unbind(-1), d.float().unbind(-1)
    lo, ld = prim._torus_local(TO[:, 0:3], TO[:, 3:7], 0, o32, d32)
    kept = ~prim._torus_culled(lo, ld, TO[0, 7], TO[0, 8])
    assert 0 < int(cross.sum()) < cross.numel()
    assert not bool((cross & ~kept).any())


def test_consume_calls_of_a_frame_priced_one_for_one(monkeypatch):
    """render_jit's frame at 48×27 on the CPU, whose pieces run eagerly (as
    ``profile_frame.uncaptured`` runs them on the card): each call of the
    consume's two wrappers is priced once, under its own kernel's name, a
    consume call at least at its live lanes' state read and write and t,
    and a glossy-rays call at its live lanes' bits; a lane that is not live
    adds nothing."""
    from txr_torch.render import fused as tfused
    from txr_torch.render import render as rr

    scene, _ = tdemo.build_scene(W, H)
    cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
    twins = []
    for name in ("glossy_rays_ref", "step_consume_ref"):
        def counted(*a, _twin=getattr(tfused, name), _name=name, **k):
            twins.append(_name)
            return _twin(*a, **k)
        monkeypatch.setattr(tfused, name, counted)
    rr.clear_jit_cache()
    try:
        with torch.no_grad(), flops.priced_launches() as calls:
            rr.render_jit(scene, tdemo.demo_textures(), cfg, device="cpu")
    finally:
        rr.clear_jit_cache()
    mine = [c for c in calls if c["kernel"] in ("glossy_rays", "step_consume")]
    assert len(mine) == len(twins) and twins.count("step_consume_ref") >= 4
    assert twins[:2] == ["glossy_rays_ref", "step_consume_ref"]
    for call, twin in zip(mine, twins):
        assert call["kernel"] == twin[:-len("_ref")], (call, twin)
        floor = 2 * call["live"] if twin == "glossy_rays_ref" else (
            (2 * flops.STATE_BYTES + 4) * call["live"])
        assert call["bytes"] >= floor, call
        assert (call["ops"] > 0) == (call["live"] > 0), call
        assert call["bound_ms"] == flops.bound_ms(call["ops"], call["bytes"])
        assert call["bound_ms"] > 0 or call["live"] == 0, call
    assert sum(c["live"] for c in mine) > 0


def test_lane_map_calls_priced_one_for_one(monkeypatch):
    """render_jit's frame with the card's compacted capacities forced (the
    CPU steps every lane): each ``lane_map.compact`` and ``scatter`` call is
    priced once, by bytes alone, at least the live rows moved in and out
    and at most every row of the map and the alive bytes."""
    from txr_torch.render import graphs
    from txr_torch.render import render as rr

    monkeypatch.setattr(graphs, "capacities",
                        lambda R, dev: [R] + [c for c in (512, 256, 128) if c < R])
    scene, _ = tdemo.build_scene(W, H)
    cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
    rr.clear_jit_cache()
    try:
        with torch.no_grad(), flops.priced_launches() as calls:
            rr.render_jit(scene, tdemo.demo_textures(), cfg, device="cpu")
        (frame,) = rr._FRAMES.values()
        (unit,) = frame.programs[0].units.values()
    finally:
        rr.clear_jit_cache()
    compacts = [c for c in calls if c["kernel"] == "lane_compact"]
    scatters = [c for c in calls if c["kernel"] == "lane_scatter"]
    # one call a step run below R (the CPU runs no warm-up)
    below = [C for C in unit.steps_run if C < unit.R]
    assert below and [c["lanes"] for c in compacts] == below and len(scatters) == len(below)
    R, S = unit.R, flops.STATE_BYTES
    for c, s in zip(compacts, scatters):
        C, live = c["lanes"], c["live"]
        assert (s["lanes"], s["live"]) == (C, live) and live <= C
        assert c["ops"] == s["ops"] == 0
        assert R + (S + 8) * C + S * live <= c["bytes"] <= R + (2 * S + 8) * C + S
        assert s["bytes"] == 8 * C + 2 * S * live + 8
        assert c["bound_ms"] == flops.bound_ms(0, c["bytes"])


def test_flops_imports_no_jax():
    """Neither flops.py's own imports nor the modules a fresh interpreter
    loads with it name jax, jaxlib or txr."""
    root = pathlib.Path(__file__).resolve().parents[1]
    tree = ast.parse((root / "txr_torch" / "utils" / "flops.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    jaxy = ("jax", "jaxlib", "txr")
    assert names and not [n for n in names if n.split(".")[0] in jaxy], names
    run = subprocess.run(
        [sys.executable, "-c", "import sys, txr_torch.utils.flops; "
         f"print(sorted(m for m in sys.modules if m.split('.')[0] in {jaxy!r}))"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]", run.stdout
