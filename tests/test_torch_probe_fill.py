"""The step probe's fill bit (``FLAG_FILL``; kernels/csrc/step_probe.cu,
"Lanes"): a probe whose rows a VJP saves stores fill rows on the lanes no
consume kernel reads, any other probe stores only the rows its readers read.

On the CPU (tier 1):

* ``set_flags`` sets and clears ``FLAG_FILL`` and leaves the other bits as
  they were; the kernels' header has the table's flag values;
* through a ``render_jit`` frame, the step's probe and the glossy probe of
  every forward step ask for no fills; through a captured train step the
  step's probe, whose rows ``trace.step_saving`` saves, asks for them and
  the glossy probe does not;
* the tracer's ``unfilled`` counter adds 2 a forward step (1 without the
  glossy pass) and 1 a train step (its glossy probe), nothing on the eager
  route, and nothing where every probe fills: it counts the calls made;
* ``utils/flops.step_probe_work`` prices a probe without fills by the rows
  it stores (t alone on a miss, no light rows on a light bulb), and with
  them by every row of each live lane.

On the card (marker ``card``; no JAX, so the file runs alone there,
without the CPU suite's conftest:
``python -m pytest --noconftest -m card tests/test_torch_probe_fill.py``):

* on a full-width and a compacted step of the 1080p demo frame at
  t = 60.5 s, probes run without fills into rows set to NaN beforehand
  leave the lanes they skip as NaN, equal the filled rows wherever a
  reader reads, and give ``glossy_rays`` and ``step_consume`` the next
  state that filled rows give, bit for bit;
* ``render_jit``'s 1 spp and ultra 1080p frames are ``render``'s, and the
  frames of every probe filling, bit for bit;
* the captured fit step's first loss and gradients at a fixed pose are
  those of every probe filling (the saved rows always were), bit for bit.
"""

import pathlib
import re

import pytest
import torch

from txr_torch.kernels import scene_table
from txr_torch.kernels import step_probe as sp
from txr_torch.render import fused as rfused

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

CUH = pathlib.Path(sp.__file__).parent / "csrc" / "txr_common.cuh"
FLAGS = ("one_side", "shadow_enabled", "do_fresnel", "tir", "shade_flipped", "fill")


@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("others", [True, False])
def test_set_flags_round_trips_the_fill_bit(fill, others):
    hdr = tuple(range(scene_table.HDR_LEN))
    kw = dict.fromkeys(FLAGS[:-1], others)
    out = scene_table.set_flags(hdr, **kw, fill=fill)
    assert out[:9] + out[10:] == hdr[:9] + hdr[10:]
    assert bool(out[9] & scene_table.FLAG_FILL) == fill
    assert out[9] & ~scene_table.FLAG_FILL == scene_table.set_flags(hdr, **kw, fill=False)[9]
    again = scene_table.set_flags(out, **kw, fill=not fill)
    assert bool(again[9] & scene_table.FLAG_FILL) != fill
    assert scene_table.set_flags(again, **kw, fill=fill) == out
    # the default, and the header pack_scene gives, keep today's fills
    assert scene_table.set_flags(hdr)[9] & scene_table.FLAG_FILL


def test_the_kernels_flags_are_the_tables():
    text = CUH.read_text()
    decl = re.search(r"constexpr int (FLAG_ONE_SIDE[^;]*);", text).group(1)
    kernel = {k.strip(): int(v) for k, v in (p.split("=") for p in decl.split(","))}
    table = {k: getattr(scene_table, k) for k in kernel}
    assert kernel == table and kernel["FLAG_FILL"] == 32
    assert len(set(kernel.values())) == len(kernel)


# ---- who asks for fills, on the CPU ----------------------------------------

W, H = 32, 18
# test_torch_tracing.py's fit: a sphere moved, resized and recoloured
TRUE = ((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
GUESS = ((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2))


@pytest.fixture(scope="module")
def demo():
    from txr_torch.apps import demo as tdemo
    from txr_torch.render.texture import with_mips

    scene, handles = tdemo.build_scene(W, H)
    return tdemo.update_scene(scene, handles, 0.0, 60.5), with_mips(tdemo.demo_textures())


def _spy(monkeypatch):
    """Every call of the step probe as (shade_flipped, fill): the step's
    own probe shades with the flipped normal, the glossy probe without."""
    calls, probe = [], rfused.step_probe

    def spy(*args, **kw):
        calls.append((kw["shade_flipped"], kw["fill"]))
        return probe(*args, **kw)

    monkeypatch.setattr(rfused, "step_probe", spy)
    return calls


def _fit(cfg):
    from txr_torch.apps import inverse as tinv
    from txr_torch.diff import optimize as om
    from txr_torch.render import render as rr
    from txr_torch.render.texture import TextureSet

    target = rr.render(tinv.make_scene(*TRUE), TextureSet(), cfg, device="cpu")
    return om._Fit(tinv.make_scene(*GUESS), TextureSet(), cfg, target, device="cpu")


def test_a_forward_frame_asks_for_no_fills(demo, monkeypatch):
    from txr_torch.render import render as rr
    from txr_torch.render.trace import RenderConfig

    cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
    rr.clear_jit_cache()
    calls = _spy(monkeypatch)
    try:
        with torch.no_grad():
            rr.render_jit(*demo, cfg, device="cpu")     # warm-up, capture and run
            rr.render_jit(*demo, cfg, device="cpu")     # a replay
    finally:
        rr.clear_jit_cache()
    assert set(calls) == {(True, False), (False, False)}
    assert calls.count((True, False)) == calls.count((False, False))


def test_a_train_step_fills_the_saved_probe_alone(monkeypatch):
    from txr_torch.render import render as rr
    from txr_torch.render.trace import RenderConfig

    rr.clear_jit_cache()
    fit = _fit(RenderConfig(width=24, height=24, iterations=2))
    calls = _spy(monkeypatch)
    try:
        for i in range(2):
            fit.step(i)
    finally:
        fit.close()
        rr.clear_jit_cache()
    assert set(calls) == {(True, True), (False, False)}
    assert calls.count((True, True)) == calls.count((False, False))


@pytest.mark.parametrize("what,glossy,fused,per_step", [
    ("frame", True, "auto", 2), ("frame", False, "auto", 1), ("train", True, "auto", 1),
    ("train", False, "auto", 0), ("frame", True, "off", 0)])
def test_unfilled_counter(demo, what, glossy, fused, per_step):
    from txr_torch.render import render as rr
    from txr_torch.render.trace import RenderConfig
    from txr_torch.utils import profiling

    rr.clear_jit_cache()
    profiling.reset()
    profiling.tracing(True)
    try:
        if what == "frame":
            cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6,
                               refractive_glossy=glossy, fused=fused)
            with torch.no_grad():
                rr.render_jit(*demo, cfg, device="cpu")
        else:
            fit = _fit(RenderConfig(width=24, height=24, iterations=2, refractive_glossy=glossy,
                                    fused=fused))
            profiling.reset()
            fit.step(0)
            fit.close()
        (rec,) = profiling.records()
    finally:
        profiling.tracing(False)
        profiling.reset()
        rr.clear_jit_cache()
    c = rec["counters"]
    assert sum(c["steps"]) > 1
    assert sum(c.get("unfilled", [])) == per_step * sum(c["steps"])
    assert c.get("unfilled", []) == [per_step] * (sum(c["steps"]) if per_step else 0)


def test_unfilled_counter_counts_the_calls_made(demo, monkeypatch):
    from txr_torch.render import render as rr
    from txr_torch.render.trace import RenderConfig
    from txr_torch.utils import profiling

    cfg = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
    _every_probe_fills(monkeypatch)
    rr.clear_jit_cache()
    profiling.reset()
    profiling.tracing(True)
    try:
        with torch.no_grad():
            rr.render_jit(*demo, cfg, device="cpu")
        (rec,) = profiling.records()
    finally:
        profiling.tracing(False)
        profiling.reset()
        rr.clear_jit_cache()
    assert sum(rec["counters"]["steps"]) > 1 and "unfilled" not in rec["counters"]


@pytest.mark.parametrize("masked", [False, True])
def test_the_probe_is_priced_by_the_rows_it_stores(demo, masked):
    from txr_torch.kernels.primitives import INF_T
    from txr_torch.kernels.scene_table import pack_scene, sections
    from txr_torch.utils import flops

    scene, tex = demo
    buf, hdr = pack_scene(scene, tex.atlas)
    cnt, sec = sections(buf, hdr)
    g = torch.Generator().manual_seed(1)
    # rays at the point light's bulb from 2 away, then random rays
    bulb = torch.tensor(sec["lights_point"][0, 0:3].copy(), dtype=torch.float32)
    at = bulb + torch.nn.functional.normalize(torch.randn(64, 3, generator=g), dim=-1) * 2.0
    ro = torch.cat([at, torch.rand(512, 3, generator=g) * 16.0 - 8.0]).contiguous()
    rd = torch.cat([bulb - at, torch.randn(512, 3, generator=g)])
    rd = torch.nn.functional.normalize(rd, dim=-1).contiguous()
    alive = (torch.rand(ro.shape[0], generator=g) < 0.7).contiguous() if masked else None
    f, i = sp.step_probe_ref(buf, hdr, ro, rd, 0.0, alive)
    live = torch.ones(ro.shape[0], dtype=torch.bool) if alive is None else alive
    hit = live & (f[0] < INF_T)
    bulbs = hit & (i[0] >= sum(cnt[k] for k in scene_table.SLOT_ORDER[:-1]))
    n_miss, n_bulb = int((live & ~hit).sum()), int(bulbs.sum())
    assert n_miss and n_bulb and int((hit & ~bulbs).sum())
    ops, filled = flops.step_probe_work(buf, hdr, ro, rd, alive, f, i)
    bare_hdr = scene_table.set_flags(hdr, fill=False)
    ops_bare, bare = flops.step_probe_work(buf, bare_hdr, ro, rd, alive, f, i)
    row = 4 * sp.n_rows(cnt) + 12
    assert ops_bare == ops
    assert filled == int(live.sum()) * (24 + row) + buf.numel() * 4
    assert filled - bare == n_miss * (row - 4) + n_bulb * (row - (4 * 23 + 12))


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _demo_1080p(card, width=1920, height=1080, t=60.5):
    from txr_torch.apps import demo as tdemo
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig

    scene, handles = tdemo.build_scene(width, height)
    posed = tdemo.update_scene(scene.to(card), handles, 0.0, t)
    cfg = RenderConfig(width=width, height=height, iterations=5, extra_refraction_steps=6)
    return posed, with_mips(tdemo.demo_textures().to(card)), cfg


def _bits(v):
    return v.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


NAN_BITS = 0x7FC00000


def _probe_over_nan(scene, tex, cfg, table, ro, rd, shade_flipped, alive):
    """The kernel without fills, launched into rows set to NaN (and ints to
    NaN's bits) beforehand, as ``launch`` would launch it → ``Rows``."""
    from txr_torch.kernels import build
    from txr_torch.render.trace import _pix_angle

    buf, hdr = table
    hdr = scene_table.set_flags(hdr, one_side=cfg.plane_oneside,
                                shadow_enabled=cfg.shadow_enabled, do_fresnel=cfg.do_fresnel,
                                tir=cfg.total_internal_reflection,
                                shade_flipped=shade_flipped, fill=False)
    N = ro.shape[0]
    f = torch.full((sp.n_rows(scene.counts), N), float("nan"), device=ro.device)
    i = torch.full((3, N), NAN_BITS, dtype=torch.int32, device=ro.device)
    mask = scene_table.check_mask("step_probe", ro.device, alive, N)
    build.run("step_probe", "txr_step_probe", sp._ARGS, ro.device, hdr, buf.data_ptr(),
              float(_pix_angle(cfg) or 0.0), ro.data_ptr(), rd.data_ptr(), mask.data_ptr(),
              f.data_ptr(), i.data_ptr(), N, 0, None, None)
    return sp.Rows(f, i, scene.counts)


def _rows_read_are_filled_rows(scene, nofill, filled, alive):
    """The rows a reader reads are the filled probe's; no other lane or row
    was stored: t on every live lane, the base rows and ints on a live hit,
    every row on a live hit that shades; NaN wherever nothing is read."""
    n_lp = scene.counts["lights_point"]
    b_lp = sum(scene.counts[k] for k in scene_table.SLOT_ORDER) - n_lp
    f, i, F, I = nofill.f, nofill.i, filled.f, filled.i
    hit = alive & (F[0] < 1e30)
    shades = hit & (I[0] < b_lp)
    assert _same(f[0][alive], F[0][alive])
    assert _same(f[:23, hit], F[:23, hit]) and _same(i[:, hit], I[:, hit])
    assert _same(f[:, shades], F[:, shades])
    assert torch.isnan(f[:, ~alive]).all() and (i[:, ~alive] == NAN_BITS).all()
    miss = alive & ~hit
    assert torch.isnan(f[1:, miss]).all() and (i[:, miss] == NAN_BITS).all()
    assert torch.isnan(f[23:, hit & ~shades]).all()
    return int(alive.sum()), int(miss.sum()), int((hit & ~shades).sum())


def _step_both_ways(scene, tex, cfg, table, st):
    """One bounce step from the state ``st`` with filled rows (the default
    probe) and with rows stored without fills over NaN → both next states,
    and the live, miss and bulb lanes of each probe."""
    pr = rfused._probe(scene, tex, cfg, st["ro"], st["rd"], True, table, st["alive"])
    pr_n = _probe_over_nan(scene, tex, cfg, table, st["ro"], st["rd"], True, st["alive"])
    seen = [_rows_read_are_filled_rows(scene, pr_n, pr, st["alive"])]
    glossy, ro_g, rd_g = rfused.glossy_rays(scene, st, pr, table)
    glossy_n, ro_gn, rd_gn = rfused.glossy_rays(scene, st, pr_n, table)
    assert torch.equal(glossy, glossy_n)
    assert _same(ro_g[glossy], ro_gn[glossy]) and _same(rd_g[glossy], rd_gn[glossy])
    gpr = rfused._probe(scene, tex, cfg, ro_g, rd_g, False, table, glossy)
    gpr_n = _probe_over_nan(scene, tex, cfg, table, ro_gn, rd_gn, False, glossy_n)
    seen.append(_rows_read_are_filled_rows(scene, gpr_n, gpr, glossy))
    out = rfused.step_consume(scene, tex, cfg, st, pr, gpr, table)
    out_n = rfused.step_consume(scene, tex, cfg, st, pr_n, gpr_n, table)
    return out, out_n, seen


@pytest.mark.card
def test_unfilled_rows_give_the_filled_rows_next_state(card):
    from txr_torch.kernels import lane_map
    from txr_torch.kernels.scene_table import pack_scene
    from txr_torch.kernels.step_consume import STATE_KEYS
    from txr_torch.render import graphs
    from txr_torch.render import render as rr
    from txr_torch.render import trace as tr

    scene, tex, cfg = _demo_1080p(card)
    states, step = [], tr._fused_step

    def record(scene, textures, cfg, st, *args, **kw):
        states.append(st)
        return step(scene, textures, cfg, st, *args, **kw)

    tr._fused_step = record
    try:
        with torch.no_grad():
            rr.render(scene, tex, cfg, device=card)
    finally:
        tr._fused_step = step
    table = pack_scene(scene, tex.atlas)
    R = 1920 * 1080
    full = states[0]
    live = int(states[2]["alive"].sum())
    C = min(c for c in graphs.capacities(R, card) if c >= live)
    assert C < R
    _, compacted, _ = lane_map.compact(states[2], C)
    with torch.no_grad():
        for st, rows in ((full, R), (compacted, C)):
            out, out_n, seen = _step_both_ways(scene, tex, cfg, table, st)
            (live_s, miss_s, bulb_s), (live_g, _, _) = seen
            assert st["alive"].shape[0] == rows and live_s and miss_s and live_g
            assert rows == R or live_s < rows
            for k in STATE_KEYS:
                assert _same(out[k], out_n[k]), k


def _every_probe_fills(monkeypatch):
    probe = rfused.step_probe
    monkeypatch.setattr(rfused, "step_probe", lambda *a, **kw: probe(*a, **dict(kw, fill=True)))


@pytest.mark.card
@pytest.mark.parametrize("preset", [None, "ultra"])
def test_render_jit_frames_are_renders_and_the_filled(card, monkeypatch, preset):
    from txr_torch.render import render as rr

    scene, tex, cfg = _demo_1080p(card)
    cfg = cfg.with_aa_preset(preset) if preset else cfg
    rr.clear_jit_cache()
    try:
        with torch.no_grad():
            jit = rr.render_jit(scene, tex, cfg, device=card).clone()
            jit2 = rr.render_jit(scene, tex, cfg, device=card).clone()
            ref = rr.render(scene, tex, cfg, device=card)
            _every_probe_fills(monkeypatch)
            rr.clear_jit_cache()
            filled = rr.render_jit(scene, tex, cfg, device=card).clone()
            filled_ref = rr.render(scene, tex, cfg, device=card)
    finally:
        rr.clear_jit_cache()
    assert _same(jit, ref) and _same(jit2, ref)
    assert _same(filled, ref) and _same(filled_ref, ref)


@pytest.mark.card
def test_fit_steps_first_gradient_is_the_filled_paths(card, monkeypatch):
    from txr_torch.diff.optimize import _Fit
    from txr_torch.render import render as rr

    scene, tex, cfg = _demo_1080p(card, 480, 270)

    def first_step():
        rr.clear_jit_cache()
        fit = _Fit(scene, tex, cfg, torch.zeros((270, 480, 3), device=card), lr=0.0, device=card)
        loss, _ = fit.step(0)
        grads = {p: v.grad.clone() for p, v in fit.params.items() if v.grad is not None}
        fit.close()
        rr.clear_jit_cache()
        return loss.clone(), grads

    loss, grads = first_step()
    _every_probe_fills(monkeypatch)
    f_loss, f_grads = first_step()
    assert _same(loss, f_loss) and grads.keys() == f_grads.keys() and grads
    for p in grads:
        assert _same(grads[p], f_grads[p]), p
