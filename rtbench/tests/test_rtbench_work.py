"""The frozen work model (rtbench/work/prices.py): it prices a launch as the
program's utils/flops.py does at the same lane counts, and it is given
lane counts that the reference's own run makes."""

from __future__ import annotations

import pytest
import torch

from rtbench import scenedata, system, textures
from rtbench.reference import render as ref
from rtbench.work import prices

W, H, T0 = 48, 27, 60.4


@pytest.fixture(scope="module")
def demo():
    torch.set_num_threads(2)
    cfg = scenedata.load_config("demo-1080p")
    raw = textures.make(cfg, 21, torch.device("cpu"))
    scene, handles = system.scene(cfg, "cpu")
    return cfg, raw, system.pose(scene, handles, T0), system.textures(cfg, raw)


def _probe_counts(flops, buf, hdr, ro, rd, alive, f, i):
    from txr_torch.kernels.scene_table import FLAG_SHADOW, SLOT_ORDER, sections

    cnt, sec = sections(buf, hdr)
    lanes = flops._live(alive)
    o, d = flops._rows(ro, lanes).double(), flops._rows(rd, lanes).double()
    rec = dict(live=o.shape[0], cross=[int(c.sum()) for c in flops._crossing(sec, o, d)],
               shadows=[])
    L = cnt["lights_point"] + cnt["lights_direct"]
    if not (L and hdr[9] & FLAG_SHADOW):
        return cnt, rec
    fl = flops._rows(f.T, lanes)
    t = fl[:, 0].double()
    shaded = (t < flops._INF_T) & (flops._rows(i[0], lanes) < sum(cnt[k] for k in SLOT_ORDER[:-1]))
    t, o, d, n = t[shaded], o[shaded], d[shaded], fl[shaded, 1:4].double()
    solid = fl[shaded, flops._BASE_ROWS:].reshape(-1, L, 3 + 3 * cnt["rings"])[:, :, 2] > 0.5
    so = o + d * t[:, None] + n * ((9e-3 * t + 35.0) / 35e3)[:, None]
    lights = [torch.tensor(p[0:3].tolist(), dtype=torch.float64) - so
              for p in sec["lights_point"]]
    lights += [torch.tensor((-p[0:3]).tolist(), dtype=torch.float64).expand(so.shape)
               for p in sec["lights_direct"]]
    for l, toward in enumerate(lights):
        clear = ~solid[:, l]
        rec["shadows"].append(dict(n=so.shape[0], solid=int(solid[:, l].sum()),
                                   cross_clear=[int(c.sum()) for c in
                                                flops._crossing(sec, so[clear], toward[clear])]))
    return cnt, rec


def _consume_counts(flops, buf, hdr, tex, cfg, st, f, i, gf, gi):
    from txr_torch.kernels.scene_table import SLOT_ORDER, counts_of, sections

    cnt = counts_of(hdr)
    L = cnt["lights_point"] + cnt["lights_direct"]
    n_surf = sum(cnt[k] for k in SLOT_ORDER[:-1])
    ring_textured = sections(buf, hdr)[1]["shade"][6 + 3 * L:]

    def part(f_, i_, mask):
        lanes = torch.nonzero(mask).squeeze(-1)
        texels, textured = flops._atlas_texels(tex.atlas, cfg, cnt, f_, i_, lanes)
        ring = flops._ring_alpha_texels(tex, cnt, ring_textured, f_, lanes)
        return dict(lanes=lanes.numel(), textured=textured, texels=texels, ring_texels=ring)

    alive = st["alive"]
    hit = alive & (f[0] < flops._INF_T)
    surf = hit & (i[0] < n_surf)
    refractive = surf & (f[19] > 0.0)
    glossy = refractive & (f[4] > 0.5) & (f[18] > 0.0)
    ghit = glossy & (gf[0] < flops._INF_T)
    return cnt, dict(live=int(alive.sum()), hit=int(hit.sum()), surf=int(surf.sum()),
                     refr_inside=int((refractive & ~(f[4] > 0.5)).sum()),
                     glossy=int(glossy.sum()), glossy_hit=int(ghit.sum()),
                     parts=[part(f, i, surf & ~refractive),
                            part(gf, gi, ghit & (gi[0] < n_surf))])


def test_prices_equal_the_programs_at_the_same_counts(demo, monkeypatch):
    from txr_torch.render.render import render
    from txr_torch.utils import flops

    cfg, _, posed, tex = demo
    rc = system.render_config(cfg, W, H)
    seen = {"probe": [], "rays": [], "consume": []}

    def spy(kind, fn):
        def wrapped(*a):
            out = fn(*a)
            seen[kind].append((a, out))
            return out
        return wrapped

    monkeypatch.setattr(flops, "step_probe_work", spy("probe", flops.step_probe_work))
    monkeypatch.setattr(flops, "glossy_rays_work", spy("rays", flops.glossy_rays_work))
    monkeypatch.setattr(flops, "step_consume_work", spy("consume", flops.step_consume_work))
    with torch.no_grad(), flops.priced_launches():
        render(posed, tex, rc, device="cpu")
    assert all(seen.values())
    for (buf, hdr, *rest), want in seen["probe"]:
        cnt, rec = _probe_counts(flops, buf, hdr, *rest)
        assert prices.probe(cnt, hdr[8], rec) == pytest.approx(want, rel=1e-12)
    from txr_torch.kernels.scene_table import SLOT_ORDER, counts_of

    for (buf, hdr, st, f, i, glossy), want in seen["rays"]:
        cnt = counts_of(hdr)
        alive = st["alive"]
        hit = alive & (f[0] < flops._INF_T)
        surf = hit & (i[0] < sum(cnt[k] for k in SLOT_ORDER[:-1]))
        rec = dict(live=int(alive.sum()), hit=int(hit.sum()), surf=int(surf.sum()),
                   glossy=int(glossy.sum()))
        assert prices.glossy_rays(rec) == pytest.approx(want, rel=1e-12)
    for (buf, hdr, tx, c, st, f, i, gf, gi), want in seen["consume"]:
        cnt, rec = _consume_counts(flops, buf, hdr, tx, c, st, f, i, gf, gi)
        assert prices.consume(cnt, rec) == pytest.approx(want, rel=1e-12)


def test_lane_counts_come_from_the_reference_and_match_the_programs(demo):
    """The reference's live lanes per bounce step, which the work model
    prices, against the program's own count of the same frame: lanes may
    part only where a float32 torus root falls the other way."""
    from txr_torch.utils.flops import live_fractions

    cfg, raw, posed, tex = demo
    rc = system.render_config(cfg, W, H)
    port = [round(x * W * H) for x in live_fractions(posed, tex, rc, device="cpu")]
    tally = []
    with torch.no_grad():
        ref.render(ref.Scene(cfg, T0), ref.Textures(cfg, raw), ref.settings(cfg, W, H),
                   tally=tally)
    mine = [s["probe"]["live"] for s in tally[0]["steps"]]
    assert mine[0] == W * H
    for a, b in zip(mine, port):
        assert abs(a - b) <= 0.025 * W * H
    least = prices.frame(prices_counts(cfg), 5, tally)
    assert all(least[k]["least_ms"] > 0 for k in ("step_probe", "glossy_rays", "step_consume"))


def prices_counts(cfg):
    rows = scenedata.scene_rows(cfg)
    return {k: len(rows[k]) for k in ("spheres", "planes", "surfaces", "boxes", "toruses",
                                      "rings", "lights_point", "lights_direct")}
