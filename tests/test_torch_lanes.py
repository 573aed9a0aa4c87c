"""Lane masks and early outs of the three kernels, on their plain twins.

The kernels skip work their callers never read: the probe and the
nearest-hit sweep trace only the ``alive`` lanes, the probe shades only the
live lanes that hit something other than a light bulb, the shadow sweep
traces only the ``need`` rays, a shadow ray stops at its first solid
occluder, and the torus's Ferrari solve runs only on lines that cross its
inflated bounding sphere.  A skipped lane holds a fixed fill, the same in
kernel and twin (the card compares the two: ``chip_smoke.py``).  Here, on
the CPU:

- the culled torus test equals the uncut one, bit for bit, on seeded random
  rays and on rays tangent to, just inside and just outside the bounding
  sphere, near and far, for three torus poses;
- the any-hit bit is the OR over the occluders in the kernel's order;
- the probe and nearest-hit twins with ``alive`` equal the twins without
  it on live lanes, bit for bit, and hold the fills on the others;
  likewise the shadow twin with ``need``;
- the nearest-hit library is one per scene topology, and the sweep's slot
  lookup is built once per topology, not per call;
- 32×18 demo renders on each route are bit-identical with the masks dropped
  (the calls monkeypatched), and the 16×9 gradients agree within 1e-6.

The JAX comparisons of these twins are in test_torch_probe.py,
test_torch_intersect.py, test_torch_render.py and test_torch_grads.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from txr_torch.apps import demo as tdemo
from txr_torch.geometry import torus as ttorus
from txr_torch.kernels import build as kbuild
from txr_torch.kernels import nearest_hit as tnh
from txr_torch.kernels import primitives as prim
from txr_torch.kernels import shadow_sweep as tss
from txr_torch.kernels import step_probe as tsp
from txr_torch.kernels.scene_table import (
    SLOT_ORDER,
    check_mask,
    occluder_tests,
    occlusion_ref,
    pack_scene,
    sections,
)
from txr_torch.render import fused as rfused
from txr_torch.render import intersect as rint
from txr_torch.render import render as rr
from txr_torch.render.raygen import primary_rays
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, auto_refraction_steps
from txr_torch.scene.types import float_leaves

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 32, 18
N_RANDOM = 1536


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _quat(rng):
    return _unit(rng.normal(size=4)).astype(np.float32)


# the demo's torus, then two random poses: a fat and a thin ring
POSES = {
    "demo": (np.array([-9.0, 0.5, 6.0], np.float32), np.array([0, 0, 0, 1], np.float32),
             np.array([1.0, 0.5], np.float32)),
    "fat": (np.array([0.3, -0.2, 4.0], np.float32), _quat(np.random.default_rng(11)),
            np.array([1.2, 0.9], np.float32)),
    "thin": (np.array([2.0, 1.0, -3.0], np.float32), _quat(np.random.default_rng(12)),
             np.array([2.5, 0.1], np.float32)),
}


def _torus_rays(pos, form, rng):
    """4096 random rays within 30 units, plus rays tangent to spheres of
    radius (R + r)(1 + s) for s from -1e-2 to 5e-1, from 0.3 to 150 units
    before and after the tangent point (the cull's margin grows with the
    distance), plus rays from inside the sphere."""
    rr_ = float(form[0] + form[1])
    ro = pos + rng.uniform(-30, 30, (4096, 3))
    rd = _unit(rng.normal(size=(4096, 3)))
    n = 8192
    u = _unit(rng.normal(size=(n, 3)))
    s = rng.choice([-1e-2, -1e-3, -1e-4, 0.0, 1e-4, 1e-3, 1e-2, 5e-2, 0.2, 0.5], n)
    w = rng.normal(size=(n, 3))
    w = _unit(w - (w * u).sum(-1, keepdims=True) * u)
    along = np.exp(rng.uniform(np.log(0.3), np.log(150.0), n)) * rng.choice([1.0, -1.0], n)
    ro2 = pos + u * (rr_ * (1.0 + s))[:, None] - w * along[:, None]
    ro3 = pos + _unit(rng.normal(size=(1024, 3))) * rng.uniform(0, rr_, (1024, 1))
    rd3 = _unit(rng.normal(size=(1024, 3)))
    RO = np.concatenate([ro, ro2, ro3]).astype(np.float32)
    RD = np.concatenate([rd, w, rd3]).astype(np.float32)
    return (tuple(torch.from_numpy(RO[:, j].copy()) for j in range(3)),
            tuple(torch.from_numpy(RD[:, j].copy()) for j in range(3)))


@pytest.mark.parametrize("pose", sorted(POSES))
def test_torus_cull_equals_uncut(pose):
    pos, q, form = POSES[pose]
    o3, d3 = _torus_rays(pos, form, np.random.default_rng(sorted(POSES).index(pose)))
    t, hit = prim._torus_test(pos[None], q[None], form[None], 0, o3, d3)
    lo, ld = prim._torus_local(pos[None], q[None], 0, o3, d3)
    t0, hit0 = ttorus.torus_solve(lo, ld, form[0], form[1])
    culled = prim._torus_culled(lo, ld, form[0], form[1])
    assert torch.equal(hit, hit0)
    assert torch.equal(t[hit], t0[hit])
    assert int(hit.sum()) > 100
    assert float(culled[:4096].float().mean()) > 0.8          # random rays: mostly culled
    assert 0.2 < float(culled[4096:-1024].float().mean()) < 0.9
    assert not bool(culled[-1024:].any())                     # origins inside the sphere


@pytest.fixture(scope="module")
def demo():
    scene, _ = tdemo.build_scene(W, H)
    tex = with_mips(tdemo.demo_textures())
    ro, rd = primary_rays(scene.camera, W, H)
    rng = np.random.default_rng(3)
    ro2 = torch.from_numpy(rng.uniform([-12, -3, -6], [12, 6, 10], (N_RANDOM, 3)).astype(np.float32))
    rd2 = torch.from_numpy(_unit(rng.normal(size=(N_RANDOM, 3))).astype(np.float32))
    RO, RD = torch.cat([ro, ro2]).contiguous(), torch.cat([rd, rd2]).contiguous()
    n = RO.shape[0]
    masks = {
        "all": torch.ones(n, dtype=torch.bool),
        "none": torch.zeros(n, dtype=torch.bool),
        "random30": torch.from_numpy(rng.random(n) < 0.3),
        # whole 8-lane runs on and off, as neighbouring pixels die together
        "clustered": torch.from_numpy((rng.random(n // 8 + 1) < 0.4).repeat(8)[:n]),
    }
    return scene, tex, RO, RD, masks


@pytest.fixture(scope="module")
def probes(demo):
    scene, tex, RO, RD, _ = demo
    out = {}
    for flipped in (True, False):
        table = pack_scene(scene, tex.atlas, shade_flipped=flipped)
        out[flipped] = table, tsp.step_probe_ref(*table, RO, RD, 1.0 / H)
    return out


@pytest.mark.parametrize("mask", ["all", "none", "random30", "clustered"])
@pytest.mark.parametrize("flipped", [True, False])
def test_probe_alive_matches_unmasked(demo, probes, flipped, mask):
    scene, tex, RO, RD, masks = demo
    (buf, hdr), (f0, i0) = probes[flipped]
    alive = masks[mask]
    f, i = tsp.step_probe(scene, tex.atlas, RO, RD, pix_angle=1.0 / H, shade_flipped=flipped,
                          device="cpu", table=(buf, hdr), alive=alive)
    assert torch.equal(f[:, alive], f0[:, alive]) and torch.equal(i[:, alive], i0[:, alive])
    off = ~alive
    assert (f[0, off] == prim.INF_T).all() and (f[1:, off] == 0).all() and (i[:, off] == 0).all()
    # without a mask, misses hold the same fills and light-bulb hits shade nothing
    miss = f0[0] >= prim.BIG
    assert 0 < int(miss.sum()) < RO.shape[0]
    assert (f0[1:, miss] == 0).all() and (i0[:, miss] == 0).all()
    bulb = ~miss & (i0[0] >= sum(scene.counts[k] for k in SLOT_ORDER[:-1]))
    assert (f0[23:, bulb] == 0).all()


@pytest.mark.parametrize("mask", ["all", "none", "random30", "clustered"])
def test_nearest_alive_matches_unmasked(demo, mask):
    scene, _, RO, RD, masks = demo
    buf, hdr = pack_scene(scene, None)
    alive = masks[mask]
    t0, s0 = tnh.nearest_hit_ref(buf, hdr, RO, RD)
    t, s = tnh.nearest_hit_sweep(buf, hdr, RO, RD, alive)
    assert torch.equal(t[alive], t0[alive]) and torch.equal(s[alive], s0[alive])
    assert (t[~alive] == prim.INF_T).all() and (s[~alive] == 0).all()
    # the fill is a miss's: misses hold it without a mask too
    miss = t0 >= prim.BIG
    assert 0 < int(miss.sum()) < RO.shape[0]
    assert (t0[miss] == prim.INF_T).all() and (s0[miss] == 0).all()


def test_sweep_reuses_slot_lookup(demo):
    """The (type, index) lookup of the sweep's slots is built once per
    topology and device, on the device, not on every call."""
    scene, _, RO, RD, masks = demo
    table = pack_scene(scene, None)
    rint._slot_lookup.cache_clear()
    out = [rint._sweep(scene, RO, RD, True, table, masks["random30"]) for _ in range(2)]
    assert rint._slot_lookup.cache_info().misses == 1
    assert rint._type_tables(scene)[0] is rint._type_tables(scene)[0]
    for a, b in zip(*out):
        assert torch.equal(a, b)
    ty, idx = rint._type_tables(scene)
    n = sum(scene.counts[k] for k in SLOT_ORDER)
    assert ty.shape == idx.shape == (n,) and ty.dtype == idx.dtype == torch.int64
    assert int(ty[-1]) == rint.TYPE_POINT_LIGHT and int(idx[-1]) == 0


def _without(group):
    """A scene group with no members (every tensor cut to length 0)."""
    kw = {}
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        kw[f.name] = _without(v) if dataclasses.is_dataclass(v) else v[:0]
    return dataclasses.replace(group, **kw)


def test_nearest_library_per_topology(demo):
    """The nearest-hit kernel's library fixes the slot counts: one library
    per topology, whatever the flags, the other sections or the values."""
    scene = demo[0]
    buf, hdr = pack_scene(scene, None)
    cut = dataclasses.replace(scene, toruses=_without(scene.toruses), rings=_without(scene.rings))
    _, hdr2 = pack_scene(cut, None)
    top, top2 = kbuild.topology(hdr), kbuild.topology(hdr2)
    c = scene.counts
    assert top == tuple(f"{k}={c[n]}" for k, n in zip(kbuild.COUNT_DEFINES, SLOT_ORDER))
    assert top2 != top and "TXR_N_TO=0" in top2 and "TXR_N_RI=0" in top2
    assert kbuild.topology(pack_scene(scene, None, one_side=False, shade_flipped=False)[1]) == top
    moved = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, pos=scene.spheres.pos + 1.0))
    assert kbuild.topology(pack_scene(moved, None)[1]) == top
    paths = [kbuild.lib_path("nearest_hit", t) for t in (top, top2, top)]
    assert paths[0] == paths[2] != paths[1]
    assert kbuild.lib_path("step_probe") not in paths


def test_mask_is_checked():
    with pytest.raises(ValueError, match="lane mask"):
        check_mask("probe", torch.device("cpu"), torch.ones(5, dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="lane mask"):
        check_mask("probe", torch.device("cpu"), torch.ones(4, dtype=torch.bool), 5)
    m = torch.tensor([True, False])
    assert check_mask("probe", torch.device("cpu"), m, 2).dtype == torch.uint8


@pytest.fixture(scope="module")
def shadow_rays(demo):
    """Shadow rays from the demo's primary hits toward the point light, then
    random rays with random distances."""
    scene, _, RO, RD, _ = demo
    buf, hdr = pack_scene(scene, None)
    t, _ = rint.nearest_hit_sweep(buf, hdr, RO, RD)
    t = torch.where(t < prim.BIG, t, 0.0)
    pt = RO + RD * t[:, None] * 0.999
    lp = scene.lights_point.pos[0]
    d = lp - pt
    dist = d.norm(dim=-1)
    rd = (d / dist[:, None]).contiguous()
    rng = np.random.default_rng(5)
    dist = torch.where(t > 0, dist, torch.from_numpy(rng.uniform(0.5, 3e4, t.shape[0]).astype(
        np.float32))).contiguous()
    return buf, hdr, pt.contiguous(), torch.where((t > 0)[:, None], rd, RD).contiguous(), dist


@pytest.mark.parametrize("one_side", [True, False])
def test_occlusion_is_or_over_occluders(shadow_rays, one_side):
    """The kernel stops a shadow ray at its first occluder in
    ``occluder_tests`` order; the bit equals the OR over every solid slot
    test (planes only when two-sided), and every ring is still reported."""
    buf, hdr, ro, rd, dist = shadow_rays
    cnt, sec = sections(buf, hdr)
    o3, d3 = ro.unbind(-1), rd.unbind(-1)
    hits = [h & (t < dist) for t, h in occluder_tests(cnt, sec, o3, d3, one_side)]
    first = torch.full(dist.shape, len(hits))
    for k in reversed(range(len(hits))):
        first = torch.where(hits[k], k, first)
    solid, rings = occlusion_ref(cnt, sec, o3, d3, dist, one_side)
    # the OR in slot order: two-sided planes (when the scene's planes are),
    # spheres tested solid, surfaces, boxes, toruses; not rings or bulbs
    PL, SP, SU, BX, TO = (sec[k] for k in SLOT_ORDER[:5])
    tests = [prim._plane_test(PL[:, 0:3], PL[:, 3:6], i, o3, d3, False)
             for i in range(cnt["planes"]) if not one_side]
    tests += [prim._sphere_test(*SP[i, 0:4], None, o3, d3) for i in range(cnt["spheres"])]
    tests += [prim._surface_test(SU[:, 0:3], SU[:, 3:7], SU[:, 7:13], SU[:, 13:16], SU[:, 16:19],
                                 i, o3, d3) for i in range(cnt["surfaces"])]
    tests += [prim._box_test(BX[:, 0:3], BX[:, 3:7], BX[:, 7:10], i, o3, d3)
              for i in range(cnt["boxes"])]
    tests += [prim._torus_test(TO[:, 0:3], TO[:, 3:7], TO[:, 7:9], i, o3, d3)
              for i in range(cnt["toruses"])]
    want = torch.zeros_like(solid, dtype=torch.bool)
    for t, h in tests:
        want |= h & (t < dist)
    assert len(tests) == len(hits)
    assert torch.equal(solid > 0.5, want) and torch.equal(first < len(hits), want)
    assert 0.05 < float(want.float().mean()) < 0.95
    assert len(rings) == 3 * cnt["rings"]


@pytest.mark.parametrize("mask", ["all", "none", "random30", "clustered"])
def test_shadow_need_matches_unmasked(demo, shadow_rays, mask):
    buf, hdr, ro, rd, dist = shadow_rays
    need = demo[4][mask]
    s0, h0, uv0 = tss.shadow_sweep(buf, hdr, ro, rd, dist)
    s, h, uv = tss.shadow_sweep(buf, hdr, ro, rd, dist, need)
    assert torch.equal(s[need], s0[need]) and torch.equal(h[need], h0[need])
    assert torch.equal(uv[need], uv0[need])
    assert (s[~need] == 0).all() and not h[~need].any() and (uv[~need] == 0).all()
    assert float(s0.mean()) > 0.05


def _drop_probe_mask(orig):
    def probe(*a, alive=None, **k):
        return orig(*a, **k)
    return probe


def _drop_shadow_mask(orig):
    def sweep(buf, hdr, ro, rd, dist, need=None):
        return orig(buf, hdr, ro, rd, dist)
    return sweep


def _drop_nearest_mask(orig):
    def sweep(buf, hdr, ro, rd, alive=None):
        return orig(buf, hdr, ro, rd)
    return sweep


def _drop_masks(monkeypatch, fused):
    if fused == "off":
        monkeypatch.setattr(rint, "shadow_sweep", _drop_shadow_mask(rint.shadow_sweep))
        monkeypatch.setattr(rint, "nearest_hit_sweep", _drop_nearest_mask(rint.nearest_hit_sweep))
    else:
        monkeypatch.setattr(rfused, "step_probe", _drop_probe_mask(rfused.step_probe))


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_render_masks_bit_identical(monkeypatch, fused):
    """The demo at 32×18, 5 bounces and 6 refraction steps, with and
    without the lane masks: the same image, bit for bit."""
    scene, _ = tdemo.build_scene(W, H)
    tex = tdemo.demo_textures()
    cfg = RenderConfig(width=W, height=H, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene), fused=fused)
    masked = rr.render(scene, tex, cfg, device="cpu")
    _drop_masks(monkeypatch, fused)
    plain = rr.render(scene, tex, cfg, device="cpu")
    assert torch.isfinite(masked).all()
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_grads_masks_match(monkeypatch, fused):
    """Gradients of mean(img²) at 16×9 over every float scene leaf, with and
    without the lane masks, within 1e-6 (the probe route's backward reads
    fills on dead lanes, where it masks them as before)."""
    w, h = 16, 9

    def grads():
        scene, _ = tdemo.build_scene(w, h)
        leaves = float_leaves(scene)
        for v in leaves.values():
            v.requires_grad_(True)
        cfg = RenderConfig(width=w, height=h, iterations=5,
                           extra_refraction_steps=auto_refraction_steps(scene), fused=fused)
        img = rr.render(scene, tdemo.demo_textures(), cfg, device="cpu")
        g = torch.autograd.grad((img * img).mean(), list(leaves.values()), allow_unused=True)
        return {k: x for k, x in zip(leaves, g) if x is not None}

    masked = grads()
    _drop_masks(monkeypatch, fused)
    plain = grads()
    assert masked.keys() == plain.keys() and len(masked) > 20
    for k in plain:
        torch.testing.assert_close(masked[k], plain[k], rtol=0, atol=1e-6)
    assert sum(float(x.abs().sum()) > 0 for x in plain.values()) > 20
