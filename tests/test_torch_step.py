"""The port's eager step body vs the JAX package's: hit_info, calc_shade and
one step_jnp step, plain and in saved mode, field by field.

Rays: the 32×18 demo primary rays, plus rays aimed from outside at
Jupiter, Saturn, Mars and Saturn's ring, so every textured type's uv, LOD
and atlas fetch is exercised.  The textures are small random ones (the
demo's take the JAX package 20 s to pack), the same numpy arrays on both
sides.  hit_info gets JAX's own (t, type, index) on
both sides; the JAX side runs the jnp body on the CPU.  Fields agree to
1e-4 + 1e-4·|x| (float32 in another operation order) on ≥ 99.5 % of lanes,
and every value is finite.  In a whole step the lanes that hit the torus
are held apart: the port polishes the torus root on the factored quartic
(txr_torch/geometry/torus.py), the JAX package on the expanded one, whose
root is off by up to ~1e-3 relative, so their hit points agree to 5e-3
relative (the torus tolerance of tests/test_torch_probe.py), their integer
fields exactly, and their normals, reflected rays and shadow bits follow
the two hit points apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.apps import demo as jdemo
from txr.render import intersect as jri
from txr.render import shading as jsh
from txr.render import trace as jtr
from txr.render.raygen import primary_rays as jprimary_rays
from txr.render.texture import TextureSet as JTextureSet
from txr.render.texture import with_mips as jwith_mips
from txr_torch import bridge
from txr_torch.apps import demo as tdemo
from txr_torch.geometry import quaternion as tq
from txr_torch.render import fused as tfused
from txr_torch.render import shading as tsh
from txr_torch.render import trace as ttr
from txr_torch.render.texture import with_mips
from txr_torch.scene.types import TYPE_TORUS

W, H = 32, 18
SHARE = 0.995


def _aimed_rays(scene, rng, n=96):
    """Rays from outside each planet (and beside the ring plane) aimed at it."""
    def aim(ro, target):
        d = target - ro
        return ro, d / np.linalg.norm(d, axis=-1, keepdims=True)

    out = []
    unit = lambda k: (v := rng.normal(size=(k, 3))) / np.linalg.norm(v, axis=-1, keepdims=True)
    for r_from, r_at in ((6000.0, 3000.0), (4600.0, 2000.0), (2000.0, 250.0)):
        out.append(aim(unit(n) * r_from, unit(n) * rng.uniform(0, r_at, (n, 1))))
    r1, r2 = float(scene.rings.r1[0]), float(scene.rings.r2[0])
    rad = np.sqrt(rng.uniform(r1, r2, n))
    ang = rng.uniform(0, 2 * np.pi, n)
    local = np.stack([rad * np.cos(ang), rad * np.sin(ang), np.zeros(n)], -1)
    conj = tq.conj(scene.rings.quat[0]).double()
    pts = tq.rotate(conj, torch.from_numpy(local)).numpy()
    nrm = tq.rotate(conj, torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)).numpy()
    side = np.where(rng.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    out.append(aim(pts + side * 400.0 * nrm + rng.normal(size=(n, 3)) * 200.0, pts))
    ro = np.concatenate([o for o, _ in out]).astype(np.float32)
    rd = np.concatenate([d for _, d in out]).astype(np.float32)
    return ro, rd


def _textures():
    rng = np.random.default_rng(2)
    tex = lambda *s: rng.uniform(0.0, 1.0, s + (4,)).astype(np.float32)
    arrays = dict(sphere=(tex(32, 64), tex(32, 64), tex(16, 32)), ring=tex(8, 64),
                  box=tex(16, 16), cubemap=tex(6, 8, 8))
    jtex = JTextureSet(sphere=tuple(map(jnp.asarray, arrays["sphere"])),
                       **{k: jnp.asarray(v) for k, v in arrays.items() if k != "sphere"})
    return jwith_mips(jtex), with_mips(bridge.textures_from_numpy(**arrays))


@pytest.fixture(scope="module")
def setup():
    jscene, _ = jdemo.build_scene(W, H)
    tscene, _ = tdemo.build_scene(W, H)
    jtex, ttex = _textures()
    ro, rd = jprimary_rays(jscene.camera, W, H, 1)
    ro2, rd2 = _aimed_rays(tscene, np.random.default_rng(0))
    RO = np.concatenate([np.asarray(ro), ro2])
    RD = np.concatenate([np.asarray(rd), rd2])
    return jscene, jtex, tscene, ttex, RO, RD


def _agree(got, want, name, lanes=None, tol=1e-4, share=SHARE):
    """``got`` within tol + tol·|want| of ``want`` (integers exactly) on at
    least ``share`` of ``lanes`` (default all)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if got.dtype == bool or got.dtype.kind in "iu":
        ok = got == want
    else:
        assert np.isfinite(got).all(), name
        ok = np.abs(got - want) <= tol + tol * np.abs(want)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    if lanes is not None:
        ok = ok[lanes]
    assert ok.mean() >= share, (name, ok.mean())


def _hits(setup):
    jscene, _, _, _, RO, RD = setup
    t, ty, idx = jri.nearest_hit(jscene, jnp.asarray(RO), jnp.asarray(RD), True, "jnp")
    return t, ty, idx


def test_hit_info_matches_jax(setup):
    jscene, jtex, tscene, ttex, RO, RD = setup
    t, ty, idx = _hits(setup)
    want = jtr.hit_info(jscene, jtex, jnp.asarray(RO), jnp.asarray(RD), t, ty, idx, 1.0 / H,
                        fast=False)
    T = lambda a: torch.from_numpy(np.array(a))
    got = ttr.hit_info(tscene, ttex, T(RO), T(RD), T(t), T(ty).long(), T(idx).long(), 1.0 / H)
    textured = np.zeros(len(RO), bool)
    for k in ("pt", "normal", "color", "absorb", "diffuse", "reflection", "refraction",
              "specular", "kd", "ks", "alpha", "bias"):
        _agree(got[k], want[k], k)
    # the aimed rays reach every textured type
    tyn = np.asarray(ty)
    for code, tex in ((0, tscene.spheres.texture), (5, tscene.rings.texture)):
        textured |= (tyn == code) & (tex.numpy()[np.clip(np.asarray(idx), 0, len(tex) - 1)] > 0)
    assert textured.sum() >= 100


def test_calc_shade_matches_jax(setup):
    jscene, jtex, tscene, ttex, RO, RD = setup
    t, ty, idx = _hits(setup)
    hi = jtr.hit_info(jscene, jtex, jnp.asarray(RO), jnp.asarray(RD), t, ty, idx, 1.0 / H,
                      fast=False)
    pt = hi["pt"] + hi["normal"] * hi["bias"][:, None]
    args = (pt, jnp.asarray(RD), hi["color"], hi["diffuse"], hi["specular"], hi["kd"],
            hi["ks"], hi["normal"])
    want = jsh.calc_shade(jscene, jtex, *args, backend="jnp")
    got = tsh.calc_shade(tscene, ttex, *(torch.from_numpy(np.array(a)) for a in args))
    _agree(got, want, "shade")


def _state(RO, RD):
    return jtr.initial_state(jnp.asarray(RO), jnp.asarray(RD)), ttr.initial_state(
        torch.from_numpy(RO), torch.from_numpy(RD))


@pytest.mark.parametrize("mode", ["plain", "saved"])
def test_step_matches_jax(setup, mode):
    """One bounce step of step_jnp; saved mode gets the port's probe results
    (slot, t, shadow bits) on both sides."""
    jscene, jtex, tscene, ttex, RO, RD = setup
    jcfg = jtr.RenderConfig(width=W, height=H, fused="off", backend="jnp")
    tcfg = ttr.RenderConfig(width=W, height=H, fused="off")
    jst, tst = _state(RO, RD)
    saved = jsaved = None
    if mode == "saved":
        pr = tfused._probe(tscene, ttex, tcfg, tst["ro"], tst["rd"], shade_flipped=True)
        saved = {k: pr[k] for k in ("slot", "t", "light_solid", "ring_hit", "ring_uv")}
        jsaved = {k: jnp.asarray(v.numpy()) for k, v in saved.items()}
        jsaved["slot"] = jsaved["slot"].astype(jnp.int32)
    want = jtr.step_jnp(jscene, jtex, jcfg, jst, saved=jsaved)
    got = ttr.step_jnp(tscene, ttex, tcfg, tst, saved=saved)
    assert set(got) == set(want)
    torus = np.asarray(_hits(setup)[1]) == TYPE_TORUS
    assert 0 < torus.sum() < 0.05 * len(torus)
    for k in want:
        _agree(got[k], want[k], k, lanes=~torus)
        if k == "ro" or not np.issubdtype(np.asarray(want[k]).dtype, np.floating):
            _agree(got[k], want[k], k, lanes=torus, tol=5e-3, share=1.0)
    assert np.asarray(want["alive"]).any() and not np.asarray(want["alive"]).all()
