"""Render gradients of the port vs jax.grad of the JAX package.

tests/test_grads.py's two scenes at 32×24 — SCENE (sphere, box floor,
torus, cone quadric, point and directional light) and SCENE2 (hollow glass
sphere, one-sided plane, a ring textured with a smooth ramp) — with one
loss per scene: the sum of its interior pixels (test_grads' PX_*), which
no silhouette crosses, so the gradient is well defined.  The JAX side is
the jnp body with the scan backward (``fused="off", backend="jnp",
bwd="scan"``); the port's is its eager route (``fused="off"``) through
the nearest-hit and shadow twins on the CPU.  Leaves compare with rtol
2e-2 and atol 1e-4·(1 + max|g_jax|) (f32 sums in another order); torus
leaves with rtol 5e-2, since the port polishes the torus root on the
factored quartic and the JAX package on the expanded one.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tests import test_grads as tg
from txr.render.render import render_jit
from txr_torch import bridge
from txr_torch.render.render import render
from txr_torch.render.trace import RenderConfig
from txr_torch.scene.types import float_leaves

PIXELS = {"scene": (tg.PX_SPHERE, tg.PX_FLOOR, tg.PX_TORUS, tg.PX_CONE),
          "scene2": (tg.PX_GLASS, tg.PX_GLASS2, tg.PX_RING2, tg.PX_PLANE)}
CASES = {"scene": (tg.SCENE, tg.TEX, tg.CFG), "scene2": (tg.SCENE2, tg.TEX2, tg.CFG2)}


def _port_cfg(jcfg, **kw):
    return RenderConfig(width=jcfg.width, height=jcfg.height, iterations=jcfg.iterations,
                        extra_refraction_steps=jcfg.extra_refraction_steps,
                        refractive_glossy=jcfg.refractive_glossy, **kw)


def _pixel_sum(img, pixels):
    return sum(img[r, c].sum() for r, c in pixels)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@functools.cache
def _jax_grads(name):
    scene, tex, cfg = CASES[name]
    jcfg = dataclasses.replace(cfg, fused="off", backend="jnp", bwd="scan")
    loss = lambda s, t: _pixel_sum(render_jit(s, t, jcfg), PIXELS[name])
    gs, gt = jax.grad(loss, argnums=(0, 1), allow_int=True)(scene, tex)
    out = {k: v for k, v in _leaves(gs).items() if v.dtype.kind == "f"}
    if tex.ring is not None:
        out["ring"] = np.asarray(gt.ring)
    return out


@functools.cache
def _port_grads(name):
    scene_j, tex_j, cfg = CASES[name]
    scene = bridge.scene_from_numpy(_leaves(scene_j))
    tex = bridge.textures_from_numpy(
        ring=None if tex_j.ring is None else np.asarray(tex_j.ring))
    leaves = float_leaves(scene)
    wrt = list(leaves.values()) + ([tex.ring] if tex.ring is not None else [])
    for x in wrt:
        x.requires_grad_(True)
    img = render(scene, tex, _port_cfg(cfg, fused="off"), device="cpu")
    g = torch.autograd.grad(_pixel_sum(img, PIXELS[name]), wrt, allow_unused=True)
    out = bridge.grads_to_numpy(dict(zip(leaves, g)))
    if tex.ring is not None:
        out["ring"] = g[-1].numpy()
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_grads_match_jax(name):
    want, got = _jax_grads(name), _port_grads(name)
    bad = []
    for k, w in want.items():
        if not w.size:
            continue
        g = got.get(k, np.zeros_like(w))
        rtol = 5e-2 if "toruses" in k else 2e-2
        atol = 1e-4 * (1.0 + np.abs(w).max())
        if not np.allclose(g, w, rtol=rtol, atol=atol):
            bad.append((k, np.abs(g - w).max(), np.abs(w).max()))
    assert not bad, (name, bad)
    assert sum(np.abs(w).sum() > 0 for w in want.values()) >= 10


def test_ring_texture_content_grad():
    """SCENE2's ring ramp: its content gradient (straight-through
    quantisation and mip pyramid, the atlas fetch, the shadow alpha fetch)
    is nonzero and equals JAX's."""
    want, got = _jax_grads("scene2"), _port_grads("scene2")
    assert np.abs(got["ring"]).sum() > 1e-3
    np.testing.assert_allclose(got["ring"], want["ring"], rtol=2e-2,
                               atol=1e-4 * (1.0 + np.abs(want["ring"]).max()))


def test_interior_grads_are_stable():
    """Why chip_smoke.py compares card and CPU gradients on interior pixels:
    the demo scene at 48×27, loss Σ img² / (H·W), gradients at the camera as
    built and nudged by 1e-6 along x (about two float32 ulps).  Over the
    whole frame some leaf's gradient moves by more than half its norm — a
    ray grazing a silhouette carries a spike dt/dθ ~ 1/√disc — while over
    the interior pixels (3×3 neighbourhood on one primitive, first hit)
    every leaf's moves by under 1 %."""
    import torch.nn.functional as F

    from txr_torch.apps import demo as tdemo
    from txr_torch.render.intersect import nearest_hit
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.trace import auto_refraction_steps
    from txr_torch.scene.types import unflatten_like

    w, h = 48, 27
    tex = tdemo.demo_textures()
    base, _ = tdemo.build_scene(w, h)
    with torch.no_grad():
        _, ty, idx = nearest_hit(base, *primary_rays(base.camera, w, h))
        slot = (ty * 1000 + idx).reshape(1, 1, h, w).double()
        pad = lambda x: F.pad(x, (1, 1, 1, 1), mode="replicate")
        interior = (F.max_pool2d(pad(slot), 3, 1) == -F.max_pool2d(pad(-slot), 3, 1))
    interior = interior.reshape(h, w, 1).float()
    assert 0.5 < interior.mean() < 0.9

    def grads(nudge):
        s = unflatten_like(base, {"camera.pos": base.camera.pos + torch.tensor([nudge, 0, 0])})
        leaves = float_leaves(s)
        for v in leaves.values():
            v.requires_grad_(True)
        cfg = RenderConfig(width=w, height=h, extra_refraction_steps=auto_refraction_steps(s),
                           fused="off")
        sq = render(s, tex, cfg, device="cpu") ** 2
        out = []
        for loss in (sq.sum() / (w * h), (sq * interior).sum() / (w * h)):
            g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                    retain_graph=True)
            out.append({k: x for k, x in zip(leaves, g) if x is not None})
        return out

    def worst(a, b):
        return max(float((b[k] - a[k]).norm()) / float(a[k].norm()) for k in a
                   if float(a[k].norm()) > 1e-4)

    (whole0, inner0), (whole1, inner1) = grads(0.0), grads(1e-6)
    assert worst(whole0, whole1) > 0.5
    assert worst(inner0, inner1) < 1e-2
