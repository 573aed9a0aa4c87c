"""The port's debug channels and NaN checks vs the JAX package.

``render_debug`` at bounce 0 and 1 on test_grads' SCENE2 (a hollow glass
sphere, a one-sided plane, a textured ring; no torus, so no lane's winner
differs by the torus polish) at 24×16 against JAX's ``render_debug``, both
bounces from one compilation: ``type``, ``index`` and ``alive`` equal,
``t`` and ``normal`` within 1e-4 relative, ``mask`` within 1e-5, dtypes
and fills as JAX's, on both routes.  At bounce 1, 211 rays are alive (the
glass sphere's refractions and reflections) and 43 hit.

NaN checks: a sphere with a NaN radius drops out of the image in both
packages (a NaN root never wins the nearest-hit compare), so the image is
finite, ``checked_render`` passes it and ``enable_nan_checks`` lets it
through, as ``jax_debug_nans`` does (JAX checks a jit program's outputs
first).  A NaN colour of the sphere in view reaches the pixels:
``checked_render`` raises and ``enable_nan_checks`` raises at the render.
A clean render and its gradient pass with the checks on; an op outside the
renderer that makes a NaN or an Inf raises at once.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests import test_grads as tg
from tests.test_golden import config1_scene
from txr.render.render import render_debug as jrender_debug
from txr.render.trace import RenderConfig as JConfig
from txr_torch import bridge
from txr_torch.render.render import render, render_debug
from txr_torch.render.trace import RenderConfig
from txr_torch.scene.types import float_leaves
from txr_torch.utils import debug

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 24, 16
BASE = dict(width=W, height=H, iterations=3, extra_refraction_steps=0, refractive_glossy=False)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def _port_scene():
    js, jt = config1_scene()
    return (bridge.scene_from_numpy(_leaves(js)),
            bridge.textures_from_numpy(sphere=[np.asarray(s) for s in jt.sphere]))


DEBUG = dict(width=W, height=H, iterations=5, extra_refraction_steps=4)


@pytest.fixture(scope="module")
def jax_debug():
    cfg = JConfig(**DEBUG, fused="off", backend="jnp")
    both = jax.jit(lambda s, t: [jrender_debug(s, t, cfg, b) for b in (0, 1)])(tg.SCENE2,
                                                                              tg.TEX2)
    return [{k: np.asarray(v) for k, v in d.items()} for d in both]


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("bounce", [0, 1])
def test_render_debug_matches_jax(jax_debug, fused, bounce):
    want = jax_debug[bounce]
    scene = bridge.scene_from_numpy(_leaves(tg.SCENE2))
    tex = bridge.textures_from_numpy(ring=np.asarray(tg.TEX2.ring))
    got = render_debug(scene, tex, RenderConfig(**DEBUG, fused=fused), bounce, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
    for k in ("type", "index", "alive"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    hit = np.isfinite(want["t"])
    assert hit.sum() > (W * H // 2 if bounce == 0 else 40)
    np.testing.assert_array_equal(np.isfinite(got["t"]), hit)
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-4)
    np.testing.assert_allclose(got["normal"], want["normal"], rtol=1e-4, atol=1e-4)
    assert (got["normal"][~hit] == 0).all()
    np.testing.assert_allclose(got["mask"], want["mask"], rtol=1e-5, atol=1e-5)


def _with_sphere(scene, **fields):
    sp = scene.spheres
    kw = {}
    for name, (i, v) in fields.items():
        owner = sp.mat if name == "color" else sp
        x = getattr(owner, name).clone()
        x[i] = v
        kw[name] = x
    mat = dataclasses.replace(sp.mat, **{k: v for k, v in kw.items() if k == "color"})
    sp = dataclasses.replace(sp, mat=mat, **{k: v for k, v in kw.items() if k != "color"})
    return dataclasses.replace(scene, spheres=sp)


CFG = RenderConfig(width=16, height=12, iterations=2, extra_refraction_steps=0,
                   refractive_glossy=False)


def test_checked_render():
    scene, tex = _port_scene()
    err, img = debug.checked_render(scene, tex, CFG, device="cpu")
    err.throw()
    assert err.get() is None and img.shape == (12, 16, 3)
    err, img = debug.checked_render(_with_sphere(scene, radius=(0, float("nan"))), tex, CFG,
                                    device="cpu")
    err.throw()                       # the sphere drops out; the image stays finite
    assert torch.isfinite(img).all()
    err, img = debug.checked_render(_with_sphere(scene, color=(0, float("nan"))), tex, CFG,
                                    device="cpu")
    assert not torch.isfinite(img).all()
    with pytest.raises(FloatingPointError, match="non-finite pixels"):
        err.throw()


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_nan_checks(fused):
    scene, tex = _port_scene()
    cfg = dataclasses.replace(CFG, fused=fused)
    no_radius = _with_sphere(scene, radius=(0, float("nan")))
    no_colour = _with_sphere(scene, color=(0, float("nan")))
    leaves = float_leaves(scene)
    debug.enable_nan_checks()
    try:
        for v in leaves.values():
            v.requires_grad_(True)
        img = render(scene, tex, cfg, device="cpu")
        g = torch.autograd.grad((img * img).mean(), list(leaves.values()), allow_unused=True)
        assert all(torch.isfinite(x).all() for x in g if x is not None)
        with torch.no_grad():
            render(no_radius, tex, cfg, device="cpu")
            with pytest.raises(FloatingPointError, match="NaN in the output of render"):
                render(no_colour, tex, cfg, device="cpu")
        with pytest.raises(FloatingPointError, match="Inf made by"):
            torch.ones(3) / torch.zeros(3)
        with pytest.raises(FloatingPointError, match="NaN made by"):
            torch.zeros(3) / torch.zeros(3)
    finally:
        debug.disable_nan_checks()
    assert not torch.is_anomaly_enabled()
    torch.zeros(3) / torch.zeros(3)           # off again
