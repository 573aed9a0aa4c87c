"""The port's counterparts of the JAX package's last public functions.

``txr_torch.diff.scene_grad`` and ``select_params``, ``render.texture.
checkerboard``, ``geometry.quaternion.identity`` and ``normalize`` and
``geometry.torus.torus_t``, each held against its ``txr`` counterpart on
inputs made from a numpy seed.  Tolerances: scene gradients within 1e-4 of
each leaf's norm (float32 sums in another order), the checkerboard exactly,
quaternions to 1e-7, and torus roots to 5e-3 relative, the known
difference of the two packages' root polish (the port polishes on the
factored quartic, the JAX package on the expanded one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.apps.inverse import make_scene
from txr.diff import scene_grad as j_scene_grad
from txr.diff import select_params as j_select_params
from txr.geometry import quaternion as jquat
from txr.geometry import torus as jtorus
from txr.render import texture as jtx
from txr.render.render import render_jit
from txr.render.trace import RenderConfig as JConfig
from txr_torch import bridge
from txr_torch.diff import scene_grad, select_params
from txr_torch.geometry import quaternion as tquat
from txr_torch.geometry import torus as ttorus
from txr_torch.render import texture as ttx
from txr_torch.render.render import render
from txr_torch.render.trace import RenderConfig

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H = 16, 12
KEEP = ["spheres.pos", "camera", "lights_point.color"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def grads():
    """(JAX's, the port's) loss value and gradient leaves of mean((img −
    target)²) over the inverse-rendering scene at 16×12."""
    scene = make_scene((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
    target = np.random.default_rng(0).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    jcfg = JConfig(width=W, height=H, iterations=2, refractive_glossy=False, fused="off",
                   backend="jnp", bwd="scan")
    jloss = lambda s: jnp.mean((render_jit(s, jtx.TextureSet(), jcfg) - target) ** 2)
    jval, jg = jax.jit(lambda s: j_scene_grad(jloss, s))(scene)
    cfg = RenderConfig(width=W, height=H, iterations=2, refractive_glossy=False, fused="off")
    loss = lambda s, t: ((render(s, ttx.TextureSet(), cfg, device="cpu") - t) ** 2).mean()
    val, g = scene_grad(loss, bridge.scene_from_numpy(_leaves(scene)), torch.from_numpy(target))
    return (float(jval), jg), (float(val), g)


def test_scene_grad_matches_value_and_grad(grads):
    (jval, jg), (val, g) = grads
    assert abs(val - jval) <= 1e-6 * abs(jval)
    want, got = _leaves(jg), bridge.scene_to_numpy(g)
    assert set(got) == set(want)
    nonzero = 0
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if w.dtype.kind != "f":                 # int and bool leaves: zeros
            assert not got[k].any() and not w.any(), k
            continue
        n = float(np.linalg.norm(w))
        assert float(np.linalg.norm(got[k] - w)) <= 1e-4 * n, k
        nonzero += n > 0
    assert nonzero >= 20


def test_select_params_keeps_the_same_leaves(grads):
    (_, jg), (_, g) = grads
    want = _leaves(j_select_params(KEEP)(jg))
    got = bridge.scene_to_numpy(select_params(KEEP)(g))
    full = bridge.scene_to_numpy(g)
    kept = {k for k, w in want.items() if w.any()}
    assert kept == {k for k, v in got.items() if v.any()}
    assert {".camera.pos", ".spheres.pos", ".lights_point.color"} <= kept
    for k in kept:
        np.testing.assert_array_equal(got[k], full[k])


def test_checkerboard_matches_jax():
    for kw in ({}, dict(h=48, w=80, c1=(0.9, 0.1, 0.3), c2=(0.0, 0.5, 1.0), tiles=5)):
        np.testing.assert_array_equal(ttx.checkerboard(**kw, device="cpu").numpy(),
                                      np.asarray(jtx.checkerboard(**kw)))


def test_quaternion_identity_and_normalize_match_jax():
    np.testing.assert_array_equal(tquat.identity(device="cpu").numpy(), jquat.identity())
    q = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32) * 3.0
    np.testing.assert_allclose(tquat.normalize(torch.from_numpy(q)).numpy(),
                               np.asarray(jquat.normalize(jnp.asarray(q))), rtol=0, atol=1e-7)


def test_torus_t_matches_jax():
    """Rays from around three tori, aimed near them, so most hit: the same
    lanes hit, and t agrees to 5e-3 relative."""
    rng = np.random.default_rng(2)
    pos = np.array([[0.0, 0.0, 6.0], [-3.0, 0.5, 8.0], [2.5, -1.0, 5.0]], np.float32)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    form = np.array([[1.0, 0.5], [1.5, 0.3], [0.8, 0.25]], np.float32)
    ro = rng.uniform([-4.0, -3.0, -6.0], [4.0, 3.0, -2.0], (2048, 3)).astype(np.float32)
    aim = pos[rng.integers(0, 3, 2048)] + rng.normal(0.0, 0.8, (2048, 3)).astype(np.float32)
    rd = (aim - ro) / np.linalg.norm(aim - ro, axis=-1, keepdims=True)
    want = np.asarray(jtorus.torus_t(*(jnp.asarray(a) for a in (ro, rd, pos, q, form))))
    got = ttorus.torus_t(*(torch.from_numpy(a) for a in (ro, rd, pos, q, form))).numpy()
    hit = np.isfinite(want)
    assert got.shape == want.shape == (2048, 3) and hit.sum() > 500
    np.testing.assert_array_equal(np.isfinite(got), hit)
    np.testing.assert_allclose(got[hit], want[hit], rtol=5e-3, atol=0)
