"""The port's edge-adaptive AA, presets and ray chunking vs the JAX package.

Pixel choice: the port's ``edge_pixels`` and JAX's ``_edge_aa`` (its trace
replaced by zeros, so the pixels it writes show) pick the same pixels of
the same numpy base image, also when the budget is smaller than the edge
count.  Re-rendered pixels equal the port's uniform SSAA within 1e-5 and
the others equal the 1-spp frame exactly, on both routes.  Whole images:
test_golden's config 1 (two spheres, one textured, a plane; no torus, so
no edge pixel flips between the packages) at 24×16 with ``supersample=4``
against ``render_jit(aa_mode="edge")``: at most 1.5 % of pixels over 2e-3
(the golden criterion's share), and the gradient of mean(img²) within
2e-2 of each float leaf's norm, from one compiled JAX value-and-grad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden import config1_scene
from txr.render import render as jrender
from txr.render.render import render_jit
from txr.render.trace import AA_PRESETS as JAA_PRESETS
from txr.render.trace import RenderConfig as JConfig
from txr_torch import bridge
from txr_torch.render import render as rr
from txr_torch.render.trace import AA_PRESETS, RenderConfig
from txr_torch.scene.types import float_leaves

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

W, H, K = 24, 16, 4
BASE = dict(width=W, height=H, iterations=3, extra_refraction_steps=0, refractive_glossy=False)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def _port_scene():
    js, jt = config1_scene()
    return (bridge.scene_from_numpy(_leaves(js)),
            bridge.textures_from_numpy(sphere=[np.asarray(s) for s in jt.sphere]))


def test_presets_match_jax():
    assert AA_PRESETS == JAA_PRESETS
    for preset in AA_PRESETS:
        for mode in ("edge", "ssaa"):
            got = RenderConfig(width=8, height=8).with_aa_preset(preset.upper(), mode)
            want = JConfig(width=8, height=8).with_aa_preset(preset.upper(), mode)
            assert (got.supersample, got.aa_mode) == (want.supersample, want.aa_mode)
    cfg = RenderConfig()
    assert (cfg.aa_mode, cfg.edge_threshold, cfg.edge_budget_mult, cfg.ray_chunk) == (
        "edge", 0.02, 20, 0)


def _base_image(rng):
    """Blocks of random colour (edges at block borders) plus noise near
    the threshold, [H, W, 3] float32 in (0.1, 1)."""
    blocks = np.kron(rng.uniform(0.1, 0.9, (H // 4, 40 // 4, 3)), np.ones((4, 4, 1)))
    return (blocks + rng.uniform(0.0, 0.03, blocks.shape)).astype(np.float32)


@pytest.mark.parametrize("mult", [20, 1])
def test_pixel_choice_matches_jax(monkeypatch, mult):
    """The same base image → the same pixels, in the same order, with the
    budget K = min(H·W, mult·(H+W)) covering every edge (20) or cut (1)."""
    js, jt = config1_scene()
    base = _base_image(np.random.default_rng(3))
    h, w = base.shape[:2]
    jcfg = JConfig(width=w, height=h, supersample=2, edge_budget_mult=mult)
    monkeypatch.setattr(jrender, "_chunked_trace",
                        lambda scene, tex, cfg, ro, rd: jnp.zeros_like(rd))
    out = np.asarray(jrender._edge_aa(js, jt, jcfg, jnp.asarray(base)))
    want = np.flatnonzero((out != base).any(-1))
    cfg = RenderConfig(width=w, height=h, supersample=2, edge_budget_mult=mult)
    got = rr.edge_pixels(torch.from_numpy(base), cfg).numpy()
    budget = min(h * w, mult * (h + w))
    edges = rr.edge_pixels(torch.from_numpy(base),
                           dataclasses.replace(cfg, edge_budget_mult=h * w)).numpy()
    assert len(got) == min(budget, len(edges))
    assert (len(edges) > budget) == (mult == 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, edges[:budget])


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_edge_pixels_equal_uniform_ssaa(fused):
    """Re-rendered pixels within 1e-5 of uniform SSAA (the mean of the same
    16 rays, summed in another order); every other pixel is the 1-spp
    frame's, bit for bit."""
    scene, tex = _port_scene()
    cfg = RenderConfig(**BASE, fused=fused)
    one = rr.render(scene, tex, cfg, device="cpu")
    ssaa = rr.render(scene, tex, dataclasses.replace(cfg, supersample=K, aa_mode="ssaa"),
                     device="cpu")
    edge_cfg = dataclasses.replace(cfg, supersample=K)
    edge = rr.render(scene, tex, edge_cfg, device="cpu")
    mask = torch.zeros(H * W, dtype=torch.bool)
    mask[rr.edge_pixels(one, edge_cfg)] = True
    mask = mask.reshape(H, W)
    assert 0 < int(mask.sum()) < H * W
    assert float((edge - ssaa)[mask].abs().max()) <= 1e-5
    assert torch.equal(edge[~mask], one[~mask])


@pytest.fixture(scope="module")
def jax_edge():
    """JAX's edge-AA image and gradient of mean(img²), one compilation."""
    js, jt = config1_scene()
    jcfg = JConfig(**BASE, supersample=K, aa_mode="edge", fused="off", backend="jnp",
                   bwd="scan")

    def loss(s):
        img = render_jit(s, jt, jcfg)
        return jnp.mean(img * img), img

    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True, allow_int=True))(js)
    grads = {k: v for k, v in _leaves(g).items() if v.dtype.kind == "f"}
    return np.asarray(img, np.float64), grads


@pytest.fixture(scope="module")
def port_edge():
    scene, tex = _port_scene()
    leaves = float_leaves(scene)
    for v in leaves.values():
        v.requires_grad_(True)
    img = rr.render(scene, tex, RenderConfig(**BASE, supersample=K), device="cpu")
    g = torch.autograd.grad((img * img).mean(), list(leaves.values()), allow_unused=True)
    return img.detach().numpy().astype(np.float64), bridge.grads_to_numpy(dict(zip(leaves, g)))


def test_edge_image_matches_jax(jax_edge, port_edge):
    want, got = jax_edge[0], port_edge[0]
    assert np.isfinite(got).all() and got.shape == want.shape == (H, W, 3)
    diff = np.abs(got - want).max(-1)
    assert (diff > 2e-3).mean() <= 0.015, (diff > 2e-3).mean()


def test_edge_grads_match_jax(jax_edge, port_edge):
    want, got = jax_edge[1], port_edge[1]
    assert any(np.abs(v).sum() > 0 for v in want.values())
    for k, w in want.items():
        g = got.get(k, np.zeros_like(w))
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) + 1e-7, k


@pytest.mark.parametrize("fused", ["auto", "off"])
def test_ray_chunk_matches_unchunked(fused):
    """Chunks of 100 rays (the last one short), also through the edge pass:
    within 1e-6 of one trace of every ray."""
    scene, tex = _port_scene()
    cfg = RenderConfig(**BASE, supersample=2, fused=fused)
    whole = rr.render(scene, tex, cfg, device="cpu")
    chunked = rr.render(scene, tex, dataclasses.replace(cfg, ray_chunk=100), device="cpu")
    assert float((whole - chunked).abs().max()) <= 1e-6
