"""The port's inverse-rendering loop and its fused-route gradient.

``optimize_scene`` on ``apps.inverse.make_scene`` at 24×24: three Adam
steps from the perturbed guess of ``python -m txr_torch.apps.inverse``
toward the JAX package's render of the true scene.  The first loss is a
plain forward of the guess, so it equals JAX's to 1e-4 relative (float32
in another operation order); the losses fall and the camera quat, optimised
through ``QUAT_NORMALIZE``, stays unit to 1e-5.  Both routes run: the
eager one (``fused="off"``) and the probe route, whose backward recomputes
each step in saved mode.

The probe route's render gradient equals the eager route's, leaf by leaf,
on tests/test_grads.py's SCENE2 (glass sphere, one-sided plane, textured
ring), within the render-gradient tolerance of tests/test_torch_grads.py:
rtol 2e-2, atol 1e-4·(1 + max|g|).  It is never partial: the texture
content gradient reaches the ring image on both routes.
"""

import json

import numpy as np
import pytest
import torch

from tests import test_torch_grads as ttg
from txr.apps import inverse as jinv
from txr.diff.optimize import image_loss as jimage_loss
from txr.render.render import render_jit
from txr.render.texture import TextureSet as JTextureSet
from txr.render.trace import RenderConfig as JConfig
from txr_torch import bridge
from txr_torch.apps import inverse as tinv
from txr_torch.diff.optimize import optimize_scene
from txr_torch.render.render import render
from txr_torch.render.texture import TextureSet
from txr_torch.render.trace import RenderConfig
from txr_torch.scene.types import float_leaves

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

SIZE = 24
TRUE = ((0.3, 0.2, 6.0), 1.0, (0.1, 0.2, 0.9), (0, 0, -5))
GUESS = ((-0.4, -0.3, 6.5), 0.8, (0.5, 0.5, 0.5), (0.3, 0.2, -5.2))
GUESS_QUAT = (0.0, 0.02, 0.0, 1.0)
PARAMS = ["spheres.pos", "spheres.radius", "spheres.mat.color", "camera.pos", "camera.quat"]


@pytest.fixture(scope="module")
def jax_side():
    """(target image, first loss) of the JAX package at 24×24."""
    cfg = JConfig(width=SIZE, height=SIZE, iterations=2, refractive_glossy=False)
    target = render_jit(jinv.make_scene(*TRUE), JTextureSet(), cfg)
    guess = jinv.make_scene(*GUESS, cam_quat=GUESS_QUAT)
    return np.asarray(target), float(jimage_loss(render_jit(guess, JTextureSet(), cfg), target))


@pytest.mark.parametrize("fused", ["off", "auto"])
def test_optimize_scene_matches_jax_and_descends(jax_side, fused, tmp_path):
    target, first_jax = jax_side
    cfg = RenderConfig(width=SIZE, height=SIZE, iterations=2, refractive_glossy=False,
                       fused=fused)
    guess = tinv.make_scene(*GUESS, cam_quat=GUESS_QUAT)
    metrics = tmp_path / "steps.jsonl"
    recovered, losses = optimize_scene(
        guess, TextureSet(), cfg, target, steps=3, lr=3e-2, param_paths=PARAMS,
        param_transform=tinv.QUAT_NORMALIZE, metrics_path=str(metrics), device="cpu")
    assert abs(losses[0] - first_jax) <= 1e-4 * first_jax, (losses[0], first_jax)
    assert losses[2] < losses[1] < losses[0], losses
    assert abs(float((recovered.camera.quat ** 2).sum()) - 1.0) < 1e-5
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(r["grad_norm"] > 0 and r["loss"] == l for r, l in zip(records, losses))
    # the untouched leaves stay put, and the result carries no graph
    np.testing.assert_array_equal(recovered.boxes.pos.numpy(), guess.boxes.pos.numpy())
    assert not recovered.spheres.pos.requires_grad


def test_optimize_scene_refuses_checkpoints(tmp_path):
    """Checkpoint and resume are ported (tests/test_torch_checkpoint.py);
    a resume refuses a checkpoint of another parameter set."""
    path = str(tmp_path / "x.npz")
    args = (tinv.make_scene(*GUESS), TextureSet(), RenderConfig(width=4, height=4),
            np.zeros((4, 4, 3), np.float32))
    optimize_scene(*args, steps=1, checkpoint_path=path, checkpoint_every=1, device="cpu",
                   param_paths=["camera.pos"])
    with pytest.raises(ValueError, match="checkpoint"):
        optimize_scene(*args, steps=2, checkpoint_path=path, checkpoint_every=1, resume=True,
                       device="cpu", param_paths=["spheres.pos"])


def test_fused_route_grads_equal_eager():
    scene_j, tex_j, cfg = ttg.CASES["scene2"]
    scene = bridge.scene_from_numpy(ttg._leaves(scene_j))
    tex = bridge.textures_from_numpy(ring=np.asarray(tex_j.ring))
    leaves = float_leaves(scene)
    wrt = list(leaves.values()) + [tex.ring]
    for x in wrt:
        x.requires_grad_(True)
    img = render(scene, tex, ttg._port_cfg(cfg, fused="auto"), device="cpu")
    g = torch.autograd.grad(ttg._pixel_sum(img, ttg.PIXELS["scene2"]), wrt, allow_unused=True)
    got = bridge.grads_to_numpy(dict(zip(leaves, g)))
    got["ring"] = g[-1].numpy()
    want = ttg._port_grads("scene2")
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-2, atol=1e-4 * (1.0 + np.abs(w).max()),
                                   err_msg=k)
    assert np.abs(got["ring"]).sum() > 1e-3
    assert sum(np.abs(w).sum() > 0 for w in want.values()) >= 10


def test_cubemap_content_grad_on_both_routes():
    """The deferred environment fetch keeps the cubemap's content gradient
    (straight-through u8): the demo scene at 16×8, loss Σ img; the gradient
    reaches the starfield on both routes, nonzero and equal within the
    render-gradient tolerance (rtol 2e-2, atol 1e-4·(1 + max|g|)): the two
    routes' escaping rays differ in their last bits, and so do a few
    texels' bilinear weights."""
    from txr_torch.apps import demo as tdemo

    scene, _ = tdemo.build_scene(16, 8)
    got = {}
    for fused in ("off", "auto"):
        tex = tdemo.demo_textures()
        tex.cubemap.requires_grad_(True)
        cfg = RenderConfig(width=16, height=8, iterations=2, extra_refraction_steps=1,
                           fused=fused)
        (got[fused],) = torch.autograd.grad(render(scene, tex, cfg, device="cpu").sum(),
                                            tex.cubemap)
    assert (got["off"] != 0).sum() >= 16
    atol = 1e-4 * (1.0 + float(got["off"].abs().max()))
    torch.testing.assert_close(got["auto"], got["off"], rtol=2e-2, atol=atol)
