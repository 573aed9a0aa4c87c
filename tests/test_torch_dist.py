"""The port's ray-sharded render and train step (txr_torch/dist/sharded.py)
and its rank layouts and worlds (txr_torch/dist/mesh.py), on the CPU.

One spawned world of 4 gloo ranks runs every sharded case
(``tests/_torch_dist_worker.py: sharding_cases``), on tests/test_sharding.py's
scene at 40×24:

* ``render_sharded`` on meshes (4,) and (2, 2) equals the port's ``render``
  bit for bit (per-lane arithmetic does not depend on the batch), and is
  within 1e-6 of the JAX package's ``render_sharded`` on its mesh (4, 1)
  on all but 1.5 % of the pixels, the golden criterion's share, and by that
  criterion on every pixel: the port's plain render differs from JAX's on
  12 of these 960 pixels, 8 on the box's top-far edge, where JAX's slab
  test misses and the port's hits (the silhouette of tests/test_ring.py's
  contract), and 4 sphere-edge pixels by 1.5e-6 to 5e-6;
  the 41×23 frame (rays not divisible by 4, padded with the last ray)
  equals ``render`` bit for bit too;
* ``render_sharded_jit`` equals ``render_sharded`` bit for bit on the same
  meshes and frames, also on its second call of a key (after a call on the
  moved scene);
* one SGD(1.0) step on ``spheres.pos``: the update is the gradient, held
  against ``jax.grad`` of the unsharded loss, and the loss against JAX's,
  at tests/test_sharding.py's tolerance (rtol 1e-4, atol 1e-7: float32
  sums in another order).  Each package's target is its own render of the
  unmoved scene, so the box-edge pixels where the two renders differ
  cancel in both losses;
* every rank ends a step with the same parameters, bit for bit;
* six sharded Adam steps lower the loss;
* one step of every float leaf at 41×23 (rays padded to the world): the
  loss within 1e-6 relative and each leaf's all_reduced gradient within
  1e-5 of its norm of a plain render and backward of the same loss (the
  step runs as the captured train step's pieces, eagerly on the CPU).

Worlds that fail or hang: a rank's exception fails the launcher, and a
rank past the timeout is killed and the launcher raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests.test_sharding import CFG as JCFG
from tests.test_sharding import scene_and_tex
from txr.dist.mesh import make_mesh as jmake_mesh
from txr.dist.sharded import render_sharded as jrender_sharded
from txr.render.render import render_jit
from txr_torch import bridge
from txr_torch.dist import mesh as tmesh
from txr_torch.render.render import render
from txr_torch.render.trace import RenderConfig
from txr_torch.utils.image import golden_check

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

MOVE = np.array([[0.2, 0.1, 0.0], [0.0, 0.0, 0.0]], np.float32)


def _leaves(scene):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


@pytest.fixture(scope="module")
def case():
    scene, tex = scene_and_tex()
    moved = dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, pos=scene.spheres.pos + MOVE))
    target = render_jit(scene, tex, JCFG)

    def loss(s):
        return jnp.mean((render_jit(s, tex, JCFG) - target) ** 2)

    jloss, jgrad = jax.value_and_grad(loss, allow_int=True)(moved)
    jsharded = jrender_sharded(scene, tex, JCFG, jmake_mesh((4, 1), devices=jax.devices()[:4]))
    sphere_tex = tuple(np.asarray(s) for s in tex.sphere)
    results = tmesh.spawn_world(4, worker.sharding_cases, _leaves(scene), _leaves(moved),
                                sphere_tex, device="cpu", timeout_s=240)
    tscene = bridge.scene_from_numpy(_leaves(scene))
    ttex = bridge.textures_from_numpy(sphere=sphere_tex)
    return dict(
        results=results,
        render=render(tscene, ttex, RenderConfig(width=40, height=24, refractive_glossy=False),
                      device="cpu").numpy(),
        render_odd=render(tscene, ttex, RenderConfig(width=41, height=23,
                                                     refractive_glossy=False),
                          device="cpu").numpy(),
        jax_sharded=np.asarray(jsharded), jax_loss=float(jloss),
        jax_grad=np.asarray(jgrad.spheres.pos), moved_pos=np.asarray(moved.spheres.pos))


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_sharded_render_matches_single_device(case, shape):
    for got in case["results"]:
        img = got[f"render{shape}"]
        np.testing.assert_array_equal(img, case["render"])
        over = np.abs(img - case["jax_sharded"]).max(-1) > 1e-6
        assert over.mean() <= 0.015, over.sum()
        ok, frac, worst = golden_check(img, case["jax_sharded"])
        assert ok, (frac, worst)


def test_sharded_render_odd_ray_count(case):
    for got in case["results"]:
        assert got["render_odd"].shape == (23, 41, 3)
        np.testing.assert_array_equal(got["render_odd"], case["render_odd"])


@pytest.mark.parametrize("name", ["(4,)", "(2, 2)", "_odd"])
def test_sharded_render_jit_matches_render_sharded(case, name):
    for got in case["results"]:
        np.testing.assert_array_equal(got[f"jit{name}"], got[f"render{name}"])
        assert not np.array_equal(got["jit_moved"], got["render(4,)"])


def test_sharded_grads_match_jax(case):
    got = case["results"][0]
    g = case["moved_pos"] - got["sgd_pos"]
    np.testing.assert_allclose(g, case["jax_grad"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got["sgd_loss"], case["jax_loss"], rtol=1e-4, atol=1e-7)


def test_sharded_step_params_identical_on_every_rank(case):
    first = case["results"][0]
    for got in case["results"][1:]:
        np.testing.assert_array_equal(got["sgd_pos"], first["sgd_pos"])
        np.testing.assert_array_equal(got["adam_pos"], first["adam_pos"])
        assert got["adam_losses"] == first["adam_losses"]


def test_sharded_training_reduces_loss(case):
    losses = case["results"][0]["adam_losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses


def test_sharded_step_of_every_leaf_matches_plain_backward(case):
    for got in case["results"]:
        r = got["every_leaf"]
        assert abs(r["loss"] - r["ref_loss"]) <= 1e-6 * r["ref_loss"], (r["loss"], r["ref_loss"])
        bad = [(k, np.linalg.norm(r["grads"][k] - w), np.linalg.norm(w))
               for k, w in r["ref_grads"].items()
               if np.linalg.norm(r["grads"][k] - w) > 1e-5 * np.linalg.norm(w)]
        assert not bad, bad
        assert sum(np.linalg.norm(w) > 0 for w in r["ref_grads"].values()) >= 10


def test_make_mesh_shapes():
    mesh = tmesh.make_mesh()
    assert mesh.size == 1 and mesh.shape == {"dp": 1, "sp": 1} and mesh.coords == (0, 0)
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.make_mesh((2, 2))


def test_init_multihost_without_env_does_nothing(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tmesh.init_multihost() == (1, 0)
    assert not torch.distributed.is_initialized()


def test_backend_rule():
    assert tmesh.default_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert tmesh.default_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert tmesh.default_backend(["cpu"] * 4) == "gloo"
    assert tmesh.rank_devices(3, "cpu") == ["cpu"] * 3


def test_spawn_world_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.spawn_world(2, worker.fail_on_rank_one, device="cpu", timeout_s=60)


def test_spawn_world_kills_a_world_past_its_timeout():
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        tmesh.spawn_world(2, worker.sleep_on_rank_one, 120.0, device="cpu", timeout_s=8)
