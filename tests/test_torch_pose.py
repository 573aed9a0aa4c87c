"""The demo's pose as a CUDA graph (``apps.demo.update_scene``), on the card.

The graph route against the eager ``_pose`` bit for bit at dt 0 and 1/30
and several t, t in [60, 61) among them; an in-place change to an input
leaf seen by the next pose; a scene of other storage captured anew; one
``pose_replays`` a replayed pose; ``render_jit`` of a graph-posed scene
equal to that of an eagerly posed one bit for bit.

Every test here needs a CUDA card (marker ``card``) and skips without one.
No JAX: on the card the file runs alone, without the CPU suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_pose.py
"""

import dataclasses

import pytest
import torch

from txr_torch.apps import demo as tdemo
from txr_torch.render.graphs import _Graph
from txr_torch.utils import profiling

pytestmark = pytest.mark.card

TIMES = (0.0, 60.0, 60.3718, 60.9999, 1234.5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def demo(card):
    scene, handles = tdemo.build_scene(96, 54)
    tdemo._POSE = None
    return scene.to(card), handles


def _eager(scene, handles, dt, t):
    """The scene posed by the eager ``_pose``."""
    flat = tdemo._pose_eagerly(tdemo._pose_leaves(scene), handles, dt, t, scene.device)
    return tdemo._with_posed(scene, flat)


def _copy(scene):
    """The scene with its posed leaves copied to other storage."""
    return tdemo._with_posed(scene, torch.cat([x.reshape(-1) for x in tdemo._pose_leaves(scene)]))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tdemo._pose_leaves(a), tdemo._pose_leaves(b)))


@pytest.mark.parametrize("dt", [0.0, 1 / 30])
def test_graph_pose_equals_eager_pose(demo, dt):
    scene, h = demo
    for t in TIMES:
        got = tdemo.update_scene(scene, h, dt, t)
        assert isinstance(tdemo._POSE.piece, _Graph)
        assert _equal(got, _eager(scene, h, dt, t)), t
    # the differentiable route runs the same function
    q = scene.spheres.quat.clone().requires_grad_()
    leafy = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, quat=q))
    got = tdemo.update_scene(leafy, h, dt, 60.5)
    assert _equal(got, _eager(scene, h, dt, 60.5))


def test_in_place_change_shows_and_new_storage_captures_anew(demo):
    scene, h = demo
    first = tdemo.update_scene(scene, h, 1 / 30, 60.25)
    kept = _copy(first)
    prog = tdemo._POSE
    scene.spheres.pos[0].add_(0.5)                # a still sphere
    scene.spheres.quat[h.saturn].mul_(-1.0)       # a spun row
    got = tdemo.update_scene(scene, h, 1 / 30, 60.25)
    assert tdemo._POSE is prog and _equal(got, _eager(scene, h, 1 / 30, 60.25))
    assert not torch.equal(got.spheres.pos, kept.spheres.pos)
    assert _equal(first, kept)                    # the earlier pose is its own
    other = _copy(scene)
    got = tdemo.update_scene(other, h, 1 / 30, 60.5)
    assert tdemo._POSE is not prog and tdemo._POSE.leaves[0] is other.spheres.pos
    assert _equal(got, _eager(scene, h, 1 / 30, 60.5))


def test_pose_replays_counted(demo):
    scene, h = demo
    was = profiling.tracing(True)
    profiling.reset()
    try:
        for k in range(5):
            tdemo.update_scene(scene, h, 0.0, 60.0 + k / 30)
        tdemo.update_scene(scene, h, 0.0, torch.tensor(61.0, device=scene.device))
        with profiling.unit("txr.frame"):
            pass
        counters = profiling.records()[-1]["counters"]
    finally:
        profiling.tracing(was)
        profiling.reset()
    # the first pose captures and replays; the tensor t poses eagerly
    assert counters["poses"] == [1] * 6 and counters["pose_replays"] == [1] * 5


def test_render_jit_of_a_graph_pose(demo):
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig

    scene, h = demo
    tex = with_mips(tdemo.demo_textures().to(scene.device))
    cfg = RenderConfig(width=96, height=54)
    try:
        for t in (60.0, 60.6):
            graph = tdemo.update_scene(scene, h, 0.0, t)
            eager = _eager(scene, h, 0.0, t)
            with torch.no_grad():
                a = render_jit(graph, tex, cfg, device=scene.device).clone()
                b = render_jit(eager, tex, cfg, device=scene.device).clone()
            assert torch.equal(a, b), t
    finally:
        clear_jit_cache()
