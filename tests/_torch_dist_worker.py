"""Rank functions of the port's spawned worlds in tests/test_torch_dist.py
and tests/test_torch_ring.py.

They live in a module of their own that imports only torch and
``txr_torch``: a spawned rank imports the module of the function it runs,
and these need not import JAX.  Scenes and textures arrive as numpy leaves
(``bridge``); results go back as numpy arrays.
"""

import time

import numpy as np
import torch

from txr_torch import bridge
from txr_torch.dist.mesh import make_mesh
from txr_torch.dist.ring import ring_nearest_hit
from txr_torch.dist.sharded import make_train_step, render_sharded
from txr_torch.render.raygen import primary_rays
from txr_torch.render.render import render
from txr_torch.render.trace import RenderConfig


def sharding_cases(device, leaves, moved_leaves, tex):
    """Every sharded case of tests/test_torch_dist.py in one world of 4:
    renders on meshes (4,) and (2, 2) at 40×24 and at 41×23, one SGD(1.0)
    step on the moved scene and a short Adam fit, both toward the port's
    render of the scene."""
    scene, moved = bridge.scene_from_numpy(leaves), bridge.scene_from_numpy(moved_leaves)
    textures = bridge.textures_from_numpy(sphere=tex)
    cfg = RenderConfig(width=40, height=24, refractive_glossy=False)
    with torch.no_grad():
        target = render(scene, textures, cfg, device=device)
    out = {}
    for shape in ((4,), (2, 2)):
        mesh = make_mesh(shape, axis_names=("dp", "sp"))
        out[f"render{shape}"] = render_sharded(scene, textures, cfg, mesh, device=device).numpy()
    odd = RenderConfig(width=41, height=23, refractive_glossy=False)
    out["render_odd"] = render_sharded(scene, textures, odd, make_mesh((4,)), device=device).numpy()

    init, step = make_train_step(textures, cfg, make_mesh((2, 2)),
                                 lambda ps: torch.optim.SGD(ps, lr=1.0),
                                 param_paths=["spheres.pos"], device=device)
    new, _, loss = step(moved, init(moved), target)
    out["sgd_pos"] = new.spheres.pos.numpy()
    out["sgd_loss"] = float(loss)

    init, step = make_train_step(textures, cfg, make_mesh((4,)),
                                 lambda ps: torch.optim.Adam(ps, lr=2e-2, eps=1e-8),
                                 param_paths=["spheres.pos"], device=device)
    s, st, losses = moved, None, []
    st = init(s)
    for _ in range(6):
        s, st, loss = step(s, st, target)
        losses.append(float(loss))
    out["adam_losses"] = losses
    out["adam_pos"] = s.spheres.pos.numpy()
    return out


def ring_cases(device, cases):
    """``ring_nearest_hit`` on a 1-axis mesh over the world for each
    (name, scene leaves, width, height) → {name: (t, type, index)}."""
    mesh = make_mesh((torch.distributed.get_world_size(),), axis_names=("sp",))
    out = {}
    for name, leaves, w, h in cases:
        scene = bridge.scene_from_numpy(leaves)
        ro, rd = primary_rays(scene.camera, w, h, 1)
        out[name] = tuple(x.numpy() for x in ring_nearest_hit(scene, ro, rd, mesh, device=device))
    return out


def fail_on_rank_one(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return "ok"


def sleep_on_rank_one(device, seconds):
    if torch.distributed.get_rank() == 1:
        time.sleep(seconds)
    return np.zeros(1)
