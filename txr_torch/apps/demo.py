"""The solar-system demo scene (txr/apps/demo.py:40-228, after main.cpp:43-132).

Three shaded spheres, three textured planets, Saturn's ring, a floor and a
crate box, a torus, a cone and a cylinder quadric, a point and a
directional light.  The textures are procedural, made with the same numpy
seeds as the JAX package, so the two texture sets are bit-identical.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from txr_torch.geometry import quaternion as quat
from txr_torch.render.texture import TextureSet
from txr_torch.scene import surface_factory as sf
from txr_torch.scene.factories import SceneBuilder

SATURN_RADIUS = 4150.0
SATURN_PITCH = quat.from_euler([math.radians(15.0), 0.0, 0.0])


def _rgba(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _banded_planet(h, w, bands, base, alt, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    phase = rng.uniform(0, 2 * np.pi, 3)
    mix = 0.5 + 0.5 * np.sin(bands * 2 * np.pi * y + phase[0])
    mix += 0.15 * np.sin(3.1 * bands * 2 * np.pi * y + phase[1])
    mix = np.clip(mix, 0, 1)
    rgb = np.asarray(base) * (1 - mix[..., None]) + np.asarray(alt) * mix[..., None]
    rgb = np.broadcast_to(rgb, (h, w, 3)).copy()
    rgb += rng.normal(0, 0.01, (h, w, 3))
    a = np.ones((h, w, 1))
    return _rgba(np.clip(np.concatenate([rgb, a], -1), 0, 1))


def _ring_texture(h, w):
    """Radial bands with alpha gaps; u = normalised (r²−r1)/(r2−r1)."""
    rng = np.random.default_rng(7)
    u = np.linspace(0, 1, w)[None, :]
    color = 0.55 + 0.25 * np.sin(40 * np.pi * u) + rng.normal(0, 0.02, (1, w))
    alpha = np.clip(0.8 + 0.4 * np.sin(23 * np.pi * u + 1.3), 0, 1) * (u > 0.02)
    rgb = np.broadcast_to(color[..., None] * np.array([1.0, 0.9, 0.75]), (h, w, 3))
    a = np.broadcast_to(alpha[..., None], (h, w, 1))
    return _rgba(np.clip(np.concatenate([rgb, a], -1), 0, 1))


def _crate_texture(h, w):
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    border = (np.minimum.reduce([xx, 1 - xx, yy, 1 - yy]) < 0.08).astype(float)
    planks = 0.5 + 0.2 * np.sin(6 * np.pi * yy)
    rgb = np.stack([0.55 + 0.2 * planks, 0.35 + 0.15 * planks, 0.15 + 0.05 * planks], -1)
    border = border[..., None]
    rgb = rgb * (1 - border) + border * np.array([0.35, 0.22, 0.1])
    a = np.ones((h, w, 1))
    return _rgba(np.concatenate([rgb, a], -1))


def _starfield_cubemap(size=256, density=4e-4, seed=3):
    rng = np.random.default_rng(seed)
    cm = np.zeros((6, size, size, 4), np.float32)
    cm[..., :3] = rng.uniform(0.0, 0.015, (6, size, size, 3))
    n_stars = int(6 * size * size * density)
    f = rng.integers(0, 6, n_stars)
    y = rng.integers(0, size, n_stars)
    x = rng.integers(0, size, n_stars)
    mag = rng.uniform(0.3, 1.0, n_stars)
    tint = rng.uniform(0.7, 1.0, (n_stars, 3))
    cm[f, y, x, :3] = (mag[:, None] * tint).astype(np.float32)
    cm[..., 3] = 1.0
    return _rgba(cm)


def demo_textures():
    """The demo texture set, procedural (jupiter, saturn, mars, ring, crate,
    starfield cubemap)."""
    return TextureSet(
        sphere=(_banded_planet(512, 1024, 9, (0.80, 0.64, 0.48), (0.55, 0.38, 0.28), 1),
                _banded_planet(512, 1024, 6, (0.85, 0.76, 0.55), (0.70, 0.60, 0.42), 2),
                _banded_planet(256, 512, 2, (0.72, 0.35, 0.20), (0.48, 0.22, 0.14), 3)),
        ring=_ring_texture(64, 1024),
        box=_crate_texture(256, 256),
        cubemap=_starfield_cubemap(),
    )


@dataclasses.dataclass
class DemoHandles:
    jupiter: int
    saturn: int
    saturn_rings: int
    mars: int
    box: int
    torus: int


def build_scene(width=1280, height=720):
    """The demo scene and the indices of its animated primitives.  (width
    and height are kept for the JAX signature; the scene does not use them.)"""
    b = SceneBuilder(camera_pos=(0.0, 0.0, -5.0))
    b.ambient_color = (0.025, 0.025, 0.025)   # main.cpp:48
    b.shadow_ambient = (0.1, 0.1, 0.1)        # main.cpp:47

    b.add_light_point((3, 5, 0), (1, 1, 1), 25.5, radius=0.1)   # main.cpp:51
    b.add_light_direct((3, -1, 1), (1, 1, 1), 1.5)              # main.cpp:52

    # blue / red / transparent spheres (main.cpp:55-62)
    b.add_sphere((2, 0, 6), 1, b.material((0, 0, 1), specular=50, reflect=0.35))
    b.add_sphere((-1, 0, 6), 1, b.material((1, 0, 0), specular=100, reflect=0.1), hollow=True)
    b.add_sphere(
        (0.5, 2, 6), 1,
        b.material((1, 1, 1), specular=200, reflect=0.1, refract=1.125,
                   absorb=(1, 0, 2), diffuse=1.0),
        hollow=True,
    )

    # planets (main.cpp:64-85)
    pitch = tuple(SATURN_PITCH.tolist())
    jupiter = b.add_sphere((0, 0, 0), 5000, b.material((0, 0, 0)), texture=1)
    saturn = b.add_sphere((0, 0, 0), SATURN_RADIUS, b.material((0, 0, 0)), texture=2,
                          quat=pitch)
    mars = b.add_sphere((0, 0, 0), 500, b.material((0, 0, 0)), texture=3)

    # saturn ring (main.cpp:88-95)
    ring_q = quat.mul(quat.from_axis_angle([1.0, 0.0, 0.0], math.radians(90.0)), SATURN_PITCH)
    rings = b.add_ring((0, 0, 0), SATURN_RADIUS * 1.1166, SATURN_RADIUS * 2.35,
                       b.material((0, 0, 0)), texture=4, quat=tuple(ring_q.tolist()))

    # floor + crate (main.cpp:98-105)
    b.add_box((0, -1.2, 6), (10, 0.2, 5), b.material((1, 0.6, 0), specular=100, reflect=0.05))
    box = b.add_box((8, 1, 6), (1, 1, 1), b.material((0.8, 0.7, 0), specular=50), texture=5)

    # torus (main.cpp:110-114)
    tq = quat.from_euler([math.radians(45.0), 0.0, 0.0])
    torus = b.add_torus((-9, 0.5, 6), (1.0, 0.5),
                        b.material((0.5, 0.4, 1), specular=200, reflect=0.2),
                        quat=tuple(tq.tolist()))

    # cone + cylinder quadrics (main.cpp:117-132)
    rq = tuple(quat.from_euler([math.radians(90.0), 0.0, 0.0]).tolist())
    b.add_surface(
        sf.elliptic_cone(1 / 3.0, 1 / 3.0, 1.0),
        b.material((234 / 255, 17 / 255, 82 / 255), specular=200, reflect=0.2),
        pos=(-5, 4, 6), quat=rq,
        v_min=(-3.0e38, -1.0, -3.0e38), v_max=(3.0e38, 4.0, 3.0e38),
    )
    b.add_surface(
        sf.elliptic_cylinder(1 / 2.0, 1 / 2.0),
        b.material((200 / 255, 1.0, 0.0), specular=200, reflect=0.2),
        pos=(5, 0, 6), quat=rq,
        v_min=(-3.0e38, -1.0, -3.0e38), v_max=(3.0e38, 1.0, 3.0e38),
    )

    handles = DemoHandles(jupiter=jupiter, saturn=saturn, saturn_rings=rings,
                          mars=mars, box=box, torus=torus)
    return b.build(), handles
