"""A configuration's scene as plain numbers.

A configuration file (``rtbench/configs/<name>.json``) holds the scene as
data: each primitive's position, size, rotation and material, the lights,
the textures' kinds and sizes, and the animation's constants.  This module
turns it into per-type lists of float64 numpy rows, the same rows that the
harness hands to the program's ``SceneBuilder`` and that the reference
reads (both after rounding to the configuration's float32).  It imports
neither the program nor the reference.

A configuration needs ``render``, ``material_defaults`` and, in ``scene``,
the camera, ``ambient_color``, ``shadow_ambient`` and ``bg_color``.  It may
leave out:

- ``handles`` (the demo's animated primitives, by type and name): without
  them every frame renders the scene as built, from its own viewpoint;
- ``animation``: without it every primitive keeps its position;
- ``textures``, or any of its roles (``sphere``, ``ring``, ``box``,
  ``cubemap``): a role left out is no texture, a missing cubemap shows
  ``bg_color``;
- any primitive type (``spheres``, ``planes``, ``surfaces``, ``boxes``,
  ``toruses``, ``rings``), and either kind of light (``lights_point``,
  ``lights_direct``).

Each primitive is listed explicitly: the harness generates no scene.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TYPES = ("spheres", "planes", "surfaces", "boxes", "toruses", "rings")
FLT_MAX = float(np.finfo(np.float32).max)


def load_config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _qmul(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def rotation(spec):
    """A rotation of the configuration → quaternion (x, y, z, w): a list of
    four numbers; {"euler_deg": [pitch, yaw, roll]} as glm::quat(vec3);
    {"axis_angle_deg": [axis, angle]} as glm::angleAxis; {"then": [a, b]}
    the Hamilton product a·b."""
    if spec is None:
        return np.array([0.0, 0.0, 0.0, 1.0])
    if isinstance(spec, list):
        return np.asarray(spec, np.float64)
    if "then" in spec:
        q = rotation(spec["then"][0])
        for s in spec["then"][1:]:
            q = _qmul(q, rotation(s))
        return q
    if "euler_deg" in spec:
        p = np.radians(np.asarray(spec["euler_deg"], np.float64)) / 2.0
        cx, cy, cz = np.cos(p)
        sx, sy, sz = np.sin(p)
        return np.array([sx * cy * cz - cx * sy * sz, cx * sy * cz + sx * cy * sz,
                         cx * cy * sz - sx * sy * cz, cx * cy * cz + sx * sy * sz])
    axis, angle = spec["axis_angle_deg"]
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    half = math.radians(angle) / 2.0
    return np.concatenate([axis * math.sin(half), [math.cos(half)]])


def _material(cfg, m):
    out = dict(cfg["material_defaults"])
    out.update(m or {})
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def scene_rows(cfg):
    """The configuration's scene → dict: camera (pos, quat), ambient_color,
    shadow_ambient, bg_color, lights_point, lights_direct, and per type a
    list of primitives, each a dict of float64 arrays (rings' radii
    squared, as the reference stores them), with ``name``, ``texture``
    (int) and ``hollow`` (bool) kept as given."""
    sc = cfg["scene"]
    f = lambda v: np.asarray(v, np.float64)
    out = dict(camera=dict(pos=f(sc["camera"]["pos"]), quat=rotation(sc["camera"].get("quat"))),
               ambient_color=f(sc["ambient_color"]), shadow_ambient=f(sc["shadow_ambient"]),
               bg_color=f(sc["bg_color"]),
               lights_point=[dict(pos=f(l["pos"]), color=f(l["color"]),
                                  intensity=f(l["intensity"]), radius=f(l.get("radius", 0.1)),
                                  linear_k=f(l.get("linear_k", 0.22)),
                                  quadratic_k=f(l.get("quadratic_k", 0.2)))
                             for l in sc.get("lights_point", [])],
               lights_direct=[dict(direction=f(l["direction"]), color=f(l["color"]),
                                   intensity=f(l["intensity"]))
                              for l in sc.get("lights_direct", [])])
    for kind in TYPES:
        rows = []
        for p in sc.get(kind, []):
            r = dict(name=p["name"], mat=_material(cfg, p.get("mat")),
                     texture=int(p.get("texture", 0)), hollow=bool(p.get("hollow", False)))
            r["pos"] = f(p["pos"])
            if kind != "planes":
                r["quat"] = rotation(p.get("quat"))
            if kind == "spheres":
                r["radius"] = f(p["radius"])
            elif kind == "planes":
                r["normal"] = f(p["normal"])
            elif kind == "surfaces":
                r["coef"] = f(p["coef"])
                r["v_min"] = f(p.get("v_min", [-FLT_MAX] * 3))
                r["v_max"] = f(p.get("v_max", [FLT_MAX] * 3))
            elif kind in ("boxes", "toruses"):
                r["form"] = f(p["form"])
            elif kind == "rings":
                r["r1"], r["r2"] = f(p["r1"] ** 2), f(p["r2"] ** 2)
            rows.append(r)
        out[kind] = rows
    return out


def index_of(rows, kind, name):
    return [r["name"] for r in rows[kind]].index(name)


def posed_positions(cfg, rows, t):
    """{(kind, index): float64 [3] position} of the animated primitives at
    time ``t`` seconds, from the configuration's animation constants: each
    axis ``[fn, amplitude, rate, phase]`` is amplitude·fn(rate·t + phase);
    an axis not listed keeps the primitive's position; no animation, no
    entry."""
    out = {}
    for a in cfg.get("animation", []):
        kind, name = a["prim"]
        i = index_of(rows, kind, name)
        pos = rows[kind][i]["pos"].copy()
        for axis, col in (("x", 0), ("y", 1), ("z", 2)):
            if axis in a:
                fn, amp, rate, phase = a[axis]
                pos[col] = amp * {"cos": math.cos, "sin": math.sin}[fn](rate * t + phase)
        out[(kind, i)] = pos
    return out


def as_float32(x):
    """x rounded to float32, as the program is handed it, back in float64."""
    return np.asarray(np.asarray(x, np.float64).astype(np.float32), np.float64)
