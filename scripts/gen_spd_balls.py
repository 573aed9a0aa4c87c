#!/usr/bin/env python3
"""Write the benchmark's configuration of the SPD ``balls`` scene, the
sphereflake (E. Haines, "A Proposal for Standard Graphics Environments",
IEEE CG&A 7(11), 1987; the Standard Procedural Databases' ``balls.c``), at
its default size factor 4, as ``rtbench/configs/spd-balls-1080p.json``.

    python3 scripts/gen_spd_balls.py [--check]

The harness reads the primitives listed in the file, not this script; the
script is how the file was made, and ``--check`` exits non-zero unless the
file is what it writes, byte for byte.

The flake as ``balls.c`` builds it: a sphere of radius 0.5 at the origin;
each sphere has 9 children of a third of its radius that touch it, in the
directions of ``objset`` (3 above its equator, 6 on it) turned from +z into
the direction from its parent to it, so that no child grows back into its
grandparent; 4 levels below the root, written depth first as ``balls.c``
writes them: 1 + 9 + 81 + 729 + 6,561 = 7,381 spheres.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "rtbench", "configs", "spd-balls-1080p.json")
SIZE_FACTOR = 4
ROOT_RADIUS = 0.5
FROM, AT, UP = (2.1, 1.3, 1.7), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0)
# the SPD's view is 45 degrees tall; the port's camera has a fixed field,
# 2 atan(1/2) tall (render/raygen.py: a ray leaves at (y - h/2)/h), so the eye
# moves along the view line to this share of its distance from AT, where the
# plane through AT that faces the eye is framed as the SPD frames it
EYE_SHARE = math.tan(math.radians(22.5)) / 0.5
EYE = tuple(a + EYE_SHARE * (f - a) for f, a in zip(FROM, AT))
LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
BACKGROUND = (0.078, 0.361, 0.753)
FLOOR_HALF, FLOOR_Z, FLOOR_HALF_THICK = 12.0, -0.5, 0.005
# NFF "f" lines (colour, Kd, Ks, shine), balls.c: the flake's shiny gold and
# the floor's matte beige; shine = ln 0.5 / ln cos 37°, the flake's
# highlight angle
FLAKE_F = ((1.0, 0.9, 0.7), 0.5, 0.5, math.log(0.5) / math.log(math.cos(math.radians(37.0))))
FLOOR_F = ((1.0, 0.75, 0.33), 0.8, 0.0, 0.0)


def axis_rotate(axis, angle):
    """The right-handed rotation by ``angle`` about the unit ``axis``
    (libpr's lib_create_axis_rotate_matrix as lib_transform_vector applies
    it) → 3×3."""
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    t = 1.0 - c
    return np.array([[x * x * t + c, x * y * t - z * s, x * z * t + y * s],
                     [x * y * t + z * s, y * y * t + c, y * z * t - x * s],
                     [x * z * t - y * s, y * z * t + x * s, z * z * t + c]])


def objset():
    """balls.c create_objset: the 9 unit directions of a sphere's children
    about +z."""
    d = 1.0 / math.sqrt(2.0)
    trio = np.array([[d, d, 0.0], [d, 0.0, -d], [0.0, d, -d]])
    axis = np.array([1.0, -1.0, 0.0]) / math.sqrt(2.0)
    trio = trio @ axis_rotate(axis, math.asin(2.0 / math.sqrt(6.0))).T
    out = []
    for k in range(3):
        spin = axis_rotate((0.0, 0.0, 1.0), k * 2.0 * math.pi / 3.0)
        out += [spin @ v for v in trio]
    return np.array(out)


def to_direction(direction):
    """The rotation that takes +z into the unit ``direction``."""
    if direction[2] >= 1.0:
        return np.eye(3)
    if direction[2] <= -1.0:
        return axis_rotate((0.0, 1.0, 0.0), math.pi)
    axis = np.cross((0.0, 0.0, 1.0), direction)
    axis = axis / np.linalg.norm(axis)
    return axis_rotate(axis, math.acos(direction[2]))


def flake(depth=SIZE_FACTOR):
    """[(center float64 [3], radius, level)] in balls.c's order, depth
    first from the root."""
    dirs = objset()
    out = []

    def grow(center, radius, direction, level):
        out.append((center, radius, level))
        if level == depth:
            return
        mx = to_direction(direction)
        child_r = radius / 3.0
        for v in dirs:
            child_dir = mx @ v
            grow(center + child_dir * (radius + child_r), child_r, child_dir, level + 1)

    grow(np.zeros(3), ROOT_RADIUS, np.array([0.0, 0.0, 1.0]), 0)
    return out


def camera_quat():
    """The quaternion (x, y, z, w) that turns the port's camera frame (x to
    the image's right, y up, z forward) so that it looks from FROM (and
    EYE) at AT with UP up."""
    f = np.subtract(AT, FROM)
    f = f / np.linalg.norm(f)
    u = np.asarray(UP) - np.dot(UP, f) * f
    u = u / np.linalg.norm(u)
    r = np.cross(u, f)
    m = np.stack([r, u, f], 1)
    w = math.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    return [(m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
            (m[1, 0] - m[0, 1]) / (4 * w), w]


def num(x):
    """A number as the file writes it: 9 significant digits, enough to
    round to the same float32."""
    return float(f"{float(x):.9g}")


def material(f_line):
    color, kd, ks, shine = f_line
    return dict(color=[num(c) for c in color], diffuse=1.0, kd=num(kd), ks=num(ks),
                specular=num(shine), reflect=num(ks), refract=0.0, absorb=[0.0, 0.0, 0.0])


def config():
    spheres = [dict(name=f"s{i}", pos=[num(x) for x in c], radius=num(r))
               for i, (c, r, _) in enumerate(flake())]
    intensity = num(1.0 / math.sqrt(len(LIGHTS)))
    return dict(
        name="spd-balls-1080p",
        source=("E. Haines, Standard Procedural Databases, balls.c (sphereflake), size factor 4: "
                "7,381 spheres + floor; IEEE CG&A 7(11), 1987"),
        reduced=[],
        assumed=[
            "1920x1080 at 1 sample a pixel in place of the SPD's 512x512",
            "the camera: looking at the origin with +z up, along the SPD's view line from (2.1, 1.3, 1.7); "
            "the port's camera has a fixed field (2 atan(1/2) = 53.13 degrees tall) where the "
            "SPD's is 45 degrees, so the eye stands at tan(22.5 deg)/tan(26.57 deg) = 0.828427 "
            "of the SPD's distance, (1.73970, 1.07696, 1.40833), where the plane through the "
            "origin facing it is framed as the SPD frames it (the perspective is that much "
            "stronger); the port puts its x axis at the image's right, so the image is the SPD "
            "view's mirror image",
            "the floor polygon (the square of half side 12 at z = -0.5) as a box of that square's "
            "extent, 0.01 thick, its top face at z = -0.5: the port has no polygon",
            "NFF's f line (colour, Kd, Ks, shine) as the port's material: colour, diffuse 1 and "
            "kd = Kd, ks = Ks, specular = shine, reflect = Ks (NFF's Ks is also the reflection "
            "coefficient), no refraction; the flake f 1 0.9 0.7 0.5 0.5 3.0827, the floor "
            "f 1 0.75 0.33 0.8 0 0 (as balls.c writes them, recalled: not checked against its "
            "source here)",
            "the three lights white, no attenuation, each of intensity 1/sqrt(3), the 1/sqrt(n) "
            "that the NFF notes suggest for n lights; each drawn as a bulb of radius 0, which no "
            "ray hits (NFF lights are points)",
            "no ambient light and no shadow ambient: NFF has neither",
            "reflect depth 5 (iterations 5, as the demo configuration) and no refraction steps: "
            "nothing refracts",
            "the flake's 9 child directions, its order and the first child at (0.272166, 0.272166, "
            "0.544331) of radius 0.166667 as balls.c builds them; every child touches its parent "
            "(the generator scripts/gen_spd_balls.py and its tests check it)",
        ],
        precision="float32",
        render=dict(width=1920, height=1080, iterations=5, extra_refraction_steps=0,
                    aa_preset=None, fused="auto", texture_lod=True, edge_threshold=0.02,
                    edge_budget_mult=20),
        material_defaults=material(FLAKE_F),
        scene=dict(
            camera=dict(pos=[num(x) for x in EYE], quat=[num(x) for x in camera_quat()]),
            ambient_color=[0.0, 0.0, 0.0], shadow_ambient=[0.0, 0.0, 0.0],
            bg_color=[num(x) for x in BACKGROUND],
            lights_point=[dict(pos=list(p), color=[1.0, 1.0, 1.0], intensity=intensity,
                               radius=0.0, linear_k=0.0, quadratic_k=0.0) for p in LIGHTS],
            spheres=spheres,
            boxes=[dict(name="floor", pos=[0.0, 0.0, num(FLOOR_Z - FLOOR_HALF_THICK)],
                        form=[FLOOR_HALF, FLOOR_HALF, FLOOR_HALF_THICK],
                        mat=material(FLOOR_F))]))


def text():
    """The file's text: a key a line, the spheres one a line."""
    cfg = config()
    spheres = cfg["scene"]["spheres"]
    cfg["scene"]["spheres"] = "@"
    body = ",\n".join("   " + json.dumps(s) for s in spheres)
    return json.dumps(cfg, indent=1).replace('"@"', "[\n" + body + "\n  ]") + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the file is what this script writes")
    args = ap.parse_args(argv)
    out = text()
    if args.check:
        with open(OUT) as f:
            same = f.read() == out
        print("same" if same else f"{OUT} differs from what the script writes")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(out)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
