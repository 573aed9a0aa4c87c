"""Scene construction with the reference factory semantics
(txr/scene/factories.py, after SceneManager::create_*, SceneManager.cpp:137-236).

Defaults: material diffuse=0.7, kd=0.8, ks=0.2; point-light linear_k=0.22,
quadratic_k=0.2; ring radii stored squared; reflect_depth 5.  Rows gather
host-side and pack into float32 tensors through numpy, so the values are the
ones the JAX package's SceneBuilder makes.
"""

from __future__ import annotations

import numpy as np
import torch

from txr_torch.scene.types import (
    Boxes,
    Camera,
    DirectLights,
    Materials,
    Planes,
    PointLights,
    Rings,
    Scene,
    Spheres,
    Surfaces,
    Toruses,
)

IDENTITY_QUAT = (0.0, 0.0, 0.0, 1.0)
FLT_MAX = float(np.finfo(np.float32).max)


def material(color, specular=0, reflect=0.0, refract=0.0,
             absorb=(0.0, 0.0, 0.0), diffuse=0.7, kd=0.8, ks=0.2):
    """SceneManager::create_material defaults (SceneManager.h:17)."""
    return dict(color=tuple(color), absorb=tuple(absorb), diffuse=diffuse,
                reflect=reflect, refract=refract, specular=specular, kd=kd, ks=ks)


def _f32(rows, key, shape=()):
    return torch.from_numpy(
        np.array([r[key] for r in rows], dtype=np.float32).reshape((len(rows),) + shape))


def _i32(rows, key):
    return torch.from_numpy(np.array([r[key] for r in rows], dtype=np.int32).reshape(-1))


def _materials(rows):
    mats = [r["mat"] for r in rows]
    return Materials(
        color=_f32(mats, "color", (3,)), absorb=_f32(mats, "absorb", (3,)),
        diffuse=_f32(mats, "diffuse"), reflect=_f32(mats, "reflect"),
        refract=_f32(mats, "refract"), specular=_f32(mats, "specular"),
        kd=_f32(mats, "kd"), ks=_f32(mats, "ks"))


class SceneBuilder:
    """Accumulates primitives host-side, then packs per-type tensors."""

    material = staticmethod(material)

    def __init__(self, camera_pos=(0.0, 0.0, 0.0), camera_quat=IDENTITY_QUAT):
        self.camera_pos = tuple(camera_pos)
        self.camera_quat = tuple(camera_quat)
        self.ambient_color = (0.0, 0.0, 0.0)
        self.shadow_ambient = (0.0, 0.0, 0.0)
        self.bg_color = (0.0, 0.0, 0.0)
        self.reflect_depth = 5
        self.spheres, self.planes, self.surfaces = [], [], []
        self.boxes, self.toruses, self.rings = [], [], []
        self.lights_point, self.lights_direct = [], []

    def add_sphere(self, center, radius, mat, hollow=False, texture=0, quat=IDENTITY_QUAT):
        self.spheres.append(dict(pos=tuple(center), radius=radius, quat=tuple(quat),
                                 texture=texture, hollow=hollow, mat=mat))
        return len(self.spheres) - 1

    def add_plane(self, normal, pos, mat):
        self.planes.append(dict(pos=tuple(pos), normal=tuple(normal), mat=mat))
        return len(self.planes) - 1

    def add_box(self, pos, form, mat, texture=0, quat=IDENTITY_QUAT):
        """form = half extents."""
        self.boxes.append(dict(pos=tuple(pos), form=tuple(form), quat=tuple(quat),
                               texture=texture, mat=mat))
        return len(self.boxes) - 1

    def add_torus(self, pos, form, mat, quat=IDENTITY_QUAT):
        """form = (major radius R, tube radius r), axis = local z."""
        self.toruses.append(dict(pos=tuple(pos), form=tuple(form), quat=tuple(quat), mat=mat))
        return len(self.toruses) - 1

    def add_ring(self, pos, r1, r2, mat, texture=0, quat=IDENTITY_QUAT):
        """Radii given unsquared, stored squared like the reference."""
        self.rings.append(dict(pos=tuple(pos), r1=r1 * r1, r2=r2 * r2, quat=tuple(quat),
                               texture=texture, mat=mat))
        return len(self.rings) - 1

    def add_surface(self, coef, mat, pos=(0.0, 0.0, 0.0), quat=IDENTITY_QUAT,
                    v_min=(-FLT_MAX,) * 3, v_max=(FLT_MAX,) * 3):
        """Raw quadric (a,b,c,d,e,f); see surface_factory for named shapes."""
        self.surfaces.append(dict(pos=tuple(pos), quat=tuple(quat), coef=tuple(coef),
                                  v_min=tuple(v_min), v_max=tuple(v_max), mat=mat))
        return len(self.surfaces) - 1

    def add_light_point(self, pos, color, intensity, radius=0.1,
                        linear_k=0.22, quadratic_k=0.2):
        self.lights_point.append(dict(pos=tuple(pos), radius=radius, color=tuple(color),
                                      intensity=intensity, linear_k=linear_k,
                                      quadratic_k=quadratic_k))
        return len(self.lights_point) - 1

    def add_light_direct(self, direction, color, intensity):
        self.lights_direct.append(dict(direction=tuple(direction), color=tuple(color),
                                       intensity=intensity))
        return len(self.lights_direct) - 1

    def build(self) -> Scene:
        sp, pl, su, bx, to, ri = (self.spheres, self.planes, self.surfaces,
                                  self.boxes, self.toruses, self.rings)
        lp, ld = self.lights_point, self.lights_direct
        vec = lambda v: torch.from_numpy(np.asarray(v, np.float32))
        return Scene(
            camera=Camera(pos=vec(self.camera_pos), quat=vec(self.camera_quat)),
            ambient_color=vec(self.ambient_color),
            shadow_ambient=vec(self.shadow_ambient),
            bg_color=vec(self.bg_color),
            spheres=Spheres(
                pos=_f32(sp, "pos", (3,)), radius=_f32(sp, "radius"),
                quat=_f32(sp, "quat", (4,)), texture=_i32(sp, "texture"),
                hollow=torch.from_numpy(np.array([r["hollow"] for r in sp], bool).reshape(-1)),
                mat=_materials(sp)),
            planes=Planes(pos=_f32(pl, "pos", (3,)), normal=_f32(pl, "normal", (3,)),
                          mat=_materials(pl)),
            surfaces=Surfaces(
                pos=_f32(su, "pos", (3,)), quat=_f32(su, "quat", (4,)),
                coef=_f32(su, "coef", (6,)), v_min=_f32(su, "v_min", (3,)),
                v_max=_f32(su, "v_max", (3,)), mat=_materials(su)),
            boxes=Boxes(pos=_f32(bx, "pos", (3,)), quat=_f32(bx, "quat", (4,)),
                        form=_f32(bx, "form", (3,)), texture=_i32(bx, "texture"),
                        mat=_materials(bx)),
            toruses=Toruses(pos=_f32(to, "pos", (3,)), quat=_f32(to, "quat", (4,)),
                            form=_f32(to, "form", (2,)), mat=_materials(to)),
            rings=Rings(pos=_f32(ri, "pos", (3,)), quat=_f32(ri, "quat", (4,)),
                        r1=_f32(ri, "r1"), r2=_f32(ri, "r2"),
                        texture=_i32(ri, "texture"), mat=_materials(ri)),
            lights_point=PointLights(
                pos=_f32(lp, "pos", (3,)), radius=_f32(lp, "radius"),
                color=_f32(lp, "color", (3,)), intensity=_f32(lp, "intensity"),
                linear_k=_f32(lp, "linear_k"), quadratic_k=_f32(lp, "quadratic_k")),
            lights_direct=DirectLights(
                direction=_f32(ld, "direction", (3,)), color=_f32(ld, "color", (3,)),
                intensity=_f32(ld, "intensity")),
            reflect_depth=self.reflect_depth,
        )
