"""Scene data model: dataclasses of per-type tensors (txr/scene/types.py).

One stacked tensor per field, batched over the primitive axis.  Counts are
the leading dims (``Scene.counts``), the port's counterpart of the
reference's compile-time ``{TYPE_SIZE}`` defines (scene.h:142-153).
"""

from __future__ import annotations

import dataclasses

import torch

# Hit-type codes, matching rt.frag:7-13.
TYPE_SPHERE = 0
TYPE_PLANE = 1
TYPE_SURFACE = 2
TYPE_BOX = 3
TYPE_TORUS = 4
TYPE_RING = 5
TYPE_POINT_LIGHT = 6


class _Tensors:
    """``.to(device)`` over every tensor field, recursing into nested
    dataclasses of tensors."""

    def to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device) if hasattr(v, "to") else v
        return dataclasses.replace(self, **out)


@dataclasses.dataclass
class Materials(_Tensors):
    """rt_material SoA (scene.h:22-35).  All shapes [N, ...]."""

    color: torch.Tensor      # [N,3]
    absorb: torch.Tensor     # [N,3] Beer-Lambert absorption coefficients
    diffuse: torch.Tensor    # [N]
    reflect: torch.Tensor    # [N]
    refract: torch.Tensor    # [N] index of refraction; 0 => opaque
    specular: torch.Tensor   # [N] Phong exponent
    kd: torch.Tensor         # [N]
    ks: torch.Tensor         # [N]


@dataclasses.dataclass
class Spheres(_Tensors):
    pos: torch.Tensor        # [N,3]
    radius: torch.Tensor     # [N]
    quat: torch.Tensor       # [N,4] rotates the normal for texturing only
    texture: torch.Tensor    # [N] int32, 0 = untextured
    hollow: torch.Tensor     # [N] bool — take the far root when inside
    mat: Materials


@dataclasses.dataclass
class Planes(_Tensors):
    pos: torch.Tensor        # [N,3]
    normal: torch.Tensor     # [N,3]
    mat: Materials


@dataclasses.dataclass
class Boxes(_Tensors):
    pos: torch.Tensor        # [N,3]
    quat: torch.Tensor       # [N,4] world->box rotation
    form: torch.Tensor       # [N,3] half extents
    texture: torch.Tensor    # [N] int32
    mat: Materials


@dataclasses.dataclass
class Toruses(_Tensors):
    pos: torch.Tensor        # [N,3]
    quat: torch.Tensor       # [N,4]
    form: torch.Tensor       # [N,2] (major R, minor r), z axis
    mat: Materials


@dataclasses.dataclass
class Rings(_Tensors):
    pos: torch.Tensor        # [N,3]
    quat: torch.Tensor       # [N,4]
    r1: torch.Tensor         # [N] inner radius², stored squared
    r2: torch.Tensor         # [N] outer radius²
    texture: torch.Tensor    # [N] int32
    mat: Materials


@dataclasses.dataclass
class Surfaces(_Tensors):
    """Quadric a x² + b y² + c z² + d z + e y + f = 0 in the rotated local
    frame, clipped by a world-space AABB [v_min, v_max]."""

    pos: torch.Tensor        # [N,3]
    quat: torch.Tensor       # [N,4]
    coef: torch.Tensor       # [N,6]
    v_min: torch.Tensor      # [N,3]
    v_max: torch.Tensor      # [N,3]
    mat: Materials


@dataclasses.dataclass
class PointLights(_Tensors):
    pos: torch.Tensor        # [N,3]
    radius: torch.Tensor     # [N] light-bulb sphere radius
    color: torch.Tensor      # [N,3]
    intensity: torch.Tensor  # [N]
    linear_k: torch.Tensor   # [N]
    quadratic_k: torch.Tensor  # [N]


@dataclasses.dataclass
class DirectLights(_Tensors):
    direction: torch.Tensor  # [N,3]
    color: torch.Tensor      # [N,3]
    intensity: torch.Tensor  # [N]


@dataclasses.dataclass
class Camera(_Tensors):
    pos: torch.Tensor        # [3]
    quat: torch.Tensor       # [4] camera->world rotation


@dataclasses.dataclass
class Scene(_Tensors):
    """The reference's ``scene_container`` (scene.h:128-154) as tensors.
    ``reflect_depth`` is the authored bounce budget (SceneManager.cpp:233)."""

    camera: Camera
    ambient_color: torch.Tensor   # [3]
    shadow_ambient: torch.Tensor  # [3]
    bg_color: torch.Tensor        # [3]
    spheres: Spheres
    planes: Planes
    surfaces: Surfaces
    boxes: Boxes
    toruses: Toruses
    rings: Rings
    lights_point: PointLights
    lights_direct: DirectLights
    reflect_depth: int = 5

    @property
    def counts(self):
        return {
            "spheres": self.spheres.radius.shape[0],
            "planes": self.planes.pos.shape[0],
            "surfaces": self.surfaces.coef.shape[0],
            "boxes": self.boxes.pos.shape[0],
            "toruses": self.toruses.pos.shape[0],
            "rings": self.rings.pos.shape[0],
            "lights_point": self.lights_point.pos.shape[0],
            "lights_direct": self.lights_direct.direction.shape[0],
        }

    @property
    def device(self):
        return self.camera.pos.device


def flatten_with_paths(tree, prefix=""):
    """{dotted path: leaf} of a dataclass tree, e.g. "spheres.mat.color"
    (txr/diff/optimize.py:72-81).  Non-tensor fields (reflect_depth) are
    left out."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten_with_paths(v, f"{prefix}{f.name}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{f.name}"] = v
    return out


def unflatten_like(template, flat, prefix=""):
    """``template`` with each leaf whose dotted path is in ``flat`` replaced."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            kw[f.name] = unflatten_like(v, flat, path + ".")
        elif path in flat:
            kw[f.name] = flat[path]
    return dataclasses.replace(template, **kw)


def float_leaves(tree):
    """The floating-point leaves of ``flatten_with_paths``."""
    return {k: v for k, v in flatten_with_paths(tree).items() if v.is_floating_point()}
