"""Carry scenes and textures between the JAX package and the port, as numpy.

The bridge never sees JAX: a caller flattens the JAX ``Scene`` to numpy
leaves keyed by their pytree paths (``jax.tree_util.keystr``, e.g.
``".spheres.mat.color"``), and ``scene_from_numpy`` rebuilds the port's
``Scene`` from them.  ``scene_to_numpy`` gives the port's scene back in the
same keys, so two scenes compare leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from txr_torch.render.texture import TextureSet
from txr_torch.scene import types as T


def _build(cls, leaves, prefix):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name == "reflect_depth":
            continue
        key = f"{prefix}.{f.name}"
        sub = getattr(T, f.type, None)        # field annotations are strings
        if dataclasses.is_dataclass(sub):
            kw[f.name] = _build(sub, leaves, key)
        else:
            kw[f.name] = torch.from_numpy(np.array(leaves[key]))
    return cls(**kw)


def scene_from_numpy(leaves, reflect_depth=5) -> T.Scene:
    """{keystr: ndarray} of every Scene leaf → the port's Scene (CPU)."""
    scene = _build(T.Scene, leaves, "")
    return dataclasses.replace(scene, reflect_depth=reflect_depth)


def scene_to_numpy(scene: T.Scene):
    """The port's Scene → {keystr: ndarray}, keyed like ``scene_from_numpy``."""
    out = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}.{f.name}"
            if dataclasses.is_dataclass(v):
                walk(v, key)
            elif isinstance(v, torch.Tensor):
                out[key] = v.detach().cpu().numpy()

    walk(scene, "")
    return out


def grads_to_numpy(grads):
    """{dotted path: gradient tensor or None} of the port (e.g. from
    ``torch.autograd.grad`` over ``scene.types.float_leaves``) → {keystr:
    ndarray}, keyed like the JAX package's gradient pytree, so gradients
    compare leaf for leaf; None (an unused leaf) is left out."""
    return {f".{path}": g.detach().cpu().numpy() for path, g in grads.items() if g is not None}


def textures_from_numpy(sphere=(), ring=None, box=None, cubemap=None) -> TextureSet:
    """Raw texture images (numpy [H,W,4] f32; cubemap [6,S,S,4]) → the
    port's TextureSet on the CPU, before ``with_mips``."""
    t = lambda a: None if a is None else torch.from_numpy(np.array(a, np.float32))
    return TextureSet(sphere=tuple(t(s) for s in sphere), ring=t(ring), box=t(box),
                      cubemap=t(cubemap))
