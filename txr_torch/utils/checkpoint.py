"""Scene and optimisation checkpoints (txr/utils/checkpoint.py).

A tree of dataclasses, dicts, tuples and lists is flattened to dotted keys
("scene.spheres.pos", "params.camera.pos", ...) and written as one
compressed ``.npz`` with a ``__meta__`` JSON entry listing the keys whose
value was None.  Keys and meta are the JAX package's, so a scene file
written by either package loads in the other.  Restoring needs a template
of the same structure (the topology): values come from the file, dtype and
device from the template.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), f"{prefix}{f.name}."))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif tree is None:
        out[prefix[:-1] + "#none"] = None
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _atomic_savez(path, meta, arrays):
    """Write to a temporary file beside ``path``, then rename it over
    ``path``: a crash (SIGKILL, host loss) during a save leaves the last good
    checkpoint intact."""
    # keep the .npz suffix: np.savez would append one otherwise
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _save_flat(path, flat):
    arrays = {k: v for k, v in flat.items() if v is not None}
    meta = {"none_keys": [k for k, v in flat.items() if v is None]}
    return _atomic_savez(path, meta, arrays)


def save_scene(path, scene, textures=None, extra=None):
    """Write a scene (and optionally textures and extra arrays) to ``path``
    (.npz).  Returns path."""
    flat = {f"scene.{k}": v for k, v in _flatten(scene).items()}
    if textures is not None:
        flat.update({f"tex.{k}": v for k, v in _flatten(textures).items()})
    if extra:
        flat.update({f"extra.{k}": v for k, v in _flatten(extra).items()})
    return _save_flat(path, flat)


def load_arrays(path):
    """→ ({dotted key: ndarray}, set of the keys that held None)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return arrays, set(meta.get("none_keys", []))


def rebuild_tree(arrays, template, prefix=""):
    """The inverse of ``_flatten``: ``template``'s structure (dataclasses,
    named tuples, tuples, lists, dicts) with values from ``arrays``; a tensor
    takes the template leaf's dtype and device, a Python scalar its type."""
    if dataclasses.is_dataclass(template):
        kw = {f.name: rebuild_tree(arrays, getattr(template, f.name), f"{prefix}{f.name}.")
              for f in dataclasses.fields(template)}
        return dataclasses.replace(template, **kw)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(rebuild_tree(arrays, v, f"{prefix}{i}.")
                                for i, v in enumerate(template)))
    if isinstance(template, (tuple, list)):
        return type(template)([rebuild_tree(arrays, v, f"{prefix}{i}.")
                               for i, v in enumerate(template)])
    if isinstance(template, dict):
        return {k: rebuild_tree(arrays, template[k], f"{prefix}{k}.") for k in sorted(template)}
    if template is None:
        return None
    arr = arrays[prefix[:-1]]
    if isinstance(template, (bool, int, float, str)):
        return type(template)(arr)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(np.array(arr), dtype=template.dtype, device=template.device)
    return np.asarray(arr, dtype=np.asarray(template).dtype)


def save_state(path, state):
    """Checkpoint a tree ``state`` (e.g. {"params": ..., "opt_state": ...,
    "step": ...}) to ``path`` (.npz)."""
    return _save_flat(path, _flatten(state))


def restore_state(path, template):
    """The inverse of ``save_state``: ``template``'s structure with the
    file's values."""
    arrays, _ = load_arrays(path)
    return rebuild_tree(arrays, template)


def restore_scene(path, scene_template, textures_template=None):
    """(scene, textures) from a ``save_scene`` file, the templates giving
    the structure; textures is None without a template."""
    arrays, _ = load_arrays(path)
    scene = rebuild_tree(arrays, scene_template, "scene.")
    textures = (rebuild_tree(arrays, textures_template, "tex.")
                if textures_template is not None else None)
    return scene, textures
