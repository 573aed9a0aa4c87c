"""Per-slot type and index tables (txr/render/intersect.py:40-59).

Slot order is the reference's processing order: planes → spheres →
surfaces → boxes → toruses → rings → point-light bulbs.
"""

from __future__ import annotations

import torch

from txr_torch.scene.types import (
    TYPE_BOX,
    TYPE_PLANE,
    TYPE_POINT_LIGHT,
    TYPE_RING,
    TYPE_SPHERE,
    TYPE_SURFACE,
    TYPE_TORUS,
)


def _type_tables(scene):
    """(type [n_slots], index-within-type [n_slots]) int64 tensors."""
    c = scene.counts
    order = [(TYPE_PLANE, c["planes"]), (TYPE_SPHERE, c["spheres"]),
             (TYPE_SURFACE, c["surfaces"]), (TYPE_BOX, c["boxes"]),
             (TYPE_TORUS, c["toruses"]), (TYPE_RING, c["rings"]),
             (TYPE_POINT_LIGHT, c["lights_point"])]
    types, idxs = [], []
    for ty, n in order:
        types += [ty] * n
        idxs += list(range(n))
    dev = scene.device
    return (torch.tensor(types, dtype=torch.int64, device=dev),
            torch.tensor(idxs, dtype=torch.int64, device=dev))
