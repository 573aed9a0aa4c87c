"""Primitive-sharded ring sweep: nearest hit for scenes too large to
replicate (txr/dist/ring.py).

Each rank keeps 1/n of every primitive group (the contiguous block
``[me·c, (me+1)·c)`` of the group padded to a multiple of n) and the ray
tiles travel around the ring of ranks, the ring-attention pattern with rays
as queries and primitive shards as the key/value blocks:

    hop 0:  tile_me    against shard_me      (the local nearest-hit sweep)
    hop k:  the tile k hops upstream against shard_me
    carry:  the running (t, type, index, slot) winner rides with its tile

After n hops every tile has met every shard once and is home again; one
``all_gather`` then gives every rank the whole answer.  Forward only and
detached, as the JAX package uses its ring.

Ties: inside a shard the sweep keeps the reference's slot order with strict
``<``; across shards an exact t tie goes to the lower GLOBAL slot (type
major, then the global index), the winner the replicated sweep's strict
``<`` picks, so the answer does not depend on the order of the visits.

On the card the local sweep is the nearest-hit kernel, whose library is
built per topology: a shard's counts are another topology, built at its
first use unless ``build.build_all(shard_topologies(scene, n))`` built it
ahead.
"""

from __future__ import annotations

import dataclasses

import torch

from txr_torch import resolve_device
from txr_torch.dist.mesh import all_gather_rows, ring_shift
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render.intersect import _sweep
from txr_torch.scene.types import (
    TYPE_BOX,
    TYPE_PLANE,
    TYPE_POINT_LIGHT,
    TYPE_RING,
    TYPE_SPHERE,
    TYPE_SURFACE,
    TYPE_TORUS,
)

# Padding primitives are parked this far from the origin; a "hit" beyond the
# cap is a phantom of f32 rounding on a padded slot and reads as a miss.
# Reference scenes span about 3.5e4 units (Saturn's orbit).
_PAD_POS = 3.0e8
_T_CAP = 1.0e8
_NO_SLOT = torch.iinfo(torch.int32).max

# (scene field, type code) in the reference processing order
_PRIM_FIELDS = (
    ("planes", TYPE_PLANE),
    ("spheres", TYPE_SPHERE),
    ("surfaces", TYPE_SURFACE),
    ("boxes", TYPE_BOX),
    ("toruses", TYPE_TORUS),
    ("rings", TYPE_RING),
    ("lights_point", TYPE_POINT_LIGHT),
)


def _count(group):
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            return v.shape[0]
    return 0


def _pad_group(group, n, miss):
    """Every leaf of a primitive group padded to a count divisible by n:
    with the value ``miss`` gives for its field, zeros otherwise (nested
    materials too)."""
    pad = (-_count(group)) % n
    if pad == 0:
        return group
    out = {}
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _pad_group(v, n, {})
            continue
        tail = tuple(v.shape[1:])
        fill = miss.get(f.name)
        if fill is None:
            block = torch.zeros((pad,) + tail, dtype=v.dtype, device=v.device)
        else:
            block = torch.as_tensor(fill, dtype=v.dtype, device=v.device).expand((pad,) + tail)
        out[f.name] = torch.cat([v, block])
    return dataclasses.replace(group, **out)


def pad_scene_for_ring(scene, n):
    """The scene with every primitive count padded to a multiple of n by
    primitives that never hit (the originals keep their indices: the
    padding is appended)."""
    far = (_PAD_POS, _PAD_POS, _PAD_POS)
    quat_id = (0.0, 0.0, 0.0, 1.0)
    return dataclasses.replace(
        scene,
        planes=_pad_group(scene.planes, n, {"pos": far, "normal": (0.0, 0.0, 0.0)}),
        spheres=_pad_group(scene.spheres, n, {"pos": far, "radius": 0.0, "quat": quat_id}),
        # an inverted clip box (v_min > v_max): the in-box test always fails
        surfaces=_pad_group(
            scene.surfaces, n,
            {"pos": far, "quat": quat_id, "coef": (1.0, 1.0, 1.0, 0.0, 0.0, -1.0),
             "v_min": (1.0, 1.0, 1.0), "v_max": (-1.0, -1.0, -1.0)}),
        boxes=_pad_group(scene.boxes, n, {"pos": far, "quat": quat_id, "form": (0.0, 0.0, 0.0)}),
        toruses=_pad_group(scene.toruses, n, {"pos": far, "quat": quat_id, "form": (0.0, 0.0)}),
        # r2 < r1: the annulus r1 < p < r2 is empty
        rings=_pad_group(scene.rings, n, {"pos": far, "quat": quat_id, "r1": 1.0, "r2": 0.0}),
        lights_point=_pad_group(scene.lights_point, n, {"pos": far, "radius": 0.0}),
        lights_direct=_pad_group(scene.lights_direct, n, {}),
    )


def _shard(group, me, n):
    """Block ``me`` of n of every leaf of a (padded) primitive group."""
    c = _count(group) // n
    out = {}
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        out[f.name] = _shard(v, me, n) if dataclasses.is_dataclass(v) else v[me * c:(me + 1) * c]
    return dataclasses.replace(group, **out)


def local_scene(scene, me, n):
    """Rank ``me``'s shard of the scene padded for a ring of n: block me of
    every primitive group (and of the directional lights), the camera and
    global colours whole."""
    padded = pad_scene_for_ring(scene, n)
    names = [name for name, _ in _PRIM_FIELDS] + ["lights_direct"]
    return dataclasses.replace(padded, **{k: _shard(getattr(padded, k), me, n) for k in names})


def shard_topologies(scene, n):
    """The nearest-hit libraries a ring of n over ``scene`` launches, as
    ``build.build_all`` takes them (every shard has the same counts)."""
    from txr_torch.kernels.build import topology

    return [("nearest_hit", topology(pack_scene(local_scene(scene, 0, n), None)[1]))]


def ring_nearest_hit(scene, ro, rd, mesh, axis=None, one_side_planes=True, device=None):
    """calcInter (rt.frag:587-628) with the primitives split over the ring
    of ``mesh``'s ranks → (t [R] f32, +inf on a miss; type [R] and index
    [R] int32, −1 on a miss), on every rank, on ``device`` (CUDA unless the
    caller passes "cpu").  ro, rd [R, 3] are the same on every rank; the
    index is into the unpadded scene.  Detached.

    The ring runs over the whole world, so ``axis`` (default the mesh's
    last) must span every rank."""
    axis = axis or mesh.axis_names[-1]
    n = mesh.shape[axis]
    if mesh.size != n:
        raise ValueError("ring_nearest_hit shards over a single mesh axis spanning the world; "
                         "use a 1-axis mesh")
    dev = resolve_device(device)
    me = mesh.rank
    with torch.no_grad():
        local = local_scene(scene.to(dev), me, n)
        local_counts = local.counts
        table = pack_scene(local, None)
        # global slot bases per type: padded global counts, type major
        gbase, acc = {}, 0
        for name, code in _PRIM_FIELDS:
            gbase[code] = acc
            acc += local_counts[name] * n

        R = ro.shape[0]
        ray_pad = (-R) % n
        ro = ro.detach().to(dev, torch.float32)
        rd = rd.detach().to(dev, torch.float32)
        if ray_pad:
            ro = torch.cat([ro, ro[-1:].expand(ray_pad, 3)])
            rd = torch.cat([rd, rd[-1:].expand(ray_pad, 3)])
        c = ro.shape[0] // n
        ro, rd = ro[me * c:(me + 1) * c].contiguous(), rd[me * c:(me + 1) * c].contiguous()
        t = torch.full((c,), float("inf"), device=dev)
        ty = torch.full((c,), -1, dtype=torch.int32, device=dev)
        idx = torch.full((c,), -1, dtype=torch.int32, device=dev)
        slot = torch.full((c,), _NO_SLOT, dtype=torch.int32, device=dev)
        for _ in range(n):
            lt, lty, lidx = _sweep(local, ro, rd, one_side_planes, table)
            hit = torch.isfinite(lt)
            lty = lty.to(torch.int32)
            # globalise: this shard holds the index block [me·c_loc, (me+1)·c_loc)
            gidx = torch.full_like(lty, -1)
            gslot = torch.full_like(lty, _NO_SLOT)
            for name, code in _PRIM_FIELDS:
                sel = hit & (lty == code)
                g = lidx.to(torch.int32) + me * local_counts[name]
                gidx = torch.where(sel, g, gidx)
                gslot = torch.where(sel, gbase[code] + g, gslot)
            # an exact t tie goes to the lower global slot, whatever the visit order
            upd = (lt < t) | ((lt == t) & (gslot < slot))
            t = torch.where(upd, lt, t)
            ty = torch.where(upd, lty, ty)
            idx = torch.where(upd, gidx, idx)
            slot = torch.where(upd, gslot, slot)
            # one hop: the tile and its carry travel to rank me+1, in one message
            packed = torch.cat([ro.view(torch.int32), rd.view(torch.int32),
                                t.view(torch.int32)[:, None], ty[:, None], idx[:, None],
                                slot[:, None]], 1)
            packed = ring_shift(packed)
            ro = packed[:, 0:3].contiguous().view(torch.float32)
            rd = packed[:, 3:6].contiguous().view(torch.float32)
            t = packed[:, 6].contiguous().view(torch.float32)
            ty, idx, slot = (packed[:, k].contiguous() for k in (7, 8, 9))
        out = all_gather_rows(torch.stack([t.view(torch.int32), ty, idx], 1))[:R]
        t = out[:, 0].contiguous().view(torch.float32)
        ty, idx = out[:, 1].contiguous(), out[:, 2].contiguous()
        # phantom hits on padded slots read as misses
        phantom = t >= _T_CAP
        return (torch.where(phantom, float("inf"), t), torch.where(phantom, -1, ty),
                torch.where(phantom, -1, idx))
