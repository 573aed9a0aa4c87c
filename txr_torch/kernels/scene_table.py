"""The packed scene table that every CUDA kernel reads, and the plain sweeps
over it that the kernels' twins share.

``pack_scene`` flattens a Scene (and the SceneAtlas's texture slots and
sizes) into one f32 buffer of per-type records, material rows, texture
slots and texture sizes, plus an int header of counts, flags and section
offsets.  The kernels copy the buffer into shared memory once per block;
``csrc/txr_common.cuh`` reads the same layout.  ``sweep_ref`` and
``occlusion_ref`` are the nearest-hit and any-hit sweeps of the Pallas
kernels (txr/kernels/pallas_intersect.py:281-345, :423-485) in plain
PyTorch, one primitive at a time in reference order.
"""

from __future__ import annotations

import math

import torch

from txr_torch.kernels.primitives import (
    INF_T,
    _box_test,
    _plane_test,
    _ring_test,
    _sphere_test,
    _surface_test,
    _torus_test,
)

MAX_DIST = 1.0e6        # maxDist, rt.frag:145

# packed record widths (floats); csrc/txr_common.cuh reads the same layout
REC = dict(
    planes=6,        # pos3 normal3
    spheres=9,       # pos3 radius hollow quat4
    surfaces=19,     # pos3 quat4 coef6 v_min3 v_max3 (clip box clamped to ±INF_T)
    boxes=10,        # pos3 quat4 form3
    toruses=9,       # pos3 quat4 form2
    rings=9,         # pos3 quat4 r1 r2
    lights_point=7,  # pos3 radius intensity linear_k quadratic_k
    lights_direct=4,  # direction3 intensity
)
SLOT_ORDER = ("planes", "spheres", "surfaces", "boxes", "toruses", "rings",
              "lights_point")
_TYPES = SLOT_ORDER + ("lights_direct",)
# header: 8 counts (_TYPES order), n_atlas, flags, 11 section offsets
# (_TYPES order, then mat, texslot, texdim), n_buf
HDR_LEN = 22
FLAG_ONE_SIDE, FLAG_SHADOW, FLAG_FRESNEL, FLAG_TIR, FLAG_SHADE_FLIPPED = 1, 2, 4, 8, 16


def _flat(*cols):
    return torch.cat([c.reshape(c.shape[0], math.prod(c.shape[1:])).to(torch.float32)
                      for c in cols], 1)


def set_flags(hdr, *, one_side=True, shadow_enabled=True, do_fresnel=True, tir=True,
              shade_flipped=True):
    """The header ``hdr`` with its flag word replaced."""
    flags = ((FLAG_ONE_SIDE if one_side else 0) | (FLAG_SHADOW if shadow_enabled else 0)
             | (FLAG_FRESNEL if do_fresnel else 0) | (FLAG_TIR if tir else 0)
             | (FLAG_SHADE_FLIPPED if shade_flipped else 0))
    return hdr[:9] + (flags,) + hdr[10:]


@torch.no_grad()
def pack_scene(scene, atlas, **flags):
    """Scene + SceneAtlas + flags (``set_flags``) → (buf [n_buf] f32 on the
    scene's device, header ints).  Detached, and built from device tensors
    with no host sync and no host-to-device copy, so a CUDA graph can
    capture it; a caller packs once and reuses the table."""
    c = scene.counts
    dev = scene.device
    sp, su, bx, to, ri = (scene.spheres, scene.surfaces, scene.boxes,
                          scene.toruses, scene.rings)
    lp, ld = scene.lights_point, scene.lights_direct
    recs = dict(
        planes=_flat(scene.planes.pos, scene.planes.normal),
        spheres=_flat(sp.pos, sp.radius, sp.hollow, sp.quat),
        surfaces=_flat(su.pos, su.quat, su.coef, torch.clamp(su.v_min, min=-INF_T),
                       torch.clamp(su.v_max, max=INF_T)),
        boxes=_flat(bx.pos, bx.quat, bx.form),
        toruses=_flat(to.pos, to.quat, to.form),
        rings=_flat(ri.pos, ri.quat, ri.r1, ri.r2),
        lights_point=_flat(lp.pos, lp.radius, lp.intensity, lp.linear_k, lp.quadratic_k),
        lights_direct=_flat(ld.direction, ld.intensity),
    )
    # material table in slot order; light-bulb slots carry zeros
    mats = []
    for name in SLOT_ORDER[:-1]:
        m = getattr(scene, name).mat
        mats.append(_flat(m.color, m.absorb, m.diffuse, m.reflect, m.refract,
                          m.specular, m.kd, m.ks))
    mats.append(torch.zeros((c["lights_point"], 12), device=dev))
    # atlas slot of each scene slot's texture, -1 when untextured
    none = lambda n: torch.full((n,), -1, dtype=torch.int64, device=dev)
    slots = [none(c["planes"])]

    def tex_slot(tex, slot_of):
        t = tex.to(torch.int64)
        return torch.where(t > 0, slot_of(t), -1)

    if atlas is not None and atlas.n_sphere:
        slots.append(tex_slot(sp.texture, lambda t: torch.clamp(t - 1, 0, atlas.n_sphere - 1)))
    else:
        slots.append(none(c["spheres"]))
    slots.append(none(c["surfaces"]))
    if atlas is not None and atlas.box_slot is not None:
        slots.append(tex_slot(bx.texture, lambda t: atlas.box_slot))
    else:
        slots.append(none(c["boxes"]))
    slots.append(none(c["toruses"]))
    if atlas is not None and atlas.ring_slot is not None:
        slots.append(tex_slot(ri.texture, lambda t: atlas.ring_slot))
    else:
        slots.append(none(c["rings"]))
    slots.append(none(c["lights_point"]))
    # texture sizes from the atlas's device tables: no host-to-device copy
    if atlas is not None:
        dims = atlas.dims
        texdim = torch.stack([atlas.h0, atlas.w0], -1).to(dev, torch.float32)
    else:
        dims = ((0, 0),)
        texdim = torch.zeros((1, 2), device=dev)

    parts = [recs[k].reshape(-1) for k in _TYPES]
    parts += [torch.cat(mats).reshape(-1), torch.cat(slots).to(torch.float32),
              texdim.reshape(-1)]
    offsets, off = [], 0
    for p in parts:
        offsets.append(off)
        off += p.numel()
    hdr = tuple([c[k] for k in _TYPES] + [len(dims), 0] + offsets + [off])
    assert len(hdr) == HDR_LEN
    return torch.cat(parts), set_flags(hdr, **flags)


def counts_of(hdr):
    return dict(zip(_TYPES, hdr[:8]))


def sections(buf, hdr):
    """numpy views of the packed tables, keyed like the Pallas operands."""
    b = buf.detach().cpu().numpy()
    cnt = counts_of(hdr)
    offs = hdr[10:21]
    sec = {}
    for j, k in enumerate(_TYPES):
        sec[k] = b[offs[j]: offs[j] + cnt[k] * REC[k]].reshape(cnt[k], REC[k])
    n_slots = sum(cnt[k] for k in SLOT_ORDER)
    sec["mat"] = b[offs[8]: offs[8] + 12 * n_slots].reshape(n_slots, 12)
    sec["texslot"] = b[offs[9]: offs[9] + n_slots]
    sec["texdim"] = b[offs[10]: offs[10] + 2 * hdr[8]].reshape(hdr[8], 2)
    return cnt, sec


def check_rays(name, device, *rays):
    """Raise unless every ray tensor is a contiguous [N, 3] (or [N] for a
    distance) float32 tensor of one length on ``device``."""
    n = rays[0].shape[0] if rays[0].ndim else -1
    for a in rays:
        if a.device != device:
            raise ValueError(f"{name}: a ray tensor is on {a.device}, expected {device}")
        if (a.dtype != torch.float32 or a.ndim not in (1, 2) or a.shape[0] != n
                or (a.ndim == 2 and a.shape[1] != 3)):
            raise ValueError(f"{name}: rays must be [N, 3] (distances [N]) float32 of one "
                             f"length, got {tuple(a.shape)} {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: ray tensors must be contiguous")


def check_mask(name, device, mask, n):
    """A lane mask as the kernels read it: None, or a contiguous bool or
    uint8 [n] tensor on ``device`` → None or its uint8 view."""
    if mask is None:
        return None
    if (mask.device != device or mask.dtype not in (torch.bool, torch.uint8)
            or tuple(mask.shape) != (n,) or not mask.is_contiguous()):
        raise ValueError(f"{name}: a lane mask must be a contiguous bool or uint8 [{n}] tensor "
                         f"on {device}, got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    return mask.view(torch.uint8)


def check_table(name, buf, hdr, device):
    if (buf.device != device or buf.dtype != torch.float32 or not buf.is_contiguous()
            or len(hdr) != HDR_LEN or buf.numel() != hdr[-1]):
        raise ValueError(f"{name}: buf must be pack_scene's f32 table on the rays' device")


def slot_tests(cnt, sec, o3, d3, one_side):
    """(t, hit) of every slot in reference order (planes, spheres, surfaces,
    boxes, toruses, rings, point-light bulbs): o3, d3 are (x, y, z) tuples
    of [N] tensors."""
    PL, SP, SU, BX, TO, RI, LP = (sec[k] for k in SLOT_ORDER)
    for i in range(cnt["planes"]):
        yield _plane_test(PL[:, 0:3], PL[:, 3:6], i, o3, d3, one_side)
    for i in range(cnt["spheres"]):
        yield _sphere_test(SP[i, 0], SP[i, 1], SP[i, 2], SP[i, 3], SP[i, 4] != 0, o3, d3)
    for i in range(cnt["surfaces"]):
        yield _surface_test(SU[:, 0:3], SU[:, 3:7], SU[:, 7:13], SU[:, 13:16], SU[:, 16:19],
                            i, o3, d3)
    for i in range(cnt["boxes"]):
        yield _box_test(BX[:, 0:3], BX[:, 3:7], BX[:, 7:10], i, o3, d3)
    for i in range(cnt["toruses"]):
        yield _torus_test(TO[:, 0:3], TO[:, 3:7], TO[:, 7:9], i, o3, d3)
    for i in range(cnt["rings"]):
        yield _ring_test(RI[:, 0:3], RI[:, 3:7], RI[:, 7], RI[:, 8], i, o3, d3)[:2]
    for i in range(cnt["lights_point"]):
        # light bulbs are plain (non-hollow) spheres, rt.frag:621-625
        yield _sphere_test(LP[i, 0], LP[i, 1], LP[i, 2], LP[i, 3], None, o3, d3)


def sweep_ref(cnt, sec, o3, d3, one_side):
    """Nearest hit over every slot in reference order with strict ``<`` →
    (tmin [N] with INF_T on a miss, slot [N] int64, 0 on a miss)."""
    tmin = torch.full_like(o3[0], INF_T)
    slot = torch.zeros(o3[0].shape, dtype=torch.int64, device=o3[0].device)
    for s, (t, hit) in enumerate(slot_tests(cnt, sec, o3, d3, one_side)):
        upd = hit & (t < tmin)
        tmin = torch.where(upd, t, tmin)
        slot = torch.where(upd, s, slot)
    return tmin, slot


def occluder_tests(cnt, sec, o3, d3, one_side):
    """(t, hit) of every solid occluder of a shadow ray, in the kernel's
    order (cheapest first): spheres (tested solid), planes only when
    two-sided, boxes, surfaces, toruses."""
    PL, SP, SU, BX, TO = (sec[k] for k in SLOT_ORDER[:5])
    for i in range(cnt["spheres"]):
        yield _sphere_test(SP[i, 0], SP[i, 1], SP[i, 2], SP[i, 3], None, o3, d3)
    if not one_side:
        for i in range(cnt["planes"]):
            yield _plane_test(PL[:, 0:3], PL[:, 3:6], i, o3, d3, one_side)
    for i in range(cnt["boxes"]):
        yield _box_test(BX[:, 0:3], BX[:, 3:7], BX[:, 7:10], i, o3, d3)
    for i in range(cnt["surfaces"]):
        yield _surface_test(SU[:, 0:3], SU[:, 3:7], SU[:, 7:13], SU[:, 13:16], SU[:, 16:19],
                            i, o3, d3)
    for i in range(cnt["toruses"]):
        yield _torus_test(TO[:, 0:3], TO[:, 3:7], TO[:, 7:9], i, o3, d3)


def occlusion_ref(cnt, sec, o3, d3, dist, one_side):
    """Any hit closer than ``dist`` [N] over ``occluder_tests`` → (solid [N]
    f32 0/1, [hit, u, v] [N] f32 for each ring, zeros where the ring is not
    hit).  The kernel stops a ray at its first occluder; the bit is an OR,
    so this twin ORs them all."""
    RI = sec["rings"]
    solid = torch.zeros(o3[0].shape, dtype=torch.bool, device=o3[0].device)
    occl = lambda t, h: h & (t < dist)
    for t, h in occluder_tests(cnt, sec, o3, d3, one_side):
        solid |= occl(t, h)
    rings = []
    for i in range(cnt["rings"]):
        t, h, x, _, pp = _ring_test(RI[:, 0:3], RI[:, 3:7], RI[:, 7], RI[:, 8], i, o3, d3)
        h = occl(t, h)
        r1, r2 = RI[i, 7], RI[i, 8]
        nrm = torch.sqrt(torch.clamp(pp, min=1e-20))
        rings += [torch.where(h, 1.0, 0.0), torch.where(h, (pp - r1) / (r2 - r1), 0.0),
                  torch.where(h, x / nrm, 0.0)]
    return torch.where(solid, 1.0, 0.0), rings
