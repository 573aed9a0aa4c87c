"""The fused bounce-step probe: its CUDA kernel, its plain twin, its tables.

Replaces ``txr/kernels/pallas_step.py:step_probe_pallas``.  For each ray, in
one pass: the nearest-hit sweep over every slot in reference order
(planes, spheres, surfaces, boxes, toruses, rings, point-light bulbs; strict
``<``), the winner's normal flipped to face the ray, the ``outside`` flag,
Fresnel ``rm`` with TIR, the texture request (kind, atlas slot, uv or the
rotated sphere normal, footprint LOD, box face weight), the 12-float
material row, and for each light (point lights, then direct) the diffuse
weight, the specular term, the solid any-hit bit and each ring's (hit, u, v).

Output: ``f`` [NF, N] f32 with NF = 23 + L·(3 + 3·nr) rows in the order of
``pallas_step.py:558-571``, and ``i`` [3, N] int32 (slot, kind, req_k).
With ``fill`` (the default), lanes that are not ``alive``, lanes that miss,
and the light rows of a light-bulb hit hold fills (t = INF_T, every other
row 0), which the kernel writes without sweeping or shading them: the
rows a VJP saves (``render/trace.step_saving``) and the twin compares.
Without, the kernel stores only what the consume kernels read: nothing on
a lane that is not ``alive``, t alone on a miss, the base rows and the
ints on a light-bulb hit; the rest of those lanes is left unwritten.  A
forward step's probe and every glossy probe (``render/fused.py``) run so.

``step_probe`` launches the kernel on CUDA tensors (``launch``) and runs
the twin ``step_probe_ref`` on CPU tensors.  Both read the packed scene
table of ``scene_table.pack_scene``, as the nearest-hit and shadow kernels
do.
"""

from __future__ import annotations

import collections.abc
import ctypes

import numpy as np
import torch

from txr_torch import resolve_device
from txr_torch.kernels import build
from txr_torch.kernels.primitives import INF_T, _conj, _rot, _safe_recip
from txr_torch.kernels.scene_table import (  # noqa: F401  (pack_scene is public here)
    FLAG_FRESNEL,
    FLAG_SHADE_FLIPPED,
    FLAG_SHADOW,
    FLAG_TIR,
    FLAG_ONE_SIDE,
    MAX_DIST,
    SLOT_ORDER,
    _TYPES,
    check_mask,
    check_rays,
    check_table,
    counts_of,
    occlusion_ref,
    pack_scene,
    sections,
    set_flags,
    sweep_ref,
)

_PI = 3.14159265358979
LOD_COS_MIN = 0.125     # texture.py footprint_world

# texture-request kinds emitted per lane
KIND_NONE = 0
KIND_RGBA = 1           # textured sphere / ring: color.rgb + alpha
KIND_BOX = 2            # textured box: color.rgb * face weight


def n_rows(counts):
    L = counts["lights_point"] + counts["lights_direct"]
    return 23 + L * (3 + 3 * counts["rings"])


def _norm3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z + 1e-30)
    return x * inv, y * inv, z * inv


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def step_probe_ref(buf, hdr, ro, rd, pix_angle=0.0, alive=None):
    """Plain PyTorch twin of the kernel over [N] tensors, Python loops over
    the primitive counts, on the tables of ``pack_scene``; see ``step_probe``.
    Every lane is computed; the kernel's fills are then applied with
    ``torch.where``, whatever the header's ``FLAG_FILL``: CPU readers read
    every lane."""
    cnt, sec = sections(buf, hdr)
    flags = hdr[9]
    one_side = bool(flags & FLAG_ONE_SIDE)
    dev = ro.device
    f32 = torch.float32
    PL, SP, SU, BX, TO, RI, LP, LD = (sec[k] for k in _TYPES)
    n_slots = sum(cnt[k] for k in SLOT_ORDER)
    bases, s = {}, 0
    for k in SLOT_ORDER:
        bases[k] = s
        s += cnt[k]

    rox, roy, roz = ro.unbind(-1)
    rdx, rdy, rdz = rd.unbind(-1)
    o3, d3 = (rox, roy, roz), (rdx, rdy, rdz)

    # ---- nearest-hit sweep (calcInter) -------------------------------------
    tmin, slot = sweep_ref(cnt, sec, o3, d3, one_side)

    hit = tmin < INF_T
    t_safe = torch.where(hit, tmin, 0.0)
    px, py, pz = rox + rdx * t_safe, roy + rdy * t_safe, roz + rdz * t_safe

    # ---- winner info (get_hit_info) ----------------------------------------
    zero = torch.zeros_like(rox)
    nx = ny = nz = zero
    req_a = req_b = req_c = zero
    tex_w = zero + 1.0
    lodv = zero
    kind = torch.zeros_like(slot)
    req_k = torch.zeros_like(slot)

    def is_type(k):
        return (slot >= bases[k]) & (slot < bases[k] + cnt[k])

    def sel(k, col):
        """The winner's record column (meaningful on the type's lanes)."""
        tab = torch.from_numpy(np.ascontiguousarray(sec[k][:, col])).to(dev)
        return tab[torch.clamp(slot - bases[k], 0, cnt[k] - 1)]

    def selq(k, col):
        return tuple(sel(k, col + j) for j in range(4))

    for i in range(cnt["planes"]):
        m = slot == bases["planes"] + i
        vx, vy, vz = PL[i, 3], PL[i, 4], PL[i, 5]
        inv = np.float32(1.0) / np.sqrt(vx * vx + vy * vy + vz * vz + np.float32(1e-30))
        nx = torch.where(m, vx * inv, nx)
        ny = torch.where(m, vy * inv, ny)
        nz = torch.where(m, vz * inv, nz)
    if cnt["spheres"]:
        is_sph = is_type("spheres")
        w = _norm3(px - sel("spheres", 0), py - sel("spheres", 1), pz - sel("spheres", 2))
        nx, ny, nz = (torch.where(is_sph, a, b) for a, b in zip(w, (nx, ny, nz)))
    if cnt["surfaces"]:
        is_su = is_type("surfaces")
        q = selq("surfaces", 3)
        ca, cb, cc, cd, ce = (sel("surfaces", 7 + j) for j in range(5))
        lx, ly, lz = _rot(q, (px - sel("surfaces", 0), py - sel("surfaces", 1),
                              pz - sel("surfaces", 2)))
        g = (2.0 * ca * lx, 2.0 * cb * ly + ce, 2.0 * cc * lz + cd)
        w = _norm3(*_rot(_conj(q), g))
        nx, ny, nz = (torch.where(is_su, a, b) for a, b in zip(w, (nx, ny, nz)))
    if cnt["boxes"]:
        is_bx = is_type("boxes")
        q = selq("boxes", 3)
        ox, oy, oz = _rot(q, (rox - sel("boxes", 0), roy - sel("boxes", 1),
                              roz - sel("boxes", 2)))
        dx, dy, dz = _rot(q, d3)
        mx, my, mz = _safe_recip(dx), _safe_recip(dy), _safe_recip(dz)
        t1x = -mx * ox - mx.abs() * sel("boxes", 7)
        t1y = -my * oy - my.abs() * sel("boxes", 8)
        t1z = -mz * oz - mz.abs() * sel("boxes", 9)
        sgn = lambda v: torch.where(v >= 0.0, 1.0, -1.0)
        one = lambda c: torch.where(c, 1.0, 0.0)
        g = (-sgn(dx) * one((t1x >= t1y) & (t1x >= t1z)),
             -sgn(dy) * one((t1y >= t1z) & (t1y >= t1x)),
             -sgn(dz) * one((t1z >= t1x) & (t1z >= t1y)))
        w = _rot(_conj(q), g)
        nx, ny, nz = (torch.where(is_bx, a, b) for a, b in zip(w, (nx, ny, nz)))
    if cnt["toruses"]:
        is_to = is_type("toruses")
        q = selq("toruses", 3)
        Rm, rm_ = sel("toruses", 7), sel("toruses", 8)
        lx, ly, lz = _rot(q, (px - sel("toruses", 0), py - sel("toruses", 1),
                              pz - sel("toruses", 2)))
        k = lx * lx + ly * ly + lz * lz - rm_ * rm_
        R2 = Rm * Rm
        w = _norm3(*_rot(_conj(q), (lx * (k - R2), ly * (k - R2), lz * (k + R2))))
        nx, ny, nz = (torch.where(is_to, a, b) for a, b in zip(w, (nx, ny, nz)))
    if cnt["rings"]:
        is_ri = is_type("rings")
        w = _rot(_conj(selq("rings", 3)), (zero, zero, zero - 1.0))
        nx, ny, nz = (torch.where(is_ri, a, b) for a, b in zip(w, (nx, ny, nz)))

    # ---- texture requests (uv / rotated normal, kind, atlas slot) ----------
    def slot_gather(tab_np, fill):
        if not n_slots:
            return torch.full_like(slot, fill) if isinstance(fill, int) else zero + fill
        tab = torch.from_numpy(np.ascontiguousarray(tab_np)).to(dev)
        return tab[torch.clamp(slot, 0, n_slots - 1)]

    atk = torch.where(slot < n_slots, slot_gather(sec["texslot"], -1).to(torch.int64), -1)
    textured = hit & (atk >= 0)
    if pix_angle:
        cos_in = (rdx * nx + rdy * ny + rdz * nz).abs()
        fw = t_safe * pix_angle / torch.clamp(cos_in, min=LOD_COS_MIN)
        kidx = torch.where(textured, atk, 0)
        dims = torch.from_numpy(np.ascontiguousarray(sec["texdim"])).to(dev)
        inr = kidx < dims.shape[0]
        kc = torch.clamp(kidx, 0, dims.shape[0] - 1)
        tH = torch.where(inr, dims[kc, 0], 0.0)
        tW = torch.where(inr, dims[kc, 1], 0.0)
        lod_of = lambda texels: torch.log2(torch.clamp(texels, min=1.0))

    if cnt["spheres"]:
        sph_tex = textured & is_type("spheres")
        rn = _rot(selq("spheres", 5), (nx, ny, nz))
        req_a = torch.where(sph_tex, rn[0], req_a)
        req_b = torch.where(sph_tex, rn[1], req_b)
        req_c = torch.where(sph_tex, rn[2], req_c)
        kind = torch.where(sph_tex, KIND_RGBA, kind)
        req_k = torch.where(sph_tex, atk, req_k)
        if pix_angle:
            tpw = torch.maximum(tW / (2.0 * _PI), tH / _PI) / torch.clamp(
                sel("spheres", 3), min=1e-6)
            lodv = torch.where(sph_tex, lod_of(fw * tpw), lodv)
    if cnt["boxes"]:
        box_tex = textured & is_type("boxes")
        q = selq("boxes", 3)
        # the reference rotates box.pos by the quat, not pos-relative
        cpx, cpy, cpz = _rot(q, (sel("boxes", 0), sel("boxes", 1), sel("boxes", 2)))
        lpx, lpy, lpz = _rot(q, (px, py, pz))
        lnx, lny, lnz = _rot(q, (nx, ny, nz))
        rx, ry, rz = lpx - cpx, lpy - cpy, lpz - cpz
        ax, ay, az = lnx.abs(), lny.abs(), lnz.abs()
        dom_x = (ax >= ay) & (ax >= az)
        dom_y = ~dom_x & (ay >= az)
        u = torch.where(dom_x, rz, torch.where(dom_y, rz, rx))
        v = torch.where(dom_x, ry, torch.where(dom_y, rx, ry))
        w = torch.where(dom_x, ax, torch.where(dom_y, ay, az))
        req_a = torch.where(box_tex, 0.5 * u - 0.5, req_a)
        req_b = torch.where(box_tex, 0.5 * v - 0.5, req_b)
        tex_w = torch.where(box_tex, w, tex_w)
        kind = torch.where(box_tex, KIND_BOX, kind)
        req_k = torch.where(box_tex, atk, req_k)
        if pix_angle:
            lodv = torch.where(box_tex, lod_of(fw * 0.5 * torch.maximum(tH, tW)), lodv)
    if cnt["rings"]:
        ring_tex = textured & is_type("rings")
        rr1, rr2 = sel("rings", 7), sel("rings", 8)
        q = selq("rings", 3)
        ox, oy, _ = _rot(q, (rox - sel("rings", 0), roy - sel("rings", 1),
                             roz - sel("rings", 2)))
        dx, dy, _ = _rot(q, d3)
        hx = ox + dx * t_safe
        hy = oy + dy * t_safe
        pp = hx * hx + hy * hy
        nrm = torch.sqrt(torch.clamp(pp, min=1e-20))
        req_a = torch.where(ring_tex, (pp - rr1) / (rr2 - rr1), req_a)
        req_b = torch.where(ring_tex, hx / nrm, req_b)
        kind = torch.where(ring_tex, KIND_RGBA, kind)
        req_k = torch.where(ring_tex, atk, req_k)
        if pix_angle:
            rmid = torch.sqrt(torch.clamp(0.5 * (rr1 + rr2), min=1e-12))
            tpw = torch.maximum(tW * 2.0 * rmid / torch.clamp(rr2 - rr1, min=1e-12),
                                tH / (_PI * rmid))
            lodv = torch.where(ring_tex, lod_of(fw * tpw), lodv)
    # the in-kernel environment branch (cube_base >= 0) is never taken on the
    # main path: the environment is fetched once after the bounce loop

    # ---- materials ---------------------------------------------------------
    mat = [torch.where(slot < n_slots, slot_gather(sec["mat"][:, j], 0.0), 0.0)
           for j in range(12)]
    (m_cr, m_cg, m_cb, m_ar, m_ag, m_ab,
     m_dif, m_refl, m_refr, m_spec, m_kd, m_ks) = mat

    # ---- facing flip + Fresnel (rt.frag:837-849) ---------------------------
    outside = (rdx * nx + rdy * ny + rdz * nz) < 0.0
    flip = torch.where(outside, 1.0, -1.0)
    nx, ny, nz = nx * flip, ny * flip, nz * flip
    ndotv = torch.clamp(-(rdx * nx + rdy * ny + rdz * nz), 0.0, 1.0)
    schlick = m_refl + (1.0 - m_refl) * _pow5(1.0 - ndotv)
    if flags & FLAG_TIR:
        if flags & FLAG_FRESNEL:
            n1 = torch.where(outside, 1.0, m_refr)
            n2 = torch.where(outside, m_refr, 1.0)
            n2s = torch.where(n2.abs() > 1e-6, n2, 1.0)
            w = (n1 - n2) / (n1 + n2s)
            r0 = w * w
            cosx = -(rdx * nx + rdy * ny + rdz * nz)
            entering = n1 > n2
            ratio = n1 / n2s
            sin_t2 = ratio * ratio * (1.0 - cosx * cosx)
            tirm = entering & (sin_t2 > 1.0)
            no_tir = sin_t2 < 1.0
            cost = torch.sqrt(torch.where(no_tir, 1.0 - sin_t2, 1.0))
            cosx = torch.where(entering, torch.where(no_tir, cost, 0.0), cosx)
            xf = 1.0 - cosx
            x2 = xf * xf
            ret = r0 + (1.0 - r0) * x2 * x2 * xf
            ret = m_refl + (1.0 - m_refl) * ret
            rm_refr = torch.where(tirm, 1.0, ret)
        else:
            rm_refr = m_refl
        rm = torch.where(m_refr > 0.0, rm_refr, schlick)
    else:
        rm = schlick

    # ---- shading probes per light (calcShade2 + inShadow) ------------------
    bias = (9e-3 * t_safe + 35.0) / 35e3
    so = (px + nx * bias, py + ny * bias, pz + nz * bias)
    if flags & FLAG_SHADE_FLIPPED:
        sn = (nx, ny, nz)
    else:   # the glossy probe shades with the unflipped normal
        sn = (nx * flip, ny * flip, nz * flip)

    light_rows = []

    def shade_probe(ldx, ldy, ldz, dist, wgt):
        snx, sny, snz = sn
        dp = torch.clamp(snx * ldx + sny * ldy + snz * ldz, 0.0, 1.0)
        lddn = ldx * snx + ldy * sny + ldz * snz
        rfx = ldx - 2.0 * lddn * snx
        rfy = ldy - 2.0 * lddn * sny
        rfz = ldz - 2.0 * lddn * snz
        sdp = torch.clamp(rdx * rfx + rdy * rfy + rdz * rfz, 0.0, 1.0)
        spec = torch.where(m_spec > 0.0, torch.pow(torch.clamp(sdp, min=1e-12), m_spec), 0.0)
        if flags & FLAG_SHADOW:
            solid, rings = occlusion_ref(cnt, sec, so, (ldx, ldy, ldz), dist, one_side)
        else:
            solid, rings = zero, [zero] * (3 * cnt["rings"])
        light_rows.extend([dp * wgt, spec, solid] + rings)

    for i in range(cnt["lights_point"]):
        lx, ly, lz = LP[i, 0] - so[0], LP[i, 1] - so[1], LP[i, 2] - so[2]
        dist = torch.sqrt(lx * lx + ly * ly + lz * lz + 1e-30)
        inv = 1.0 / dist
        dist_div = 1.0 + LP[i, 5] * dist + LP[i, 6] * dist * dist
        shade_probe(lx * inv, ly * inv, lz * inv, dist, LP[i, 4] / dist_div)
    for i in range(cnt["lights_direct"]):
        dxl, dyl, dzl = LD[i, 0], LD[i, 1], LD[i, 2]
        inv = np.float32(1.0) / np.sqrt(dxl * dxl + dyl * dyl + dzl * dzl + np.float32(1e-30))
        shade_probe(zero + (-dxl * inv), zero + (-dyl * inv), zero + (-dzl * inv),
                    torch.full_like(rox, MAX_DIST), LD[i, 3])

    # ---- the kernel's fills: off and miss lanes, and a light bulb's shading
    live = hit if alive is None else hit & alive.to(torch.bool)
    shaded = live & (slot < bases["lights_point"])
    base_rows = [torch.where(live, tmin, INF_T)] + [
        torch.where(live, r, 0.0) for r in [nx, ny, nz, torch.where(outside, 1.0, 0.0), rm,
                                             req_a, req_b, req_c, lodv, tex_w] + mat]
    rows = base_rows + [torch.where(shaded, r, 0.0) for r in light_rows]
    f = torch.stack([r.to(f32) for r in rows])
    i = torch.where(live, torch.stack([slot, kind, req_k]), 0).to(torch.int32)
    return f, i


def step_probe(scene, atlas, ro, rd, *, one_side=True, shadow_enabled=True,
               do_fresnel=True, tir=True, pix_angle=0.0, shade_flipped=True,
               device=None, table=None, alive=None, fill=True):
    """Run the fused step probe on rays ro, rd [N, 3] f32 → (f [NF, N] f32,
    i [3, N] int32).  CUDA tensors launch the kernel; CPU tensors (with
    ``device="cpu"``) run ``step_probe_ref``.  ``scene`` lies on the rays'
    device; ``atlas`` is the TextureSet's SceneAtlas or None.  ``table``:
    the (buf, hdr) of ``pack_scene`` for this scene and atlas, packed once
    by the caller; packed here when None.  ``alive``: bool or uint8 [N], the
    lanes whose rows the caller reads (None: every lane).  ``fill`` sets
    the header's ``FLAG_FILL``: with it, the other lanes, the lanes that
    miss and the light rows of a light-bulb hit hold fills (t = INF_T,
    every other row 0), for a caller that saves or compares every lane;
    without, the kernel stores on those lanes only what the consume
    kernels read (t on a live miss, the base rows and ints of a live
    light-bulb hit) and leaves the rest unwritten.  The twin fills
    either way.  ``step_probe.unfilled`` counts the calls made without
    ``fill``, on either device, ``step_probe.tiles`` the tiles of the
    table each call's blocks stage (``launch``; 1 a call on the CPU, whose
    twin does not tile), and ``step_probe.grouped`` the calls whose shadow
    pass took a lane's lights in groups (``launch``; none on the CPU, whose
    twin sweeps the table whole for each light): ``render/graphs.py``
    tallies the three per bounce step for the tracer."""
    dev = resolve_device(device)
    check_rays("step_probe", dev, ro, rd)
    if scene.device != dev:
        raise ValueError(f"step_probe: scene is on {scene.device}, expected {dev}")
    buf, hdr = pack_scene(scene, atlas) if table is None else table
    hdr = set_flags(hdr, one_side=one_side, shadow_enabled=shadow_enabled,
                    do_fresnel=do_fresnel, tir=tir, shade_flipped=shade_flipped, fill=fill)
    step_probe.unfilled += not fill
    if dev.type == "cpu":
        check_mask("step_probe", dev, alive, ro.shape[0])
        step_probe.tiles += 1       # the twin sweeps the whole table at once
        return step_probe_ref(buf, hdr, ro, rd, pix_angle, alive)
    return launch(buf, hdr, ro, rd, pix_angle, alive)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def launch(buf, hdr, ro, rd, pix_angle=0.0, alive=None, tile=0):
    """Launch the kernel on tables packed by ``pack_scene`` and CUDA rays
    → (f [NF, N] f32, i [3, N] int32), on the current stream; ``alive`` as
    in ``step_probe``, and ``hdr``'s ``FLAG_FILL`` as its ``fill``: set,
    every element of f and i is written; clear, only the rows the consume
    kernels read (the others hold what ``torch.empty`` gave).  The kernel
    stages the table in shared memory whole when it fits the room a block
    has at the kernel's register-limited occupancy, else sweeps it in
    tiles sized from the table and the card's limits
    (``csrc/txr_common.cuh: plan_stage``), each sphere staged as one
    (centre, r²) record (``tile_layout``); ``tile`` > 0 forces tiles of
    that many floats of that layout (tests); then its shadow pass takes a
    shading lane and a group of its lights a thread.  Counts its launches
    in ``step_probe.launches``, the tiles each block stages a sweep (1: the
    whole table) in ``step_probe.tiles``, and the launches whose shadow pass
    took lights in groups (tiles, shadows on, some light) in
    ``step_probe.grouped``."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"step_probe: no kernel for device {dev}")
    check_rays("step_probe", dev, ro, rd)
    check_table("step_probe", buf, hdr, dev)
    N = ro.shape[0]
    mask = check_mask("step_probe", dev, alive, N)
    f = torch.empty((n_rows(counts_of(hdr)), N), dtype=torch.float32, device=dev)
    i = torch.empty((3, N), dtype=torch.int32, device=dev)
    if N == 0:
        return f, i
    tiles, grouped = ctypes.c_int(0), ctypes.c_int(0)
    build.run("step_probe", "txr_step_probe", _ARGS, dev, hdr, buf.data_ptr(),
              float(pix_angle), ro.data_ptr(), rd.data_ptr(),
              None if mask is None else mask.data_ptr(), f.data_ptr(), i.data_ptr(), N,
              int(tile), ctypes.addressof(tiles), ctypes.addressof(grouped))
    step_probe.launches += 1
    step_probe.tiles += tiles.value
    step_probe.grouped += grouped.value
    return f, i


step_probe.launches = 0
step_probe.unfilled = 0
step_probe.tiles = 0
step_probe.grouped = 0


class Rows(collections.abc.Mapping):
    """One probe launch's output: the rows ``f``, ``i`` themselves, and
    ``unpack``'s dict of them, made at the first key read.  The consume
    kernel (``step_consume.py``) reads ``f`` and ``i``, so a step on the
    card makes none of the dict's tensors unless a caller asks for them."""

    def __init__(self, f, i, counts):
        self.f, self.i, self.counts = f, i, counts
        self._fields = None

    def _dict(self):
        if self._fields is None:
            self._fields = unpack(self.f, self.i, self.counts)
        return self._fields

    def __getitem__(self, key):
        return self._dict()[key]

    def __iter__(self):
        return iter(self._dict())

    def __len__(self):
        return len(self._dict())


def unpack(f, i, counts):
    """Kernel output → dict of [N] fields, as pallas_step.py's row reader:
    t (+inf on a miss), n [N,3] (flipped), outside, rm, req [N,3], lod,
    tex_w, color/absorb [N,3], diffuse, reflect, refract, specular, kd, ks,
    light_s/light_spec/light_solid [N, L], ring_hit [N, L, nr] bool and
    ring_uv [N, L, nr, 2] (None without rings), slot, kind, req_k."""
    L = counts["lights_point"] + counts["lights_direct"]
    nr = counts["rings"]
    N = f.shape[1]
    t = f[0]
    out = dict(
        t=torch.where(t >= 1.0e30, torch.inf, t),
        n=f[1:4].T, outside=f[4] > 0.5, rm=f[5], req=f[6:9].T, lod=f[9], tex_w=f[10],
        color=f[11:14].T, absorb=f[14:17].T, diffuse=f[17], reflect=f[18],
        refract=f[19], specular=f[20], kd=f[21], ks=f[22],
        slot=i[0].to(torch.int64), kind=i[1], req_k=i[2].to(torch.int64),
    )
    lr = f[23:].reshape(L, 3 + 3 * nr, N)
    out["light_s"] = lr[:, 0].T
    out["light_spec"] = lr[:, 1].T
    out["light_solid"] = lr[:, 2].T
    if L and nr:
        rings = lr[:, 3:].reshape(L, nr, 3, N).permute(3, 0, 1, 2)   # [N, L, nr, 3]
        out["ring_hit"] = rings[..., 0] > 0.5
        out["ring_uv"] = rings[..., 1:]
    else:
        out["ring_hit"] = out["ring_uv"] = None
    return out
