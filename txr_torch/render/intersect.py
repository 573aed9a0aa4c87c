"""Nearest-hit and any-hit queries over the whole scene
(txr/render/intersect.py:40-466).

The winner search is a detached sweep — the CUDA ``nearest_hit`` kernel on
CUDA tensors, its twin on CPU tensors — over the packed scene table, in the
reference's slot order (planes → spheres → surfaces → boxes → toruses →
rings → point-light bulbs) with strict ``<``, so an exact tie goes to the
earlier slot.  ``nearest_hit`` is a ``torch.autograd.Function``: its
backward re-runs only the winning primitive's differentiable intersector
per ray (``t_of_winner``), O(R).  The winner choice is piecewise constant
in the scene, so detaching it is exact away from silhouettes.

``shadow_factor`` runs the shadow any-hit kernel (or its twin) detached —
occlusion is piecewise constant — and keeps the texture-content gradient
of a textured ring's alpha at the kernel's hit uv.

``over_lanes`` runs the step body's sub-passes on a few lanes (texel
fetches, ring alpha, the glossy pass) in one of two forms (``lane_lists``):
on lane lists (``torch.nonzero``, a host read; what ``render`` and
``trace`` use on the card, so their backward reads only those lanes), or
on every lane with a mask, which has fixed shapes and reads nothing on the
host, as a captured CUDA graph needs (``render.render_jit``, inside
``fixed_shapes()``), and which the CPU always takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import torch

from txr_torch.geometry import intersect as gi
from txr_torch.kernels.nearest_hit import nearest_hit_sweep
from txr_torch.kernels.scene_table import (
    SLOT_ORDER,
    pack_scene,
    sections,
    set_flags,
    slot_tests,
)
from txr_torch.kernels.shadow_sweep import shadow_sweep
from txr_torch.render import texture as tx
from txr_torch.scene.types import (
    TYPE_BOX,
    TYPE_PLANE,
    TYPE_POINT_LIGHT,
    TYPE_RING,
    TYPE_SPHERE,
    TYPE_SURFACE,
    TYPE_TORUS,
    float_leaves,
    unflatten_like,
)
from txr_torch.utils.index import take

MAX_DIST = gi.MAX_DIST
INF = float("inf")
# the type code of each entry of SLOT_ORDER
_SLOT_TYPES = (TYPE_PLANE, TYPE_SPHERE, TYPE_SURFACE, TYPE_BOX, TYPE_TORUS, TYPE_RING,
               TYPE_POINT_LIGHT)


@functools.lru_cache(maxsize=None)
def _slot_lookup(counts, device):
    """(type [n_slots], index-within-type [n_slots]) int64 on ``device`` for
    slot counts ``counts`` (SLOT_ORDER), built there from fills and
    aranges: no host-to-device copy, and once per topology and device."""
    types = [torch.full((n,), ty, dtype=torch.int64, device=device)
             for ty, n in zip(_SLOT_TYPES, counts)]
    idxs = [torch.arange(n, dtype=torch.int64, device=device) for n in counts]
    return torch.cat(types), torch.cat(idxs)


_FORM = threading.local()


@contextlib.contextmanager
def fixed_shapes():
    """Within the block, on this thread: no lane lists (``lane_lists``)."""
    before = getattr(_FORM, "fixed", False)
    _FORM.fixed = True
    try:
        yield
    finally:
        _FORM.fixed = before


def lane_lists(device):
    """Whether the sub-passes of a step (``over_lanes``) and the edge-AA
    pass (``render._edge_aa``) pick their lanes by ``torch.nonzero``: on
    the card outside ``fixed_shapes()``.  Never on the CPU: the lists save
    work only in the card's kernels, and ATen's vectorised CPU ``atan2``
    and ``pow`` round a value by where it sits in its array, so a lane
    moved into a list could change in its last bit against the full-width
    pass of ``render_jit``."""
    return device.type == "cuda" and not getattr(_FORM, "fixed", False)


def over_lanes(mask, fn, *rows, fill=0.0):
    """``fn(alive, *rows)`` on the lanes where ``mask`` [N] bool holds →
    [N, ...] with ``fill`` on the other lanes, or None when no lane is set
    (lane lists only).  Lane lists (``lane_lists``): ``fn`` gets the rows
    of the set lanes alone (gathered by ``take``) and ``alive=None``.
    Otherwise ``fn`` gets every row and ``alive=mask``, and ``torch.where``
    keeps the set lanes.  ``fn`` works lane by lane, so on the card the two
    forms agree on the set lanes bit for bit."""
    if not lane_lists(mask.device):
        out = fn(mask, *rows)
        return torch.where(mask.reshape(mask.shape + (1,) * (out.ndim - 1)), out, fill)
    lanes = torch.nonzero(mask).squeeze(-1)
    if not lanes.numel():
        return None
    out = fn(None, *(take(r, lanes) for r in rows))
    return torch.full(mask.shape + out.shape[1:], fill, dtype=out.dtype,
                      device=out.device).index_copy(0, lanes, out)


def _type_tables(scene):
    """The scene's slot lookup (``_slot_lookup``), shared by every call."""
    return _slot_lookup(tuple(scene.counts[k] for k in SLOT_ORDER), scene.device)


def _table(scene, table, one_side_planes):
    buf, hdr = pack_scene(scene, None) if table is None else table
    return buf, set_flags(hdr, one_side=one_side_planes)


def all_t(scene, ro, rd, one_side_planes=True, table=None):
    """Detached t of every (ray, slot) pair, [R, n_slots], +inf on a miss,
    from the plain per-primitive tests in slot order."""
    buf, hdr = _table(scene, table, one_side_planes)
    cnt, sec = sections(buf, hdr)
    cols = [torch.where(hit, t, INF) for t, hit in
            slot_tests(cnt, sec, ro.detach().unbind(-1), rd.detach().unbind(-1),
                       one_side_planes)]
    if not cols:
        return torch.full(ro.shape[:-1] + (0,), INF, dtype=ro.dtype, device=ro.device)
    return torch.stack(cols, dim=-1)


def t_of_winner(scene, ro, rd, ty, idx, one_side_planes=True, t0=None):
    """Differentiable t for an already-chosen (type, index) winner per ray:
    gathers the winning primitive's parameters and re-runs its intersector,
    O(R).  ``t0``, the sweep's detached t, lets the torus branch polish
    from the root instead of solving the quartic again."""
    c = scene.counts
    t = torch.full(ty.shape, INF, dtype=ro.dtype, device=ro.device)

    def pick(n):
        return torch.clamp(idx, 0, n - 1)

    def one(t_rp):
        return t_rp[..., 0]

    if c["planes"]:
        i = pick(c["planes"])
        pl = scene.planes
        tv = one(gi.plane_t(ro, rd, take(pl.pos, i)[..., None, :],
                            take(pl.normal, i)[..., None, :], one_side_planes))
        t = torch.where(ty == TYPE_PLANE, tv, t)
    if c["spheres"]:
        i = pick(c["spheres"])
        sp = scene.spheres
        tv = one(gi.sphere_t(ro, rd, take(sp.pos, i)[..., None, :], take(sp.radius, i)[..., None],
                             take(sp.hollow, i)[..., None]))
        t = torch.where(ty == TYPE_SPHERE, tv, t)
    if c["surfaces"]:
        i = pick(c["surfaces"])
        s = scene.surfaces
        tv = one(gi.surface_t(ro, rd, take(s.pos, i)[..., None, :], take(s.quat, i)[..., None, :],
                              take(s.coef, i)[..., None, :], take(s.v_min, i)[..., None, :],
                              take(s.v_max, i)[..., None, :]))
        t = torch.where(ty == TYPE_SURFACE, tv, t)
    if c["boxes"]:
        i = pick(c["boxes"])
        b = scene.boxes
        tv = one(gi.box_t(ro, rd, take(b.pos, i)[..., None, :], take(b.quat, i)[..., None, :],
                          take(b.form, i)[..., None, :]))
        t = torch.where(ty == TYPE_BOX, tv, t)
    if c["toruses"]:
        i = pick(c["toruses"])
        to = scene.toruses
        if t0 is None:
            raise ValueError("t_of_winner: the torus branch needs the sweep's t0")
        tv = gi.torus_polish_t(ro, rd, take(to.pos, i), take(to.quat, i), take(to.form, i),
                               torch.where(ty == TYPE_TORUS, t0, INF))
        t = torch.where(ty == TYPE_TORUS, tv, t)
    if c["rings"]:
        i = pick(c["rings"])
        r = scene.rings
        tv = one(gi.ring_t(ro, rd, take(r.pos, i)[..., None, :], take(r.quat, i)[..., None, :],
                           take(r.r1, i)[..., None], take(r.r2, i)[..., None]))
        t = torch.where(ty == TYPE_RING, tv, t)
    if c["lights_point"]:
        i = pick(c["lights_point"])
        lp = scene.lights_point
        no = torch.zeros(ty.shape + (1,), dtype=torch.bool, device=ty.device)
        tv = one(gi.sphere_t(ro, rd, take(lp.pos, i)[..., None, :],
                             take(lp.radius, i)[..., None], no))
        t = torch.where(ty == TYPE_POINT_LIGHT, tv, t)
    return t


def nearest_hit_saved(scene, ro, rd, slot, t0, one_side_planes=True):
    """calcInter from a saved sweep winner (slot, t0 with +inf on a miss):
    the differentiable O(R) recompute the fused route's backward uses.
    Grazing lanes whose recompute lands on the miss side keep t0, so the
    branch masks agree with the forward's."""
    type_tab, idx_tab = _type_tables(scene)
    slot = slot.to(torch.int64)
    hit = torch.isfinite(t0)
    ty = torch.where(hit, type_tab.index_select(0, slot), -1)
    idx = idx_tab.index_select(0, slot)
    t = t_of_winner(scene, ro, rd, ty, idx, one_side_planes, t0=t0)
    t = torch.where(hit & ~torch.isfinite(t), t0, t)
    return torch.where(hit, t, INF), ty, idx


def _sweep(scene, ro, rd, one_side_planes, table, alive=None):
    """The detached winner search → (t0 [R], +inf on a miss; ty; idx); the
    lanes off in ``alive`` read as misses.  On CUDA tensors: one kernel
    launch and a few elementwise ops, no host synchronisation."""
    buf, hdr = _table(scene, table, one_side_planes)
    t0, slot = nearest_hit_sweep(buf, hdr, ro.detach().contiguous(), rd.detach().contiguous(),
                                 alive)
    type_tab, idx_tab = _type_tables(scene)
    slot = slot.to(torch.int64)
    hit = t0 < MAX_DIST
    return (torch.where(hit, t0, INF), torch.where(hit, type_tab.index_select(0, slot), -1),
            idx_tab.index_select(0, slot))


@dataclasses.dataclass(frozen=True)
class _Spec:
    scene: object          # the scene the leaves below are read from
    paths: tuple           # dotted paths of the float leaves passed to apply
    one_side: bool
    table: object
    alive: object          # the sweep's lane mask, or None


class _NearestHit(torch.autograd.Function):
    """(t, ty, idx) of the sweep; the gradient of t reaches ro, rd and the
    scene's float leaves through ``t_of_winner`` (txr/render/intersect.py:
    260-292)."""

    @staticmethod
    def forward(ctx, spec, ro, rd, *leaves):
        t0, ty, idx = _sweep(spec.scene, ro, rd, spec.one_side, spec.table, spec.alive)
        ctx.spec = spec
        ctx.save_for_backward(ro, rd, t0, ty, idx, *leaves)
        ctx.mark_non_differentiable(ty, idx)
        return t0, ty, idx

    @staticmethod
    def backward(ctx, g_t, _g_ty, _g_idx):
        ro, rd, t0, ty, idx, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        spec = ctx.spec
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n) for x, n in zip((ro, rd, *leaves), need)]
            scene = unflatten_like(spec.scene, dict(zip(spec.paths, ins[2:])))
            t = t_of_winner(scene, ins[0], ins[1], ty, idx, spec.one_side, t0=t0)
            t = torch.where(torch.isfinite(t), t, 0.0)
            g = torch.where(torch.isfinite(t0), g_t, 0.0)
            wrt = [x for x, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(t, wrt, g, allow_unused=True))
        return (None,) + tuple(next(grads) if n else None for n in need)


def nearest_hit(scene, ro, rd, one_side_planes=True, table=None, alive=None):
    """calcInter → (t [R], type [R], idx [R]) int64; a miss is t = +inf,
    type = −1.  ``table``: ``pack_scene``'s (buf, hdr) of this scene, packed
    once by the caller; packed here when None.  ``alive`` [R] bool: the rays
    to trace (None: all); the others read as misses, with zero gradient."""
    R = ro.shape[:-1]
    if not sum(scene.counts[k] for k in SLOT_ORDER):
        return (torch.full(R, INF, dtype=ro.dtype, device=ro.device),
                torch.full(R, -1, dtype=torch.int64, device=ro.device),
                torch.zeros(R, dtype=torch.int64, device=ro.device))
    leaves = float_leaves(scene)
    if not torch.is_grad_enabled() or not any(
            x.requires_grad for x in (ro, rd, *leaves.values())):
        return _sweep(scene, ro, rd, one_side_planes, table, alive)
    spec = _Spec(scene, tuple(leaves), one_side_planes, table, alive)
    return _NearestHit.apply(spec, ro, rd, *leaves.values())


def shadow_from_probes(scene, textures, solid, ring_hit, ring_uv):
    """Shadow factor from detached any-hit results (inShadow,
    rt.frag:630-658): solid occlusion; an opaque ring hit shadows fully; a
    textured ring attenuates by its texture alpha at the hit uv, which keeps
    its texture-content gradient.  The alpha fetch runs on the lanes that
    hit a textured ring only (``over_lanes``).  solid [...], ring_hit
    [..., nr]."""
    sh = solid
    if scene.counts["rings"] and ring_hit is not None:
        textured = scene.rings.texture > 0
        have_tex = textures is not None and textures.ring_alpha is not None
        opaque = ~textured if have_tex else torch.ones_like(textured)
        sh = torch.maximum(sh, (ring_hit & opaque).any(-1).to(sh.dtype))
        if have_tex:
            a = over_lanes((ring_hit & textured).reshape(-1),
                           lambda _, uv: tx.sample_ring_alpha(textures, uv),
                           ring_uv.reshape(-1, 2))
            if a is not None:
                sh = sh + a.reshape(ring_hit.shape).sum(-1)
    return torch.clamp(sh, max=1.0)


def shadow_factor(scene, ro, rd, dist, textures=None, one_side_planes=True, table=None,
                  need=None):
    """inShadow (rt.frag:630-658) for shadow rays ro, rd [R,3] toward a
    light at ``dist`` [R] → shadow ∈ [0, 1], [R].  ``need`` [R] bool: the
    rays to trace (None: all); the others read 0, unshadowed."""
    buf, hdr = _table(scene, table, one_side_planes)
    solid, ring_hit, ring_uv = shadow_sweep(buf, hdr, ro.detach().contiguous(),
                                            rd.detach().contiguous(),
                                            dist.detach().contiguous(), need)
    return shadow_from_probes(scene, textures, solid, ring_hit, ring_uv)
