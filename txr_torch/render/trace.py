"""The bounce loop (txr/render/trace.py, rt.frag:804-902).

Every ray carries an ``alive`` mask and the state updates are masked, as in
the JAX package; the loop runs ``cfg.max_steps`` steps and stops early once
no ray is alive.  A refraction event does not consume a bounce (the ``i--``
at rt.frag:870-872), so the loop length is ``iterations +
extra_refraction_steps``.  The environment is fetched once, after the loop,
for the rays that missed.

Two routes run a step.  ``fused="auto"``/``"on"`` runs the probe kernel
(render/fused.py); its gradient is one ``torch.autograd.Function`` per step
whose backward recomputes ``step_jnp`` in saved mode from the probe's sweep
winner and shadow bits.  ``fused="off"`` runs ``step_jnp`` itself, the
differentiable eager body over the nearest-hit and shadow-sweep kernels;
with ``remat`` each step is checkpointed, so a backward holds one step's
graph at a time.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from txr_torch import resolve_device
from txr_torch.geometry import intersect as gi
from txr_torch.geometry import quaternion as quat
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.kernels.step_consume import STATE_KEYS
from txr_torch.render import texture as tx
from txr_torch.render.fused import _probe, fused_step_fwd
from txr_torch.render.intersect import (
    nearest_hit,
    nearest_hit_saved,
    over_lanes,
    shadow_from_probes,
)
from txr_torch.render.shading import (
    calc_shade,
    fresnel_reflect_amount,
    fresnel_schlick,
    reflect,
    refract,
)
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
from txr_torch.utils.debug import program
from txr_torch.utils.index import take


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The render options that change a pixel — the reference's feature
    defines (rt.frag:15-22) — and the two routes' switches."""

    width: int = 1280
    height: int = 720
    iterations: int = 5               # reflect_depth, SceneManager.cpp:233
    supersample: int = 1
    # budget for the non-consuming refraction steps (rt.frag:870-872)
    extra_refraction_steps: int = 6
    shadow_enabled: bool = True       # SHADOW_ENABLED, rt.frag:15
    do_fresnel: bool = True           # DO_FRESNEL, rt.frag:20
    total_internal_reflection: bool = True  # rt.frag:19
    plane_oneside: bool = True        # PLANE_ONESIDE, rt.frag:21
    reflect_reduce_iteration: bool = True   # rt.frag:22
    # checkpoint each step of the fused="off" route: the backward recomputes
    # a step's forward and holds one step's graph at a time
    remat: bool = True
    texture_lod: bool = True          # ray-footprint mip LOD
    # "auto"/"on": the step-probe kernel per bounce step (render/fused.py);
    # "off": the eager body step_jnp on the nearest-hit and shadow kernels
    fused: str = "auto"
    refractive_glossy: bool = True    # getReflectedColor pass, rt.frag:787-802
    # rays per sequential trace() call (0 = the whole batch at once): bounds
    # the peak per-ray working set of a frame and of its edge-AA pass
    ray_chunk: int = 0
    # "edge" renders 1 spp, then re-renders the luma-edge pixels at
    # supersample² (render._edge_aa); "ssaa" box-averages a uniformly
    # supersampled frame.  Both are differentiable; the edge mask is detached.
    aa_mode: str = "edge"
    # luma edge-detect threshold (SMAA_THRESHOLD, SMAA.h:319-323)
    edge_threshold: float = 0.02
    # at most edge_budget_mult·(H+W) pixels re-render, the first ones in
    # row-major order; edge pixels past the budget keep their 1-spp value
    edge_budget_mult: int = 20

    @property
    def max_steps(self):
        if self.reflect_reduce_iteration:
            return self.iterations + self.extra_refraction_steps
        return self.iterations

    def with_aa_preset(self, preset: str, mode: str = "edge") -> "RenderConfig":
        """The reference's SMAA_PRESET_{LOW,MEDIUM,HIGH,ULTRA}
        (SMAA_Builder.h:9-12) as a sub-sample factor k (``AA_PRESETS``):
        mode "edge" re-renders the luma-edge pixels at k² spp, "ssaa"
        supersamples every pixel k×."""
        return dataclasses.replace(self, supersample=AA_PRESETS[preset.lower()], aa_mode=mode)


# SMAA preset → supersampling factor ("low" barely thresholds: no AA)
AA_PRESETS = {"off": 1, "low": 1, "medium": 2, "high": 3, "ultra": 4}


def auto_refraction_steps(scene, cap: int = 6) -> int:
    """The refraction budget a scene needs: ``cap`` when any material
    refracts, else 0."""
    for g in (scene.spheres, scene.planes, scene.surfaces, scene.boxes,
              scene.toruses, scene.rings):
        if g.mat.refract.numel() and bool((g.mat.refract > 0).any()):
            return cap
    return 0


def _pix_angle(cfg):
    """Radians per sample: raygen normalises by height (rt.frag:313-317)."""
    return 1.0 / (cfg.height * cfg.supersample) if cfg.texture_lod else None


def _background(scene, textures, rd):
    if textures.cube is not None:
        return tx.sample_cubemap(textures, rd)
    return scene.bg_color.expand(rd.shape)


def hit_info(scene, textures, ro, rd, t, ty, idx, pix_angle=None):
    """get_hit_info (rt.frag:744-784): per-ray normal, material with the
    texture applied, alpha and the shadow-acne bias (trace.py:196-489).
    Each type's normal is computed for every ray and blended by the type
    mask; every textured type requests (slot, uv, lod), and one atlas fetch
    on the requesting lanes (``over_lanes``) serves them all."""
    R = t.shape
    dt, dev = ro.dtype, ro.device
    c = scene.counts
    atlas = textures.atlas
    z3 = torch.zeros(R + (3,), dtype=dt, device=dev)
    z1 = torch.zeros(R, dtype=dt, device=dev)
    out = dict(normal=z3, color=z3, absorb=z3, diffuse=z1, reflection=z1, refraction=z1,
               specular=z1, kd=z1, ks=z1, alpha=z1 + 1.0)
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    pt = ro + rd * t_safe[..., None]
    req = dict(k=torch.zeros(R, dtype=torch.int64, device=dev),
               uv=torch.zeros(R + (2,), dtype=dt, device=dev), lod=z1,
               any=torch.zeros(R, dtype=torch.bool, device=dev))
    texd = {}          # type → (lanes that take the fetched texel, box face weight)

    def fw_of(n):
        return tx.footprint_world(t_safe, (rd * n).sum(-1).abs(), pix_angle)

    def blend(sel, mat, i, n):
        s1 = sel[..., None]
        out["normal"] = torch.where(s1, n, out["normal"])
        for key, name in (("color", "color"), ("absorb", "absorb")):
            out[key] = torch.where(s1, take(getattr(mat, name), i), out[key])
        for key, name in (("diffuse", "diffuse"), ("reflection", "reflect"),
                          ("refraction", "refract"), ("specular", "specular"),
                          ("kd", "kd"), ("ks", "ks")):
            out[key] = torch.where(sel, take(getattr(mat, name), i), out[key])

    def request(sel, k, uv, lod):
        req["k"] = torch.where(sel, k, req["k"])
        req["uv"] = torch.where(sel[..., None], uv, req["uv"])
        if pix_angle is not None:
            req["lod"] = torch.where(sel, lod, req["lod"])
        req["any"] = req["any"] | sel

    if c["spheres"]:
        sp = scene.spheres
        i = torch.clamp(idx, 0, c["spheres"] - 1)
        sel = ty == TYPE_SPHERE
        n = gi.sphere_normal(pt, take(sp.pos, i))
        if atlas is not None and atlas.n_sphere:
            tex_num = take(sp.texture, i).to(torch.int64)
            textured = sel & (tex_num > 0)
            k = torch.clamp(tex_num - 1, 0, atlas.n_sphere - 1)
            uv = tx.sphere_uv(quat.rotate(take(sp.quat, i), n))
            lod = None if pix_angle is None else tx.lod_sphere(
                fw_of(n), take(sp.radius, i), (atlas.h0[k], atlas.w0[k]))
            request(textured, k, uv, lod)
            texd[TYPE_SPHERE] = (textured, None)
        blend(sel, sp.mat, i, n)
    if c["planes"]:
        pl = scene.planes
        i = torch.clamp(idx, 0, c["planes"] - 1)
        blend(ty == TYPE_PLANE, pl.mat, i, gi.safe_normalize(take(pl.normal, i)))
    if c["surfaces"]:
        su = scene.surfaces
        i = torch.clamp(idx, 0, c["surfaces"] - 1)
        blend(ty == TYPE_SURFACE, su.mat, i,
              gi.surface_normal(ro, rd, t_safe, take(su.pos, i), take(su.quat, i),
                                take(su.coef, i)))
    if c["boxes"]:
        bx = scene.boxes
        i = torch.clamp(idx, 0, c["boxes"] - 1)
        sel = ty == TYPE_BOX
        bpos, bquat = take(bx.pos, i), take(bx.quat, i)
        n = gi.box_normal(ro, rd, bpos, bquat, take(bx.form, i))
        if atlas is not None and atlas.box_slot is not None:
            textured = sel & (take(bx.texture, i) > 0)
            uv, box_w = tx.box_face_uv(pt, n, bpos, bquat)
            lod = None if pix_angle is None else tx.lod_box(fw_of(n), atlas.dims[atlas.box_slot])
            request(textured, torch.full_like(req["k"], atlas.box_slot), uv, lod)
            texd[TYPE_BOX] = (textured, box_w)
        blend(sel, bx.mat, i, n)
    if c["toruses"]:
        to = scene.toruses
        i = torch.clamp(idx, 0, c["toruses"] - 1)
        blend(ty == TYPE_TORUS, to.mat, i,
              gi.torus_normal(ro, rd, t_safe, take(to.pos, i), take(to.quat, i), take(to.form, i)))
    if c["rings"]:
        ri = scene.rings
        i = torch.clamp(idx, 0, c["rings"] - 1)
        sel = ty == TYPE_RING
        rquat = take(ri.quat, i)
        n = gi.ring_normal(rquat)
        if atlas is not None and atlas.ring_slot is not None:
            r1, r2 = take(ri.r1, i), take(ri.r2, i)
            textured = sel & (take(ri.texture, i) > 0)
            uv = gi.ring_uv(ro, rd, t_safe, take(ri.pos, i), rquat, r1, r2)
            lod = None if pix_angle is None else tx.lod_ring(
                fw_of(n), r1, r2, atlas.dims[atlas.ring_slot])
            request(textured, torch.full_like(req["k"], atlas.ring_slot), uv, lod)
            texd[TYPE_RING] = (textured, None)
        blend(sel, ri.mat, i, n)

    rows = (req["k"], req["uv"]) + (() if pix_angle is None else (req["lod"],))
    texc = over_lanes(req["any"], lambda _, k, uv, lod=None: tx.sample_atlas(atlas, k, uv, lod),
                      *rows, fill=1.0) if texd else None
    if texc is not None:
        for ty_, (sel, box_w) in texd.items():
            rgb = texc[..., :3] if box_w is None else texc[..., :3] * box_w[..., None]
            out["color"] = torch.where(sel[..., None], rgb, out["color"])
            if ty_ != TYPE_BOX:
                out["alpha"] = torch.where(sel, texc[..., 3], out["alpha"])
    out["pt"] = pt
    out["bias"] = (9e-3 * t_safe + 35.0) / 35e3      # rt.frag:780-782
    return out


def _reflected_color(scene, textures, cfg, ro, rd, table=None, alive=None):
    """getReflectedColor (rt.frag:787-802): one extra nearest hit and shade
    for the glossy part of a refractive surface (not recursive).  ``alive``
    [R] bool: the lanes to trace (None: all); the others read black."""
    t, ty, idx = nearest_hit(scene, ro, rd, cfg.plane_oneside, table, alive=alive)
    hi = hit_info(scene, textures, ro, rd, t, ty, idx, _pix_angle(cfg))
    is_light = ty == TYPE_POINT_LIGHT
    hit = torch.isfinite(t) & (ty >= 0) & ~is_light
    n = hi["normal"]
    facing = (rd * n).sum(-1) < 0
    bias = hi["bias"][..., None]
    ro2 = torch.where(facing[..., None], hi["pt"] + n * bias, hi["pt"] - n * bias)
    shade = calc_shade(scene, textures, ro2, rd, hi["color"], hi["diffuse"], hi["specular"],
                       hi["kd"], hi["ks"], n, True, cfg.shadow_enabled, cfg.plane_oneside,
                       table=table, need=alive)
    color = torch.where(hit[..., None], shade, 0.0)
    if scene.counts["lights_point"]:
        n_lp = scene.counts["lights_point"]
        lcol = take(scene.lights_point.color, torch.clamp(idx, 0, n_lp - 1))
        color = torch.where(is_light[..., None], lcol, color)
    return color


def step_jnp(scene, textures, cfg: RenderConfig, st, saved=None, table=None):
    """One bounce step of the eager, differentiable body (trace.py:602-790):
    nearest hit, hit info, Fresnel split, the glossy, refractive,
    reflective and diffuse branches, the masked state update.

    ``saved`` (slot, t, light_solid, ring_hit, ring_uv of the fused route's
    probe, or None): the sweeps are skipped — t comes from the O(R) winner
    recompute (``nearest_hit_saved``) and the shadow factor from the saved
    any-hit bits.  Both are piecewise constant in the scene, so the
    gradients are those of the sweeping body."""
    ro, rd = st["ro"], st["rd"]
    alive = st["alive"]
    color, mask = st["color"], st["mask"]
    absorb_dist = st["absorb_dist"]
    bounces = st["bounces"]

    if saved is None:
        # dead lanes are not traced: they read as misses, which alive masks
        t, ty, idx = nearest_hit(scene, ro, rd, cfg.plane_oneside, table, alive=alive)
    else:
        t, ty, idx = nearest_hit_saved(scene, ro, rd, saved["slot"], saved["t"],
                                       cfg.plane_oneside)
    hit = torch.isfinite(t)
    act = alive & hit
    # a miss records one bit; the environment is fetched after the loop
    missed = st["missed"] | (alive & ~hit)
    alive = alive & hit

    if scene.counts["lights_point"]:
        is_light = act & (ty == TYPE_POINT_LIGHT)
        n_lp = scene.counts["lights_point"]
        lcol = take(scene.lights_point.color, torch.clamp(idx, 0, n_lp - 1))
        color = torch.where(is_light[..., None], color + lcol * mask, color)
        alive = alive & ~is_light
        act = act & ~is_light

    hi = hit_info(scene, textures, ro, rd, t, ty, idx, _pix_angle(cfg))
    n = hi["normal"]
    outside = (rd * n).sum(-1) < 0.0                   # rt.frag:837
    n = torch.where(outside[..., None], n, -n)
    pt = hi["pt"]
    bias = hi["bias"][..., None]
    refr_idx = hi["refraction"]
    refl = hi["reflection"]
    is_refractive = refr_idx > 0.0

    # Fresnel split (rt.frag:840-849)
    if cfg.total_internal_reflection:
        n1 = torch.where(outside, 1.0, refr_idx)
        n2 = torch.where(outside, refr_idx, 1.0)
        rm_refr = fresnel_reflect_amount(n1, n2, rd, n, refl, cfg.do_fresnel)
        reflect_mult = torch.where(is_refractive, rm_refr, fresnel_schlick(n, rd, refl))
    else:
        reflect_mult = fresnel_schlick(n, rd, refl)
    refract_mult = 1.0 - reflect_mult

    shade_origin_out = pt + n * bias
    shade_origin_in = pt - n * bias

    # refractive branch (rt.frag:851-873); the glossy pass runs on its lanes only
    refr_act = act & is_refractive
    glossy = refr_act & outside & (refl > 0.0)
    if cfg.refractive_glossy:
        rc = over_lanes(glossy, lambda alive, o, d: _reflected_color(
            scene, textures, cfg, o, d, table, alive=alive), shade_origin_out, reflect(rd, n))
        if rc is not None:
            g = glossy[..., None]
            color = torch.where(g, color + rc * reflect_mult[..., None] * mask, color)
            mask = torch.where(g, mask * refract_mult[..., None], mask)

    inside = refr_act & ~outside
    absorb_dist = torch.where(inside, absorb_dist + t, absorb_dist)
    beer = torch.exp(-hi["absorb"] * absorb_dist[..., None])
    mask = torch.where(inside[..., None], mask * beer, mask)

    if cfg.total_internal_reflection:
        tir = refr_act & (reflect_mult >= 1.0)        # rt.frag:865-866
        alive = alive & ~tir
        refr_act = refr_act & ~tir

    eta = torch.where(outside, 1.0 / torch.clamp(refr_idx, min=1e-6), refr_idx)
    ro = torch.where(refr_act[..., None], shade_origin_in, ro)
    rd = torch.where(refr_act[..., None], refract(rd, n, eta), rd)

    # reflective (rt.frag:874-880) and diffuse (rt.frag:881-890) branches
    refl_act = act & ~is_refractive & (refl > 0.0)
    diff_act = act & ~is_refractive & (refl <= 0.0)
    shadow_saved = None
    if saved is not None and cfg.shadow_enabled:
        shadow_saved = shadow_from_probes(scene, textures, saved["light_solid"],
                                          saved["ring_hit"], saved["ring_uv"])
    shade = calc_shade(scene, textures, shade_origin_out, rd, hi["color"], hi["diffuse"],
                       hi["specular"], hi["kd"], hi["ks"], n, True, cfg.shadow_enabled,
                       cfg.plane_oneside, shadow_saved=shadow_saved, table=table, need=act)
    shade = torch.where((refl_act | diff_act)[..., None], shade, 0.0)

    color = torch.where(refl_act[..., None], color + shade * refract_mult[..., None] * mask,
                        color)
    ro = torch.where(refl_act[..., None], shade_origin_out, ro)
    rd = torch.where(refl_act[..., None], reflect(rd, n), rd)
    mask = torch.where(refl_act[..., None], mask * reflect_mult[..., None], mask)

    alpha = hi["alpha"]
    color = torch.where(diff_act[..., None], color + shade * mask * alpha[..., None], color)
    translucent = diff_act & (alpha < 1.0)
    ro = torch.where(translucent[..., None], shade_origin_in, ro)
    mask = torch.where(translucent[..., None], mask * (1.0 - alpha[..., None]), mask)
    alive = alive & ~(diff_act & (alpha >= 1.0))

    # iteration accounting (the GLSL i-- at rt.frag:870-872)
    consumed = act & ~refr_act if cfg.reflect_reduce_iteration else act
    bounces = torch.where(consumed, bounces + 1, bounces)
    alive = alive & (bounces < cfg.iterations)
    return dict(ro=ro.contiguous(), rd=rd.contiguous(), color=color, mask=mask,
                absorb_dist=absorb_dist, bounces=bounces, alive=alive, missed=missed)


# ---------------------------------------------------------------------------
# The fused route's gradient (trace.py:812-910)
# ---------------------------------------------------------------------------

_FLOAT_STATE = STATE_KEYS[:5]
_SAVE_KEYS = ("slot", "t", "light_solid", "ring_hit", "ring_uv")


def _texture_leaves(textures):
    """The float tensors a step reads from a TextureSet (after with_mips)."""
    out = {}
    if textures.atlas is not None:
        out["atlas.texels"] = textures.atlas.texels
    if textures.ring_alpha is not None:
        out["ring_alpha"] = textures.ring_alpha
    return out


def _with_texture_leaves(textures, leaves):
    if "atlas.texels" in leaves:
        textures = dataclasses.replace(
            textures, atlas=dataclasses.replace(textures.atlas, texels=leaves["atlas.texels"]))
    if "ring_alpha" in leaves:
        textures = dataclasses.replace(textures, ring_alpha=leaves["ring_alpha"])
    return textures


@dataclasses.dataclass(frozen=True)
class _StepSpec:
    scene: object
    textures: object
    cfg: RenderConfig
    table: object
    scene_paths: tuple
    tex_paths: tuple


def vjp(fn, inputs, cotangents, need=None, seeds=None):
    """The VJP of ``fn`` by recomputation: ``fn(*inputs)`` (a tensor or a
    tuple of them) runs again under ``enable_grad`` with each input whose
    ``need`` holds (default: every floating input) a fresh leaf, then
    ``torch.autograd.grad`` pulls ``cotangents`` (one per output, None for
    none) back → the inputs' gradients in order, None where not wanted or
    not reached.  ``seeds`` {input index: tensor}: a gradient that input
    starts from, its share of the other contributions added on one at a
    time, in autograd's order, as one backward over many pieces adds them
    (float32 sums associate), so that the pieces' gradient equals that
    backward's bit for bit.  That leans on a detail of PyTorch's autograd
    engine, that of the outputs' branches it runs the one made last first
    (the seed's view), which
    tests/test_torch_train_jit.py::test_vjp_seeds_keep_autograds_order
    holds.  Every backward of the captured train step
    (``render/graphs.py``) is one of these."""
    if need is None:
        need = [x.is_floating_point() for x in inputs]
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) if x.is_floating_point() else x
              for x, n in zip(inputs, need)]
        outs = fn(*xs)
        outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
        cotangents = list(cotangents) + [None] * (len(outs) - len(cotangents))
        # views made last, so autograd runs them first: the seeds arrive first
        for i, seed in (seeds or {}).items():
            outs += (xs[i].view_as(xs[i]),)
            cotangents.append(seed)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, need) if n]
        grads = (torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                     allow_unused=True) if pairs and wrt else [None] * len(wrt))
    it = iter(grads)
    return [next(it) if n else None for n in need]


def step_saving(scene, textures, cfg, st, table):
    """One bounce step of ``cfg``'s route, without a gradient → (the next
    state, the residuals its VJP needs besides the input state: the probe's
    ``_SAVE_KEYS`` on the probe route, None on the eager route, whose VJP
    runs the sweeps again)."""
    if cfg.fused == "off":
        return step_jnp(scene, textures, cfg, st, table=table), None
    # saved on every lane in fixed shapes: the probe stores its fills
    pr = _probe(scene, textures, cfg, st["ro"], st["rd"], shade_flipped=True, table=table,
                alive=st["alive"], fill=True)
    out = fused_step_fwd(scene, textures, cfg, st, pr=pr, table=table)
    return out, {k: pr[k] for k in _SAVE_KEYS}


def step_vjp(scene, textures, cfg, table, st, saved, g_out, leaves, need=None, seeds=None):
    """The VJP of one bounce step (txr/render/trace.py:1035-1332, the loop
    VJP's step): ``step_jnp`` recomputed from the step's input state ``st``
    — in saved mode from the probe's residuals ``saved`` (probe route), with
    its sweeps when ``saved`` is None (eager route) — then the gradients.
    ``g_out``: {key of ``_FLOAT_STATE``: the cotangent of the step's output,
    or None}; ``leaves``: {path: tensor}, scene paths and ``atlas.texels`` /
    ``ring_alpha``, read in place of the scene's and textures' own;
    ``need``: one bool for each of ``_FLOAT_STATE`` then each leaf (default
    all) → that list of gradients, None where not wanted or not reached;
    ``seeds``: the gradient each leaf starts from (``vjp``), or None.
    ``_FusedStep.backward`` and the captured train step's backward pieces
    (``graphs.TraceUnit``) share it."""
    paths = list(leaves)

    def fn(*xs):
        x = dict(st, **dict(zip(_FLOAT_STATE, xs)))
        lv = dict(zip(paths, xs[len(_FLOAT_STATE):]))
        out = step_jnp(unflatten_like(scene, lv), _with_texture_leaves(textures, lv), cfg, x,
                       saved=saved, table=table)
        return tuple(out[k] for k in _FLOAT_STATE)

    inputs = [st[k] for k in _FLOAT_STATE] + list(leaves.values())
    n = len(_FLOAT_STATE)
    return vjp(fn, inputs, [g_out.get(k) for k in _FLOAT_STATE],
               [True] * len(inputs) if need is None else need,
               {} if seeds is None else {n + i: g for i, g in enumerate(seeds)})


class _FusedStep(torch.autograd.Function):
    """One probe-route step.  Forward: the probe kernel and the consume
    (``step_saving``), saving the step's input state and the probe's
    piecewise-constant subset (slot, t, light_solid, ring_hit, ring_uv).
    Backward: ``step_vjp``, ``step_jnp`` in saved mode — the sweeps are
    never re-run."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        st = dict(zip(STATE_KEYS, tensors))
        out, saved = step_saving(spec.scene, spec.textures, spec.cfg, st, spec.table)
        ctx.spec = spec
        ctx.has_rings = saved["ring_hit"] is not None
        # copies: the probe's rows are views of its whole [NF, N] output
        saves = [saved[k].clone() for k in _SAVE_KEYS if saved[k] is not None]
        ctx.save_for_backward(*tensors, *saves)
        res = tuple(out[k] for k in STATE_KEYS)
        ctx.mark_non_differentiable(*res[5:])
        return res

    @staticmethod
    def backward(ctx, *g_out):
        spec = ctx.spec
        n_st, n_fl = len(STATE_KEYS), len(_FLOAT_STATE)
        n_in = n_st + len(spec.scene_paths) + len(spec.tex_paths)
        saved_t = ctx.saved_tensors
        ins, saves = saved_t[:n_in], saved_t[n_in:]
        keys = _SAVE_KEYS if ctx.has_rings else _SAVE_KEYS[:3]
        saved = dict(dict.fromkeys(_SAVE_KEYS), **dict(zip(keys, saves)))
        need = ctx.needs_input_grad[1:]
        grads = step_vjp(spec.scene, spec.textures, spec.cfg, spec.table,
                         dict(zip(STATE_KEYS, ins[:n_st])), saved, dict(zip(STATE_KEYS, g_out)),
                         dict(zip(spec.scene_paths + spec.tex_paths, ins[n_st:])),
                         need[:n_fl] + need[n_st:])
        return (None, *grads[:n_fl], *[None] * (n_st - n_fl), *grads[n_fl:])


def _fused_step(scene, textures, cfg, st, table):
    """The probe-route step, through ``_FusedStep`` when a gradient is
    wanted (grad mode on and any input requiring it)."""
    leaves = float_leaves(scene)
    tex = _texture_leaves(textures)
    state = [st[k] for k in STATE_KEYS]
    if not torch.is_grad_enabled() or not any(
            a.requires_grad for a in (*state, *leaves.values(), *tex.values())):
        return fused_step_fwd(scene, textures, cfg, st, table=table)
    spec = _StepSpec(scene, textures, cfg, table, tuple(leaves), tuple(tex))
    res = _FusedStep.apply(spec, *state, *leaves.values(), *tex.values())
    return dict(zip(STATE_KEYS, res))


def initial_state(ro, rd):
    zero = torch.zeros(ro.shape[0], dtype=ro.dtype, device=ro.device)
    return dict(
        ro=ro, rd=rd, color=torch.zeros_like(ro), mask=torch.ones_like(ro),
        absorb_dist=zero,
        bounces=torch.zeros(ro.shape[0], dtype=torch.int32, device=ro.device),
        alive=torch.ones(ro.shape[0], dtype=torch.bool, device=ro.device),
        # a ray misses at most once (it dies, and a dead ray's rd and mask
        # never change), so one bit defers its environment fetch
        missed=torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device),
    )


def _check_route(cfg):
    if cfg.fused not in ("auto", "on", "off"):
        raise ValueError(f"RenderConfig.fused must be 'auto', 'on' or 'off', got {cfg.fused!r}")


def make_step(scene, textures, cfg, table):
    """The bounce step of ``cfg``'s route as a function of the state dict;
    on the eager route with ``remat`` and grad mode on, checkpointed."""
    if cfg.fused != "off":
        return lambda st: _fused_step(scene, textures, cfg, st, table)

    def step(st):
        return step_jnp(scene, textures, cfg, st, table=table)

    if cfg.remat and torch.is_grad_enabled():
        return lambda st: checkpoint(step, st, use_reentrant=False, preserve_rng_state=False)
    return step


def shade_misses(scene, textures, st):
    """The loop's tail: every ray that missed adds the environment along its
    rd, frozen at the miss, times its mask.  Every lane is computed (fixed
    shapes, no host read)."""
    env = _background(scene, textures, st["rd"])
    return st["color"] + env * torch.where(st["missed"][..., None], st["mask"], 0.0)


def shade_misses_vjp(scene, textures, st, g, leaves, seeds):
    """The VJP of ``shade_misses`` at the final state ``st``: the colours'
    cotangent g [R, 3] → ({color, mask, rd: the state's cotangent}, the
    gradient of each of ``leaves`` ({scene path: tensor}), each started
    from its ``seeds`` entry (``vjp``))."""
    keys, paths = ("color", "mask", "rd"), list(leaves)

    def fn(*xs):
        return shade_misses(unflatten_like(scene, dict(zip(paths, xs[3:]))), textures,
                            dict(st, **dict(zip(keys, xs))))

    grads = vjp(fn, [st[k] for k in keys] + list(leaves.values()), [g],
                seeds={3 + i: s for i, s in enumerate(seeds)})
    return dict(zip(keys, grads)), grads[3:]


@program
def trace(scene, textures, cfg: RenderConfig, ro, rd, device=None):
    """ro, rd [R,3] → RGB [R,3].  Scene, textures and rays move to
    ``device`` (CUDA unless the caller passes "cpu").  Differentiable in
    the rays, every float scene leaf and the texture contents.  The loop
    stops before a step when no lane is alive (a host read per step);
    ``graphs.TraceUnit`` runs the same head, step and tail with that
    test read one step late."""
    _check_route(cfg)
    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = tx.with_mips(textures.to(dev))
    # one packed scene table for every kernel launch of this call
    table = pack_scene(scene, textures.atlas)
    st = initial_state(ro.to(dev, torch.float32).contiguous(),
                       rd.to(dev, torch.float32).contiguous())
    step = make_step(scene, textures, cfg, table)
    for _ in range(cfg.max_steps):
        if not st["alive"].any():
            break
        st = step(st)
    return shade_misses(scene, textures, st)
