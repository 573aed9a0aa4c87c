"""One bounce step on the probe and consume kernels (txr/render/fused.py:31-456).

The probe does every sweep, the hit info, Fresnel and the per-light shading
probes; the consume applies the one texture fetch, the glossy pass's shade
and the per-ray state update, mask for mask in the order of the JAX
package's ``fused_step_fwd`` (rt.frag:804-902).  On the card a step is four
launches: probe, glossy rays, probe on the glossy lanes, consume
(``kernels/step_consume.py``).  On CPU tensors the wrappers ``glossy_rays``
and ``step_consume`` run the plain twins here, ``glossy_rays_ref`` and
``step_consume_ref``, the eager body of the step.  Each wrapper is looked
up in this module at call time (``utils/flops.py: priced_launches`` wraps
them).
"""

from __future__ import annotations

import torch

from txr_torch.kernels import step_consume as sc
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.kernels.step_probe import KIND_BOX, KIND_RGBA, Rows, step_probe
from txr_torch.render import texture as tx
from txr_torch.render.intersect import _type_tables, over_lanes, shadow_from_probes
from txr_torch.render.shading import reflect, refract
from txr_torch.scene.types import TYPE_POINT_LIGHT, TYPE_SPHERE


def _probe(scene, textures, cfg, ro, rd, shade_flipped, table=None, alive=None, fill=True):
    """The step probe's ``Rows`` (its output, read as ``unpack``'s dict);
    ``alive`` [R] bool, the lanes the caller reads (None: every lane);
    ``fill``: whether the kernel stores fill rows on the lanes no consume
    kernel reads (``step_probe``), which a caller that saves the rows
    needs."""
    from txr_torch.render.trace import _pix_angle

    f, i = step_probe(
        scene, textures.atlas, ro, rd,
        one_side=cfg.plane_oneside, shadow_enabled=cfg.shadow_enabled,
        do_fresnel=cfg.do_fresnel, tir=cfg.total_internal_reflection,
        pix_angle=_pix_angle(cfg) or 0.0, shade_flipped=shade_flipped,
        device=ro.device, table=table, alive=alive, fill=fill)
    return Rows(f, i, scene.counts)


def _fetch_texels(textures, cfg, pr, ty):
    """The one atlas fetch serving every textured hit type, fed by the
    probe's requests.  Sphere lanes carry the rotated normal; the spherical
    UV is finished here.  Only lanes that request texels are fetched
    (``over_lanes``; a lane the probe skipped requests none), the others
    read 1 and never use it; None when no lane requests."""
    atlas = textures.atlas
    if atlas is None:
        return None
    kind = pr["kind"]

    def fetch(_, req, kind, ty, k, lod):
        sphere_tex = (kind == KIND_RGBA) & (ty == TYPE_SPHERE)
        uv = torch.where(sphere_tex[..., None], tx.sphere_uv(req), req[..., :2])
        k = torch.clamp(k, 0, len(atlas.dims) - 1)
        return tx.sample_atlas(atlas, k, uv, lod if cfg.texture_lod else None)

    return over_lanes((kind == KIND_RGBA) | (kind == KIND_BOX), fetch, pr["req"], kind, ty,
                      pr["req_k"], pr["lod"], fill=1.0)


def _apply_texture(pr, texc):
    """Textured colour/alpha overrides (get_hit_info's per-type branches)."""
    mcol = pr["color"]
    alpha = torch.ones_like(pr["t"])
    if texc is not None:
        rgba = pr["kind"] == KIND_RGBA
        mcol = torch.where(rgba[..., None], texc[..., :3], mcol)
        alpha = torch.where(rgba, texc[..., 3], alpha)
        boxk = pr["kind"] == KIND_BOX
        mcol = torch.where(boxk[..., None], texc[..., :3] * pr["tex_w"][..., None], mcol)
    return mcol, alpha


def _shade_from_probes(scene, textures, cfg, pr, mcol):
    """calcShade from the probes: ambient + Σ_lights (1 − shadow)·Phong
    (rt.frag:660-709)."""
    c = scene.counts
    ambient = scene.ambient_color * mcol
    if c["lights_point"] + c["lights_direct"] == 0:
        return ambient
    if cfg.shadow_enabled:
        sh = shadow_from_probes(scene, textures, pr["light_solid"], pr["ring_hit"],
                                pr["ring_uv"])
        factor = torch.maximum((1.0 - sh)[..., None], scene.shadow_ambient)
    else:
        factor = torch.ones(pr["light_solid"].shape + (3,), device=mcol.device)
    lcolor = torch.cat([scene.lights_point.color, scene.lights_direct.color])   # [L, 3]
    com = pr["light_s"][..., None] * factor                                      # [R, L, 3]
    diffuse = (com * lcolor).sum(-2)
    spec = (com * lcolor * pr["light_spec"][..., None]).sum(-2)
    return (ambient + diffuse * mcol * pr["diffuse"][..., None] * pr["kd"][..., None]
            + spec * pr["ks"][..., None])


def _types_of(scene, pr):
    type_tab, idx_tab = _type_tables(scene)
    hit = torch.isfinite(pr["t"])
    if not type_tab.numel():
        none = torch.full_like(pr["slot"], -1)
        return hit, none, none
    ty = torch.where(hit, type_tab[pr["slot"]], -1)
    return hit, ty, idx_tab[pr["slot"]]


def _light_color(scene, idx):
    n = scene.counts["lights_point"]
    return scene.lights_point.color[torch.clamp(idx, 0, n - 1)]


def _reflected_color(scene, textures, cfg, pr):
    """getReflectedColor (rt.frag:787-802) from the glossy probe's rows,
    whose shading probes used the unflipped hit normal: the hit's shade, a
    light bulb's colour, black on a miss."""
    hit0, ty, idx = _types_of(scene, pr)
    is_light = ty == TYPE_POINT_LIGHT
    hit = hit0 & ~is_light
    mcol, _ = _apply_texture(pr, _fetch_texels(textures, cfg, pr, ty))
    shade = _shade_from_probes(scene, textures, cfg, pr, mcol)
    color = torch.where(hit[..., None], shade, 0.0)
    if scene.counts["lights_point"]:
        color = torch.where(is_light[..., None], _light_color(scene, idx), color)
    return color


def glossy_rays_ref(scene, st, pr):
    """Plain twin of the glossy-rays kernel: (glossy [N] bool, origins,
    directions [N, 3]) on every lane."""
    ro, rd = st["ro"], st["rd"]
    hit, ty, _ = _types_of(scene, pr)
    act = st["alive"] & hit
    if scene.counts["lights_point"]:
        act = act & ~(ty == TYPE_POINT_LIGHT)
    n = pr["n"]
    t_safe = torch.where(hit, pr["t"], 0.0)
    pt = ro + rd * t_safe[..., None]
    bias = ((9e-3 * t_safe + 35.0) / 35e3)[..., None]
    glossy = act & (pr["refract"] > 0.0) & pr["outside"] & (pr["reflect"] > 0.0)
    return glossy, (pt + n * bias).contiguous(), reflect(rd, n).contiguous()


def step_consume_ref(scene, textures, cfg, st, pr, gpr=None):
    """Plain twin of the consume kernel: st (dict of per-ray state) and the
    step's probe ``pr`` (and with ``cfg.refractive_glossy`` the glossy
    probe ``gpr``, traced on ``glossy_rays``' lanes) → the next state."""
    ro, rd = st["ro"], st["rd"]
    alive = st["alive"]
    color, mask = st["color"], st["mask"]
    absorb_dist = st["absorb_dist"]
    bounces = st["bounces"]

    t = pr["t"]
    hit, ty, idx = _types_of(scene, pr)
    act = alive & hit
    # a miss records one bit; the environment is fetched after the loop
    missed = st["missed"] | (alive & ~hit)
    alive = alive & hit

    if scene.counts["lights_point"]:
        is_light = act & (ty == TYPE_POINT_LIGHT)
        color = torch.where(is_light[..., None], color + _light_color(scene, idx) * mask, color)
        alive = alive & ~is_light
        act = act & ~is_light

    mcol, alpha = _apply_texture(pr, _fetch_texels(textures, cfg, pr, ty))

    n = pr["n"]                      # already flipped to face the ray
    outside = pr["outside"]
    t_safe = torch.where(hit, t, 0.0)
    pt = ro + rd * t_safe[..., None]
    bias = ((9e-3 * t_safe + 35.0) / 35e3)[..., None]

    refr_idx = pr["refract"]
    refl = pr["reflect"]
    is_refractive = refr_idx > 0.0
    reflect_mult = pr["rm"]
    refract_mult = 1.0 - reflect_mult

    shade_origin_out = pt + n * bias
    shade_origin_in = pt - n * bias

    refr_act = act & is_refractive
    glossy = refr_act & outside & (refl > 0.0)
    if cfg.refractive_glossy:
        rc = torch.where(glossy[..., None], _reflected_color(scene, textures, cfg, gpr), 0.0)
        g = glossy[..., None]
        color = torch.where(g, color + rc * reflect_mult[..., None] * mask, color)
        mask = torch.where(g, mask * refract_mult[..., None], mask)

    inside = refr_act & ~outside
    absorb_dist = torch.where(inside, absorb_dist + t, absorb_dist)
    beer = torch.exp(-pr["absorb"] * absorb_dist[..., None])
    mask = torch.where(inside[..., None], mask * beer, mask)

    if cfg.total_internal_reflection:
        tir = refr_act & (reflect_mult >= 1.0)
        alive = alive & ~tir
        refr_act = refr_act & ~tir

    eta = torch.where(outside, 1.0 / torch.clamp(refr_idx, min=1e-6), refr_idx)
    ro = torch.where(refr_act[..., None], shade_origin_in, ro)
    rd = torch.where(refr_act[..., None], refract(rd, n, eta), rd)

    refl_act = act & ~is_refractive & (refl > 0.0)
    diff_act = act & ~is_refractive & (refl <= 0.0)
    shade = _shade_from_probes(scene, textures, cfg, pr, mcol)
    shade = torch.where((refl_act | diff_act)[..., None], shade, 0.0)

    color = torch.where(refl_act[..., None],
                        color + shade * refract_mult[..., None] * mask, color)
    ro = torch.where(refl_act[..., None], shade_origin_out, ro)
    rd = torch.where(refl_act[..., None], reflect(rd, n), rd)
    mask = torch.where(refl_act[..., None], mask * reflect_mult[..., None], mask)

    color = torch.where(diff_act[..., None], color + shade * mask * alpha[..., None], color)
    translucent = diff_act & (alpha < 1.0)
    ro = torch.where(translucent[..., None], shade_origin_in, ro)
    mask = torch.where(translucent[..., None], mask * (1.0 - alpha[..., None]), mask)
    alive = alive & ~(diff_act & (alpha >= 1.0))

    consumed = act & ~refr_act if cfg.reflect_reduce_iteration else act
    bounces = torch.where(consumed, bounces + 1, bounces)
    alive = alive & (bounces < cfg.iterations)

    return dict(ro=ro.contiguous(), rd=rd.contiguous(), color=color, mask=mask,
                absorb_dist=absorb_dist, bounces=bounces, alive=alive, missed=missed)


def glossy_rays(scene, st, pr, table):
    """The glossy pass's lanes and rays of a step (``sc.launch_rays``): the
    kernel on CUDA tensors, ``glossy_rays_ref`` on CPU ones."""
    if st["ro"].device.type != "cpu":
        return sc.launch_rays(st, pr, table)
    sc.check_rays_args(st, pr, table)
    return glossy_rays_ref(scene, st, pr)


def step_consume(scene, textures, cfg, st, pr, gpr, table):
    """One bounce step after its probes (``sc.launch``): the kernel on CUDA
    tensors, ``step_consume_ref`` on CPU ones."""
    if st["ro"].device.type != "cpu":
        return sc.launch(textures, cfg, st, pr, gpr, table)
    sc.check_args(textures, cfg, st, pr, gpr, table)
    return step_consume_ref(scene, textures, cfg, st, pr, gpr)


def glossy_probe(scene, textures, cfg, st, pr, table):
    """getReflectedColor's probe (rt.frag:787-802): the glossy lanes of the
    step (``glossy_rays``) probed along their reflected rays with the
    unflipped hit normal → the probe's ``Rows``, whose hits ``step_consume``
    shades.  No VJP saves them, so on the card the kernel stores no fills:
    the other lanes' rows are left unwritten.  On the CPU the probe's twin
    works through every lane and masks, as ``over_lanes`` does there."""
    glossy, ro_g, rd_g = glossy_rays(scene, st, pr, table)
    return _probe(scene, textures, cfg, ro_g, rd_g, shade_flipped=False, table=table,
                  alive=glossy, fill=False)


def fused_step_fwd(scene, textures, cfg, st, pr=None, table=None):
    """One bounce step: st (dict of per-ray state) → the next state.  ``pr``:
    the step's probe (``_probe``), run here when None, storing no fills,
    since nothing but the step reads its rows; ``table``: the packed scene
    table (``pack_scene``) of this scene and atlas, packed here when
    None."""
    if table is None:
        table = pack_scene(scene, textures.atlas)
    if pr is None:
        pr = _probe(scene, textures, cfg, st["ro"], st["rd"], shade_flipped=True, table=table,
                    alive=st["alive"], fill=False)
    gpr = glossy_probe(scene, textures, cfg, st, pr, table) if cfg.refractive_glossy else None
    return step_consume(scene, textures, cfg, st, pr, gpr, table)
