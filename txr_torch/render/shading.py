"""Phong shading, Fresnel, reflect and refract (txr/render/shading.py).

calcShade/calcShade2 (rt.frag:660-709), getFresnel (rt.frag:711-715) and
FresnelReflectAmount (rt.frag:717-742), over per-ray batches; lights are
the inner axis.
"""

from __future__ import annotations

import torch

from txr_torch.geometry.intersect import safe_normalize
from txr_torch.render.intersect import MAX_DIST, shadow_factor


def reflect(i, n):
    """GLSL reflect: i − 2·dot(n,i)·n."""
    return i - 2.0 * (n * i).sum(-1, keepdim=True) * n


def refract(i, n, eta):
    """GLSL refract; the zero vector on total internal reflection."""
    cosi = (n * i).sum(-1, keepdim=True)
    e = eta[..., None]
    k = 1.0 - e ** 2 * (1.0 - cosi * cosi)
    ok = k >= 0.0
    k_sqrt = torch.sqrt(torch.where(ok, k, 1.0))
    out = e * i - (e * cosi + torch.where(ok, k_sqrt, 0.0)) * n
    return torch.where(ok, out, 0.0)


def fresnel_schlick(n, rd, reflection):
    """getFresnel: Schlick with the material's base reflectivity."""
    ndotv = torch.clamp((n * -rd).sum(-1), 0.0, 1.0)
    return reflection + (1.0 - reflection) * (1.0 - ndotv) ** 5


def fresnel_reflect_amount(n1, n2, rd, n, refl, do_fresnel=True):
    """FresnelReflectAmount for refractive materials: Schlick between media
    n1 → n2 with total internal reflection (exactly 1), blended with the
    object's reflectivity.  Every division and sqrt is guarded, so lanes a
    ``where`` discards (n2 = 0 on opaque materials) keep the backward
    finite."""
    if not do_fresnel:
        return refl
    n2_safe = torch.where(n2.abs() > 1e-6, n2, 1.0)
    r0 = ((n1 - n2) / (n1 + n2_safe)) ** 2
    cos_x = -(rd * n).sum(-1)
    entering_denser = n1 > n2
    ratio = n1 / n2_safe
    sin_t2 = ratio * ratio * (1.0 - cos_x * cos_x)
    tir = entering_denser & (sin_t2 > 1.0)
    no_tir = sin_t2 < 1.0
    cos_t = torch.sqrt(torch.where(no_tir, 1.0 - sin_t2, 1.0))
    cos_x = torch.where(entering_denser, torch.where(no_tir, cos_t, 0.0), cos_x)
    ret = r0 + (1.0 - r0) * (1.0 - cos_x) ** 5
    ret = refl + (1.0 - refl) * ret
    return torch.where(tir, 1.0, ret)


def _spec_pow(base, exponent):
    """pow with a zero-safe base, so gradients never go NaN."""
    return torch.pow(torch.clamp(base, min=1e-12), exponent)


def calc_shade(scene, textures, pt, rd, mat_color, mat_diffuse, mat_specular, mat_kd, mat_ks,
               normal, do_shadow=True, shadow_enabled=True, one_side_planes=True,
               shadow_saved=None, table=None, need=None):
    """calcShade (rt.frag:681-709): ambient + per-light Phong with shadows
    and distance attenuation.  pt, rd, normal [R,3]; materials [R] / [R,3]
    → RGB [R,3].  Lights are point lights, then directional ones
    (dist = MAX_DIST); one shadow sweep covers them all, the [R, L] shadow
    rays flattened to R·L.  ``shadow_saved`` [R, L]: the shadow factors of
    the fused route's probe, used instead of the sweep.  ``need`` [R] bool:
    the lanes whose shade the caller reads (None: every lane); only their
    shadow rays are traced, the others count as unshadowed."""
    c = scene.counts
    ambient = scene.ambient_color * mat_color
    if c["lights_point"] + c["lights_direct"] == 0:
        return ambient
    dirs, dists, divs, colors, intens = [], [], [], [], []
    if c["lights_point"]:
        lp = scene.lights_point
        d = lp.pos - pt[..., None, :]                               # [R, Lp, 3]
        dist = torch.sqrt((d * d).sum(-1) + 1e-30)
        dirs.append(d)
        dists.append(dist)
        divs.append(1.0 + lp.linear_k * dist + lp.quadratic_k * dist * dist)
        colors.append(lp.color)
        intens.append(lp.intensity)
    if c["lights_direct"]:
        ld_ = scene.lights_direct
        shape = pt.shape[:-1] + (c["lights_direct"],)
        dirs.append((-ld_.direction).expand(shape + (3,)))
        dists.append(torch.full(shape, MAX_DIST, dtype=pt.dtype, device=pt.device))
        divs.append(torch.ones(shape, dtype=pt.dtype, device=pt.device))
        colors.append(ld_.color)
        intens.append(ld_.intensity)
    ld = safe_normalize(torch.cat(dirs, dim=-2))                    # [R, L, 3]
    dist = torch.cat(dists, dim=-1)
    w = (torch.cat(intens) / torch.cat(divs, dim=-1))[..., None]   # [R, L, 1]
    dp = torch.clamp((normal[..., None, :] * ld).sum(-1), 0.0, 1.0)
    lc = torch.cat(colors) * dp[..., None]
    if shadow_enabled and do_shadow:
        if shadow_saved is not None:
            sh = shadow_saved
        else:
            ro_f = pt[..., None, :].expand(ld.shape).reshape(-1, 3)
            need_f = None if need is None else need[..., None].expand(dist.shape).reshape(-1)
            sh = shadow_factor(scene, ro_f, ld.reshape(-1, 3), dist.reshape(-1), textures,
                               one_side_planes, table, need_f).reshape(dist.shape)
        lc = lc * torch.maximum((1.0 - sh)[..., None], scene.shadow_ambient)
    diffuse = (lc * mat_color[..., None, :] * mat_diffuse[..., None, None] * w).sum(-2)
    spec_dp = torch.clamp((rd[..., None, :] * reflect(ld, normal[..., None, :])).sum(-1), 0.0, 1.0)
    spec = torch.where(mat_specular[..., None] > 0, _spec_pow(spec_dp, mat_specular[..., None]),
                       0.0)
    specular = (lc * spec[..., None] * w).sum(-2)
    return ambient + diffuse * mat_kd[..., None] + specular * mat_ks[..., None]
