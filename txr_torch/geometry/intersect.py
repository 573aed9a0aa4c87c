"""Batched differentiable ray–primitive tests (txr/geometry/intersect.py:30-278).

Rays are [R, 3], primitives batched over P; each ``*_t`` returns t [R, P]
with +inf on a miss.  Every test guards its square roots and divisions
with the double-where pattern, so autograd never sees NaN or inf from a
lane that a ``where`` discards.  The winner's t is smooth in every
primitive parameter away from silhouettes.  The CUDA sweeps and their
twins (kernels/) find the winner; these functions are what autograd
differentiates, one winning primitive per ray (render/intersect.py).
"""

from __future__ import annotations

import torch

from txr_torch.geometry import quaternion as quat
from txr_torch.geometry.torus import torus_normal, torus_polish_t  # noqa: F401

INF = float("inf")
MAX_DIST = 1.0e6   # maxDist, rt.frag:145


def _dot(a, b):
    return (a * b).sum(-1)


def safe_sqrt(x, valid, eps=1e-12):
    """sqrt(x) where valid, 0 elsewhere, gradient-safe.  Valid lanes floor
    the argument at ``eps``: an exactly tangent ray has an infinite true
    derivative, which would poison every gradient of the frame."""
    return torch.where(valid, torch.sqrt(torch.clamp(torch.where(valid, x, 1.0), min=eps)), 0.0)


def safe_normalize(v, eps=1e-30):
    """v/|v| with a finite backward at v = 0."""
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + eps)


def safe_div(num, den, valid, fallback=0.0):
    """num/den where valid, ``fallback`` elsewhere, gradient-safe."""
    return torch.where(valid, num / torch.where(valid, den, 1.0), fallback)


def sphere_t(ro, rd, pos, radius, hollow):
    """Half-b quadratic; hollow spheres take the far root from inside
    (rt.frag:342-354).  ro, rd [R,3]; pos [P,3]; radius, hollow [P]."""
    oc = ro[..., None, :] - pos
    b = _dot(oc, rd[..., None, :])
    c = _dot(oc, oc) - radius * radius
    h = b * b - c
    has_root = h >= 0.0
    hs = safe_sqrt(h, has_root)
    t_near = -b - hs
    t = torch.where(hollow & (t_near < 0.0), -b + hs, t_near)
    return torch.where(has_root & (t > 0.0), t, INF)


def sphere_normal(pt, pos):
    """normalize(pt − centre), rt.frag:748."""
    return safe_normalize(pt - pos)


def plane_t(ro, rd, pos, normal, one_side=True):
    """One-sided by default: a hit needs denom < −1e-6 (rt.frag:356-370)."""
    denom = torch.clamp(_dot(normal, rd[..., None, :]), -1.0, 1.0)
    facing = denom < -1e-6 if one_side else denom.abs() > 1e-6
    t = safe_div(_dot(pos - ro[..., None, :], normal), denom, facing, INF)
    return torch.where(facing & (t > 0.0), t, INF)


def ring_t(ro, rd, pos, q, r1, r2):
    """The z = 0 plane of the ring frame, radii² in (r1, r2)
    (rt.frag:372-397; radii stored squared)."""
    rdl = quat.rotate(q, rd[..., None, :])
    rol = quat.rotate(q, ro[..., None, :] - pos)
    nz = rdl[..., 2] != 0.0
    t = safe_div(-rol[..., 2], rdl[..., 2], nz, INF)
    x = rol[..., 0] + rdl[..., 0] * t
    y = rol[..., 1] + rdl[..., 1] * t
    p = x * x + y * y
    hit = (t > 0.0) & (p < r2) & (p > r1) & nz
    return torch.where(hit, t, INF)


def ring_uv(ro, rd, t, pos, q, r1, r2):
    """u = (|xy|² − r1)/(r2 − r1), v = cos θ (rt.frag:385-386); one
    primitive per ray, every argument [R, ...]."""
    rdl = quat.rotate(q, rd)
    rol = quat.rotate(q, ro - pos)
    x = rol[..., 0] + rdl[..., 0] * t
    y = rol[..., 1] + rdl[..., 1] * t
    p = x * x + y * y
    return torch.stack([(p - r1) / (r2 - r1), x / torch.sqrt(torch.clamp(p, min=1e-20))], dim=-1)


def ring_normal(q):
    """rotate(inv(q), (0, 0, −1)), rt.frag:391-394."""
    z = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    z[..., 2] = -1.0
    return quat.rotate(quat.inv(q), z)


def _safe_recip(v, big=1.0e30):
    """1/v with exact zeros mapped to a huge same-sign value: sign / max(|v|,
    1/big), as txr/geometry/intersect.py computes it.  The lanes below 1/big
    divide by a constant, so the backward makes no 0·inf (a NaN that the
    max's backward would drop, but that autograd's anomaly check reports)."""
    a = v.abs()
    small = a < 1.0 / big
    sign = torch.where(v >= 0.0, 1.0, -1.0)
    return torch.where(small, sign / torch.full_like(a, 1.0 / big),
                       sign / torch.where(small, 1.0, a))


def box_t(ro, rd, pos, q, form):
    """Slab test in the box frame; a ray from inside reports a negative t,
    as the reference does (rt.frag:399-427)."""
    rdl = quat.rotate(q, rd[..., None, :])
    rol = quat.rotate(q, ro[..., None, :] - pos)
    m = _safe_recip(rdl)
    n = m * rol
    k = m.abs() * form
    tN = (-n - k).amax(-1)
    tF = (-n + k).amin(-1)
    return torch.where((tN <= tF) & (tF >= 0.0), tN, INF)


def box_normal(ro, rd, pos, q, form):
    """Face normal by the slab argmax (rt.frag:422), back in world space."""
    rdl = quat.rotate(q, rd)
    rol = quat.rotate(q, ro - pos)
    m = _safe_recip(rdl)
    t1 = -(m * rol) - m.abs() * form
    ge1 = (t1 >= torch.roll(t1, -1, dims=-1)).to(t1.dtype)
    ge2 = (t1 >= torch.roll(t1, -2, dims=-1)).to(t1.dtype)
    return quat.rotate(quat.inv(q), -torch.sign(rdl) * ge1 * ge2)


def surface_t(ro, rd, pos, q, coef, v_min, v_max):
    """Quadric a·x²+b·y²+c·z²+d·z+e·y+f = 0 in the rotated local frame with
    the world-space clip box (rt.frag:499-585): a near root outside the box
    swaps to the far root.  |p2| < 1e-6 is a miss (the reference compares
    against the running minimum there, a measure-zero fault)."""
    rdl = quat.rotate(q, rd[..., None, :])
    rol = quat.rotate(q, ro[..., None, :] - pos)
    a, b, c, d, e, f = coef.unbind(-1)
    d1, d2, d3 = rdl.unbind(-1)
    o1, o2, o3 = rol.unbind(-1)
    p1 = 2 * a * d1 * o1 + 2 * b * d2 * o2 + 2 * c * d3 * o3 + d * d3 + d2 * e
    p2 = a * d1 * d1 + b * d2 * d2 + c * d3 * d3
    p3 = a * o1 * o1 + b * o2 * o2 + c * o3 * o3 + d * o3 + e * o2 + f
    disc = p1 * p1 - 4.0 * p2 * p3
    ok = (disc >= 0.0) & (p2.abs() >= 1e-6)
    p4 = safe_sqrt(disc, ok)
    inv2p2 = safe_div(1.0, 2.0 * p2, ok)
    t1 = (-p1 - p4) * inv2p2
    t2 = (-p1 + p4) * inv2p2
    eps = 1e-4
    t1_ok, t2_ok = t1 > eps, t2 > eps
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    near = torch.where(t1_ok & t2_ok, lo, torch.where(t1_ok, t1, torch.where(t2_ok, t2, INF)))
    far = torch.where(t1_ok & t2_ok, hi, torch.where(t1_ok, t2, torch.where(t2_ok, t1, INF)))

    def between(t):
        pt = ro[..., None, :] + rd[..., None, :] * t[..., None]
        return ((pt > v_min) & (pt < v_max)).all(-1)

    near_fin = torch.isfinite(near)
    near_in = near_fin & between(torch.where(near_fin, near, 0.0))
    far_fin = torch.isfinite(far)
    far_in = (far >= eps) & far_fin & between(torch.where(far_fin, far, 0.0))
    t = torch.where(near_in, near, torch.where(far_in, far, INF))
    return torch.where(ok, t, INF)


def surface_normal(ro, rd, t, pos, q, coef):
    """Analytic gradient (2a·x, 2b·y+e, 2c·z+d) in the local frame, rotated
    back (rt.frag:573-584); one primitive per ray."""
    tm = quat.rotate(q, ro - pos) + quat.rotate(q, rd) * t[..., None]
    a, b, c, d, e = coef[..., 0], coef[..., 1], coef[..., 2], coef[..., 3], coef[..., 4]
    n = torch.stack([2 * a * tm[..., 0], 2 * b * tm[..., 1] + e, 2 * c * tm[..., 2] + d], dim=-1)
    return safe_normalize(quat.rotate(quat.inv(q), n))
