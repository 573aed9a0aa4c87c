"""Per-primitive ray tests, plain PyTorch (txr/kernels/pallas_intersect.py:41-210).

The probe kernel's twin calls these once per primitive, as the Pallas body
unrolls them: ``ro``/``rd`` are (x, y, z) tuples of [N] tensors, primitive
parameters are float32 scalars (numpy tables indexed by ``i``), so scalar
arithmetic rounds in float32 as it does in the kernel.  Each test returns
(t, hit).  The CUDA device functions in ``csrc/txr_common.cuh`` carry the
same arithmetic in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from txr_torch.geometry.torus import torus_solve

BIG = 1.0e30
INF_T = 3.0e38       # stand-in for +inf inside the kernel (f32 finite)
# the torus's bounding-sphere cull (_torus_culled; txr_common.cuh carries the
# same float32 constants): the sphere's radius is (R + r)·TORUS_CULL_RHO, and
# its square grows by TORUS_CULL_K·|lo|⁴/(R·r), a margin over the float32
# solve's false hits on near-tangent rays from afar.  tests/test_torch_lanes.py
# holds the cut test to the uncut one on near-tangent rays out to 150 units,
# chip_smoke.py on every ray of a 1080p frame
TORUS_CULL_RHO = np.float32(1.001)
TORUS_CULL_K = np.float32(2.0e-6)


def _rot(q, v):
    """Reference rotate(): (w²−|qv|²)v + 2(qv·v)qv + 2w(qv×v)."""
    qx, qy, qz, qw = q
    vx, vy, vz = v
    dot = qx * vx + qy * vy + qz * vz
    cx = qy * vz - qz * vy
    cy = qz * vx - qx * vz
    cz = qx * vy - qy * vx
    k = qw * qw - (qx * qx + qy * qy + qz * qz)
    return (
        k * vx + 2.0 * dot * qx + 2.0 * qw * cx,
        k * vy + 2.0 * dot * qy + 2.0 * qw * cy,
        k * vz + 2.0 * dot * qz + 2.0 * qw * cz,
    )


def _conj(q):
    qx, qy, qz, qw = q
    return (-qx, -qy, -qz, qw)


def _safe_recip(v):
    return torch.where(v >= 0.0, 1.0, -1.0) / torch.clamp(v.abs(), min=1.0 / BIG)


def _plane_test(ppos, pnrm, i, ro, rd, one_side):
    """rt.frag:356-370."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    nx, ny, nz = pnrm[i, 0], pnrm[i, 1], pnrm[i, 2]
    px, py, pz = ppos[i, 0], ppos[i, 1], ppos[i, 2]
    denom = torch.clamp(nx * rdx + ny * rdy + nz * rdz, -1.0, 1.0)
    facing = denom < -1e-6 if one_side else denom.abs() > 1e-6
    num = (px - rox) * nx + (py - roy) * ny + (pz - roz) * nz
    t = num / torch.where(facing, denom, 1.0)
    return t, facing & (t > 0.0)


def _sphere_test(cx, cy, cz, rad, hol, ro, rd):
    """rt.frag:342-354.  hol: the hollow flag (a bool, or a bool tensor
    that broadcasts with the rays), or None = never hollow (shadow rays and
    light bulbs test spheres solid).  Elementwise: centres and radii may be
    [K] against rays of [N, 1], every pair rounded as one at a time."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    ocx, ocy, ocz = rox - cx, roy - cy, roz - cz
    b = ocx * rdx + ocy * rdy + ocz * rdz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    h = b * b - c
    has = h >= 0.0
    hs = torch.sqrt(torch.where(has, h, 0.0))
    t = -b - hs
    if isinstance(hol, torch.Tensor):
        t = torch.where(hol & (t < 0.0), -b + hs, t)
    elif hol:
        t = torch.where(t < 0.0, -b + hs, t)
    return t, has & (t > 0.0)


def _surface_test(upos, uquat, ucoef, umin, umax, i, ro, rd):
    """rt.frag:499-585 incl. the world-space clip box."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    q = tuple(uquat[i, j] for j in range(4))
    ox, oy, oz = _rot(q, (rox - upos[i, 0], roy - upos[i, 1], roz - upos[i, 2]))
    dx, dy, dz = _rot(q, rd)
    a, b, c, d, e, f = (ucoef[i, j] for j in range(6))
    p1 = 2 * a * dx * ox + 2 * b * dy * oy + 2 * c * dz * oz + d * dz + dy * e
    p2 = a * dx * dx + b * dy * dy + c * dz * dz
    p3 = a * ox * ox + b * oy * oy + c * oz * oz + d * oz + e * oy + f
    disc = p1 * p1 - 4.0 * p2 * p3
    ok = (disc >= 0.0) & (p2.abs() >= 1e-6)
    p4 = torch.sqrt(torch.where(ok, disc, 0.0))
    inv2p2 = torch.where(ok, 1.0, 0.0) / torch.where(ok, 2.0 * p2, 1.0)
    t1 = (-p1 - p4) * inv2p2
    t2 = (-p1 + p4) * inv2p2
    eps = 1e-4
    t1ok = t1 > eps
    t2ok = t2 > eps
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    both = t1ok & t2ok
    near = torch.where(both, lo, torch.where(t1ok, t1, torch.where(t2ok, t2, INF_T)))
    far = torch.where(both, hi, torch.where(t1ok, t2, torch.where(t2ok, t1, INF_T)))

    def between(t):
        wx = rox + rdx * t
        wy = roy + rdy * t
        wz = roz + rdz * t
        return ((wx > umin[i, 0]) & (wx < umax[i, 0]) & (wy > umin[i, 1])
                & (wy < umax[i, 1]) & (wz > umin[i, 2]) & (wz < umax[i, 2]))

    near_fin = near < INF_T
    near_in = near_fin & between(torch.where(near_fin, near, 0.0))
    far_ok = (far >= eps) & (far < INF_T)
    far_in = far_ok & between(torch.where(far_ok, far, 0.0))
    t = torch.where(near_in, near, torch.where(far_in, far, INF_T))
    return t, ok & (t < INF_T)


def _box_test(bpos, bquat, bform, i, ro, rd):
    """rt.frag:399-427 (iq slab test; tN may be negative inside — parity)."""
    q = tuple(bquat[i, j] for j in range(4))
    ox, oy, oz = _rot(q, (ro[0] - bpos[i, 0], ro[1] - bpos[i, 1], ro[2] - bpos[i, 2]))
    dx, dy, dz = _rot(q, rd)
    mx, my, mz = _safe_recip(dx), _safe_recip(dy), _safe_recip(dz)
    nx, ny, nz = mx * ox, my * oy, mz * oz
    kx = mx.abs() * bform[i, 0]
    ky = my.abs() * bform[i, 1]
    kz = mz.abs() * bform[i, 2]
    tN = torch.maximum(torch.maximum(-nx - kx, -ny - ky), -nz - kz)
    tF = torch.minimum(torch.minimum(-nx + kx, -ny + ky), -nz + kz)
    return tN, (tN <= tF) & (tF >= 0.0)


def _torus_local(tpos, tquat, i, ro, rd):
    """The ray in torus i's local frame: ((ox, oy, oz), (dx, dy, dz))."""
    q = tuple(tquat[i, j] for j in range(4))
    return (_rot(q, (ro[0] - tpos[i, 0], ro[1] - tpos[i, 1], ro[2] - tpos[i, 2])),
            _rot(q, rd))


def _torus_culled(lo, ld, R, r):
    """Lanes whose line misses the torus's inflated bounding sphere, which
    the Ferrari solve would reject too: |lo + t·ld|² > ρ² for every real t,
    ρ² = ((R + r)·TORUS_CULL_RHO)² + TORUS_CULL_K·|lo|⁴ / (R·r).  The
    second term covers the float32 solve's false hits on near-tangent rays
    from afar, whose error grows as |lo|⁴; a line, not a ray, since the
    solve also accepts roots of some rays that leave the sphere."""
    ox, oy, oz = lo
    dx, dy, dz = ld
    c0 = ox * ox + oy * oy + oz * oz
    hb = ox * dx + oy * dy + oz * dz
    A = dx * dx + dy * dy + dz * dz
    rb = (R + r) * TORUS_CULL_RHO
    rho2 = rb * rb + TORUS_CULL_K * (c0 * c0) / max(abs(R * r), np.float32(1e-12))
    return hb * hb < A * (c0 - rho2)


def _torus_test(tpos, tquat, tform, i, ro, rd):
    """Ferrari closed-form quartic with the reference's DK acceptance
    (rt.frag:478-486): |imag| ≤ 1e-3, real ≥ 0, 0 < t < 100.  The accepted
    root is polished on the factored quartic, not the expanded one.  Lanes
    that ``_torus_culled`` rejects report no hit (the kernel skips their
    solve; here it runs on every lane and is masked)."""
    lo, ld = _torus_local(tpos, tquat, i, ro, rd)
    t, hit = torus_solve(lo, ld, tform[i, 0], tform[i, 1])
    return t, hit & ~_torus_culled(lo, ld, tform[i, 0], tform[i, 1])


def _ring_test(rpos, rquat, rr1, rr2, i, ro, rd):
    """rt.frag:372-390.  Also returns the in-plane hit coords (x, y) and the
    radius² p for the ring UV."""
    q = tuple(rquat[i, j] for j in range(4))
    ox, oy, oz = _rot(q, (ro[0] - rpos[i, 0], ro[1] - rpos[i, 1], ro[2] - rpos[i, 2]))
    dx, dy, dz = _rot(q, rd)
    nzero = dz != 0.0
    t = -oz / torch.where(nzero, dz, 1.0)
    x = ox + dx * t
    y = oy + dy * t
    p = x * x + y * y
    hit = (t > 0.0) & (p < rr2[i]) & (p > rr1[i]) & nzero
    return t, hit, x, y, p
