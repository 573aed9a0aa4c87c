"""Closed-form torus quartic roots and the differentiable torus root
(txr/geometry/torus.py:182-371).

Ferrari: the largest root of the resolvent cubic by Newton from the Lagrange
upper bound, then two quadratics.  A complex pair reports its real part and
its squared imaginary part, which the caller's |imag| ≤ 1e-3 acceptance
(rt.frag:478-486) reads.  Elementwise over tensors of any shape; the CUDA
probe kernel carries the same arithmetic (kernels/csrc/txr_common.cuh).
"""

from __future__ import annotations

import torch

from txr_torch.geometry import quaternion as quat

RESOLVENT_NEWTON_ITERS = 20
POLISH_R = 2       # differentiable Newton steps on the winner


def _resolvent_root(p, qq, r):
    """Largest real root m ≥ 0 of m³ + p·m² + ((p²−4r)/4)·m − q²/8."""
    A2 = p
    A1 = 0.25 * (p * p - 4.0 * r)
    A0 = -0.125 * qq * qq
    cbrt = torch.pow(torch.clamp(A0.abs(), min=1e-30), 1.0 / 3.0)
    m = 2.0 * torch.maximum(A2.abs(), torch.maximum(torch.sqrt(A1.abs()), cbrt)) + 1e-6
    for _ in range(RESOLVENT_NEWTON_ITERS):
        f = ((m + A2) * m + A1) * m + A0
        fp = (3.0 * m + 2.0 * A2) * m + A1
        ok = fp.abs() > 1e-20
        m = m - torch.where(ok, f / torch.where(ok, fp, 1.0), 0.0)
    return torch.clamp(m, min=0.0)


def ferrari_roots_tuple(c4, c3, c2, c1, c0):
    """The four roots of c4 t⁴ + … + c0 as ((re, im²) × 4)."""
    inv4 = 1.0 / torch.where(c4.abs() > 1e-20, c4, 1e-20)
    a = c3 * inv4
    b = c2 * inv4
    c = c1 * inv4
    d = c0 * inv4
    # depressed quartic y⁴ + p y² + q y + r, t = y − a/4
    a2 = a * a
    p = b - 0.375 * a2
    qq = c - 0.5 * a * b + 0.125 * a2 * a
    r = d - 0.25 * a * c + 0.0625 * a2 * b - (3.0 / 256.0) * a2 * a2

    m = _resolvent_root(p, qq, r)
    s = torch.sqrt(torch.clamp(2.0 * m, min=0.0))

    # general split y² ∓ s·y + (p/2 + m ± q/(2s)), and the biquadratic split
    # y² = z±, exact when q = 0; keep whichever reproduces the quartic better
    qs = qq / torch.clamp(2.0 * s, min=1e-12)
    gB1, gC1 = -s, 0.5 * p + m + qs
    gB2, gC2 = s, 0.5 * p + m - qs
    db = torch.sqrt(torch.clamp(0.25 * p * p - r, min=0.0))
    zero = torch.zeros_like(p)
    bB1, bC1 = zero, 0.5 * p + db
    bB2, bC2 = zero, 0.5 * p - db

    def split_err(B1, C1, B2, C2):
        return ((C1 + C2 + B1 * B2 - p).abs()
                + (B1 * C2 + B2 * C1 - qq).abs()
                + (C1 * C2 - r).abs() / (1.0 + p.abs()))

    use_biquad = split_err(bB1, bC1, bB2, bC2) < split_err(gB1, gC1, gB2, gC2)
    B1 = torch.where(use_biquad, bB1, gB1)
    C1 = torch.where(use_biquad, bC1, gC1)
    B2 = torch.where(use_biquad, bB2, gB2)
    C2 = torch.where(use_biquad, bC2, gC2)

    def quad(B, C):
        D = B * B - 4.0 * C
        sqD = torch.sqrt(torch.clamp(D, min=0.0))
        re1 = 0.5 * (-B - sqD)
        re2 = 0.5 * (-B + sqD)
        rec = -0.5 * B
        im_sq = torch.clamp(-D, min=0.0) * 0.25
        cplx = D < 0.0
        return (torch.where(cplx, rec, re1), torch.where(cplx, im_sq, 0.0),
                torch.where(cplx, rec, re2), torch.where(cplx, im_sq, 0.0))

    r1, i1, r2, i2 = quad(B1, C1)
    r3, i3, r4, i4 = quad(B2, C2)
    off = 0.25 * a
    return ((r1 - off, i1), (r2 - off, i2), (r3 - off, i3), (r4 - off, i4))


def newton_refine_factored(ts, o, d, R2, r2, steps):
    """Newton steps on the same quartic in its factored form
    f(t) = (|p|² + R² − r²)² − 4R²(px² + py²), p = o + t·d, skipped where
    |f'| ≤ 1e-6.  Near the tube p is O(R) while the expanded coefficients
    grow with |o|⁴, so this form keeps f accurate in f32 where the
    expanded one loses the root to cancellation (≈1e-3 relative at a
    distance of 13, as large as the shadow-ray bias)."""
    ox, oy, oz = o
    dx, dy, dz = d
    for _ in range(steps):
        px, py, pz = ox + dx * ts, oy + dy * ts, oz + dz * ts
        s = px * px + py * py + pz * pz + R2 - r2
        rho = px * dx + py * dy
        f = s * s - 4.0 * R2 * (px * px + py * py)
        fp = 4.0 * s * (rho + pz * dz) - 8.0 * R2 * rho
        ok = fp.abs() > 1e-6
        ts = ts - torch.where(ok, f / torch.where(ok, fp, 1.0), 0.0)
    return ts


def _newton_refine(ts, coeffs, steps):
    """Newton steps on the quartic, skipped where |f'| ≤ 1e-6 (a tangent
    root, where a step would jump far)."""
    c4, c3, c2, c1, c0 = coeffs
    for _ in range(steps):
        f = (((c4 * ts + c3) * ts + c2) * ts + c1) * ts + c0
        fp = ((4.0 * c4 * ts + 3.0 * c3) * ts + 2.0 * c2) * ts + c1
        ok = fp.abs() > 1e-6
        ts = ts - torch.where(ok, f / torch.where(ok, fp, 1.0), 0.0)
    return ts


def torus_solve(lo, ld, R, r):
    """The uncut Ferrari test on a local-frame ray, lo and ld (x, y, z)
    tuples → (t, hit): the nearest root with the reference's DK acceptance
    (rt.frag:478-486: |imag| ≤ 1e-3, real ≥ 0, 0 < t < 100), each real
    root first refined by two Newton steps on the expanded quartic, the
    winner polished on the factored one.  The probe and nearest-hit twins
    call it with float32 scalar R, r; ``torus_t`` with tensors."""
    ox, oy, oz = lo
    dx, dy, dz = ld
    A = dx * dx + dy * dy + dz * dz
    Bq = 2.0 * (ox * dx + oy * dy + oz * dz)
    R2 = R * R
    Cq = ox * ox + oy * oy + oz * oz + R2 - r * r
    a2 = dx * dx + dy * dy
    b2 = 2.0 * (ox * dx + oy * dy)
    c2 = ox * ox + oy * oy
    coeffs = (
        A * A,
        2.0 * A * Bq,
        Bq * Bq + 2.0 * A * Cq - 4.0 * R2 * a2,
        2.0 * Bq * Cq - 4.0 * R2 * b2,
        Cq * Cq - 4.0 * R2 * c2,
    )
    best = torch.full_like(ox, 1e4)
    for rr, ri2 in ferrari_roots_tuple(*coeffs):
        rr = torch.where(ri2 > 0.0, rr, _newton_refine(rr, coeffs, 2))
        good = (ri2 <= 1e-6) & (rr >= 0.0)
        best = torch.minimum(best, torch.where(good, rr, 1e4))
    hit = (best > 0.0) & (best < 100.0)
    # the winner's polish runs on the factored quartic (torus.py docstring)
    t = newton_refine_factored(torch.where(hit, best, 0.0), (ox, oy, oz), (dx, dy, dz),
                               R2, r * r, 2)
    return t, hit


def torus_t(ro, rd, pos, q, form):
    """Nearest accepted root of each ray on each torus (torus.py:305):
    ro, rd [R, 3]; pos [P, 3], q [P, 4], form [P, 2] (R, r) → t [R, P],
    +inf on a miss.  The root is ``torus_solve``'s, found without a
    gradient; autograd sees ``torus_polish_t``'s implicit-function
    gradient, as in the JAX package."""
    ro, rd = ro[..., None, :], rd[..., None, :]
    with torch.no_grad():
        lo, ld = quat.rotate(q, ro - pos), quat.rotate(q, rd)
        t0, hit = torus_solve(lo.unbind(-1), ld.unbind(-1), form[..., 0], form[..., 1])
    return torus_polish_t(ro, rd, pos, q, form, torch.where(hit, t0, float("inf")))


def torus_polish_t(ro, rd, pos, q, form, t0):
    """Differentiable t of an already-found torus root (torus.py:338-355):
    POLISH_R Newton steps from the detached sweep root ``t0`` (+inf on a
    miss), so autograd sees only the implicit-function gradient
    −(∂f/∂θ)/(∂f/∂t).  The steps run on the factored quartic, as the sweeps
    do (``newton_refine_factored``), so the recompute lands where the sweep's
    root did; the implicit gradient of that root is the JAX package's in
    exact arithmetic.  Every argument is per ray, [R, ...]."""
    rol = quat.rotate(q, ro - pos)
    rdl = quat.rotate(q, rd)
    R, r = form[..., 0], form[..., 1]
    hit = torch.isfinite(t0)
    ts = newton_refine_factored(torch.where(hit, t0.detach(), 0.0), rol.unbind(-1),
                                rdl.unbind(-1), R * R, r * r, POLISH_R)
    return torch.where(hit, ts, float("inf"))


def torus_normal(ro, rd, t, pos, q, form):
    """Gradient normal p·(|p|² − r² − R²·(1, 1, −1)) in the torus frame,
    rotated back (rt.frag:488-496); one primitive per ray."""
    p = quat.rotate(q, ro - pos) + quat.rotate(q, rd) * t[..., None]
    R, r = form[..., 0], form[..., 1]
    k = (p * p).sum(-1) - r * r
    R2 = R * R
    n = quat.rotate(quat.inv(q), p * torch.stack([k - R2, k - R2, k + R2], dim=-1))
    return n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-30)
