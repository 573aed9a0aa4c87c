"""The benchmark's plain reference renderer: float64 PyTorch, batched over
rays, differentiable by autograd.

It follows the reference shader's math (rt.frag) as the JAX package's
scalar oracle writes it out (txr/ref/cpu_reference.py, frozen here as
batched tensor code): the same intersectors, the same slot order and
strict ``<`` for the nearest hit, the same shading, Fresnel, refraction,
Beer absorption, glossy pass, texture LOD policy (ray-footprint mip level,
trilinear over a 2×2-box-filtered RGBA8 pyramid, REPEAT wrap), cubemap and
edge AA.  The shared decisions where the shader is undefined are the
oracle's: a degenerate quadric direction misses, a missed glossy ray is
black, refraction steps are bounded by ``iterations +
extra_refraction_steps``.

For the gradient it takes the program's documented choices of what is
piecewise constant and so detached: the winner of each nearest-hit search
(its t is recomputed differentiably from the winning primitive; a torus
root by one Newton step from the solved root, the implicit derivative),
every shadow query, and the edge-AA pixel choice.

Every nearest-hit and shadow sweep tests one primitive type at a time, in
blocks of rays × primitives (at most ``PAIR_BLOCK`` pairs), with the same
per-pair formulas as a sweep over the primitives one by one and the same
result: the first slot wins an exact tie, as the sequential ``t < tmin``
gives.  Rings' shadow alpha is added ring by ring, in ring order.

It imports nothing of the program and nothing of JAX.  Runs on any device
and in any float dtype: float64 is the reference; a lower dtype is the
precision control (the torus's root search then runs in complex64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench import scenedata

MAX_DIST = 1.0e6
PI = 3.14159265358979
T_SPHERE, T_PLANE, T_SURFACE, T_BOX, T_TORUS, T_RING, T_LIGHT = range(7)
# the nearest-hit sweep's order (rt.frag:587-628) and each type's number
SWEEP = (("planes", T_PLANE), ("spheres", T_SPHERE), ("surfaces", T_SURFACE),
         ("boxes", T_BOX), ("toruses", T_TORUS), ("rings", T_RING))
# the slots: the sweep's surfaces, then the point lights its nearest hit tests
SLOT_KINDS = tuple(k for k, _ in SWEEP) + ("lights_point",)
TYPE_OF = dict(SWEEP, lights_point=T_LIGHT)
# each type's parameters, in the order the intersectors take them
PARAMS = dict(planes=("pos", "normal"), spheres=("pos", "radius"),
              surfaces=("pos", "quat", "coef", "v_min", "v_max"), boxes=("pos", "quat", "form"),
              toruses=("pos", "quat", "form"), rings=("pos", "quat", "r1", "r2"),
              lights_point=("pos", "radius"))
MAT_FIELDS = ("color", "absorb", "diffuse", "reflect", "refract", "specular", "kd", "ks")
MIP_MIN_SIZE = 4
LOD_COS_MIN = 0.125
LOD_EPS = 1.0 / 1024.0
# a torus's bounding sphere, shrunk as the work model prices it (work/)
CROSS_SHRINK = 1.0 - 1e-4
# rays whose line passes within this factor of a torus's R + r are solved
TORUS_CULL = 1.001
# (ray, primitive) pairs a sweep tests at once: bounds its [rays,
# primitives, 3] temporaries (50 MB each in float64)
PAIR_BLOCK = 1 << 21


@dataclasses.dataclass(frozen=True)
class Settings:
    width: int
    height: int
    iterations: int = 5
    extra_refraction_steps: int = 6
    supersample: int = 1
    aa_edge: bool = False
    edge_threshold: float = 0.02
    edge_budget_mult: int = 20
    texture_lod: bool = True
    shadow_enabled: bool = True
    do_fresnel: bool = True
    total_internal_reflection: bool = True
    plane_oneside: bool = True
    reflect_reduce_iteration: bool = True
    refractive_glossy: bool = True

    @property
    def max_steps(self):
        return self.iterations + (self.extra_refraction_steps
                                  if self.reflect_reduce_iteration else 0)


AA_PRESETS = {"off": 1, "low": 1, "medium": 2, "high": 3, "ultra": 4}


def settings(cfg, width=None, height=None):
    """The configuration's render settings (``render`` section), at
    another size if given."""
    r = cfg["render"]
    preset = r.get("aa_preset")
    k = AA_PRESETS[preset] if preset else 1
    return Settings(width=width or r["width"], height=height or r["height"],
                    iterations=r["iterations"], extra_refraction_steps=r["extra_refraction_steps"],
                    supersample=k, aa_edge=k > 1, edge_threshold=r["edge_threshold"],
                    edge_budget_mult=r["edge_budget_mult"], texture_lod=r["texture_lod"])


# -- small math ----------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def sqrt(x):
    """√x with x floored at the dtype's least normal number: the same value
    wherever x > 0, and a finite derivative where x is 0 (which a lower
    precision meets on real rays)."""
    return torch.sqrt(torch.clamp(x, min=torch.finfo(x.dtype).tiny))


def nrm(v):
    n = sqrt(dot(v, v))[..., None]
    return torch.where(n > torch.finfo(v.dtype).tiny, v / n, v)


def qconj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def qinv(q):
    return qconj(q) / dot(q, q)[..., None]


def qmul(a, b):
    x1, y1, z1, w1 = a.unbind(-1)
    x2, y2, z2, w2 = b.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def rot(q, v):
    """q · (v, 0) · conj(q), the shader's rotate (non-unit q scales)."""
    q = q.expand(v.shape[:-1] + (4,))
    v4 = torch.cat([v, torch.zeros_like(v[..., :1])], -1)
    return qmul(qmul(q, v4), qconj(q))[..., :3]


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    out = eta[..., None] * i - (eta * cosi + sqrt(k))[..., None] * n
    return torch.where((k < 0)[..., None], torch.zeros_like(out), out)


# -- scene ----------------------------------------------------------------------

class Scene:
    """The configuration's scene at time ``t`` as tensors of ``dtype`` on
    ``device``: ``leaves`` maps the scene's dotted float-leaf paths
    ("spheres.pos", "spheres.mat.color", ...) to tensors; every number is
    the configuration's, rounded to float32 as the program is handed it,
    and the animated positions are worked out from ``t`` in float64.
    ``requires_grad`` makes every leaf a gradient leaf."""

    def __init__(self, cfg, t, dtype=torch.float64, device="cpu", requires_grad=False):
        rows = scenedata.scene_rows(cfg)
        posed = scenedata.posed_positions(cfg, rows, t)
        f32 = scenedata.as_float32
        self.dtype, self.device = dtype, torch.device(device)
        ten = lambda a, shape: torch.from_numpy(f32(np.asarray(a, np.float64)).reshape(shape)).to(
            self.device, dtype)
        L = {"camera.pos": ten(rows["camera"]["pos"], (3,)),
             "camera.quat": ten(rows["camera"]["quat"], (4,)),
             "ambient_color": ten(rows["ambient_color"], (3,)),
             "shadow_ambient": ten(rows["shadow_ambient"], (3,)),
             "bg_color": ten(rows["bg_color"], (3,))}
        fields = dict(spheres=(("pos", 3), ("radius", None), ("quat", 4)),
                      planes=(("pos", 3), ("normal", 3)),
                      surfaces=(("pos", 3), ("quat", 4), ("coef", 6), ("v_min", 3), ("v_max", 3)),
                      boxes=(("pos", 3), ("quat", 4), ("form", 3)),
                      toruses=(("pos", 3), ("quat", 4), ("form", 2)),
                      rings=(("pos", 3), ("quat", 4), ("r1", None), ("r2", None)))
        self.count, self.texture, self.hollow = {}, {}, {}
        for kind, fl in fields.items():
            rs = rows[kind]
            self.count[kind] = len(rs)
            self.texture[kind] = [r["texture"] for r in rs]
            self.hollow[kind] = [r["hollow"] for r in rs]
            for name, w in fl:
                vals = [np.asarray(posed[(kind, i)] if name == "pos" and (kind, i) in posed
                                   else f32(r[name]), np.float64).reshape(-1)
                        for i, r in enumerate(rs)]
                shape = (len(rs),) if w is None else (len(rs), w)
                arr = np.stack(vals).reshape(shape) if vals else np.zeros(shape)
                L[f"{kind}.{name}"] = torch.from_numpy(arr).to(self.device, dtype)
            for m in MAT_FIELDS:
                shape = (len(rs), 3) if m in ("color", "absorb") else (len(rs),)
                L[f"{kind}.mat.{m}"] = ten([r["mat"][m] for r in rs], shape)
        for kind, fl in (("lights_point", ("pos", "radius", "color", "intensity", "linear_k",
                                           "quadratic_k")),
                         ("lights_direct", ("direction", "color", "intensity"))):
            rs = rows[kind]
            self.count[kind] = len(rs)
            for name in fl:
                shape = (len(rs), 3) if name in ("pos", "color", "direction") else (len(rs),)
                L[f"{kind}.{name}"] = ten([r[name] for r in rs], shape)
        if requires_grad:
            L = {k: v.requires_grad_(True) for k, v in L.items()}
        self.leaves = L
        self.hollow_mask = {kind: torch.tensor(self.hollow[kind], dtype=torch.bool,
                                               device=self.device) for kind in fields}
        # every slot's number, in the sweep's type order: the surfaces (their
        # material rows), then the point lights
        self.slot0, off = {}, 0
        for kind in SLOT_KINDS:
            self.slot0[kind] = off
            off += self.count[kind]
        self.n_lights = self.count["lights_point"] + self.count["lights_direct"]

    def __getitem__(self, path):
        return self.leaves[path]

    def mat_table(self):
        """{field: [slots, ...]} of every surface slot's material."""
        return {m: torch.cat([self[f"{k}.mat.{m}"] for k, _ in SWEEP]) for m in MAT_FIELDS}

    def slot_of(self, typ, num):
        base = torch.zeros(8, dtype=torch.int64, device=self.device)
        for kind in SLOT_KINDS:
            base[TYPE_OF[kind]] = self.slot0[kind]
        return base[typ.clamp(min=0)] + num


# -- textures -------------------------------------------------------------------

def quantize_u8(x):
    """RGBA8 storage: round half to even of x·255 over 255."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


def build_mips(tex):
    """The 2×2 box-filtered pyramid of an RGBA8 level, each level the
    integer-exact (a+b+c+d+2)>>2 of its parent, down to MIP_MIN_SIZE."""
    levels = [tex]
    while True:
        t = levels[-1]
        H, W = t.shape[0], t.shape[1]
        if H % 2 or W % 2 or H // 2 < MIP_MIN_SIZE or W // 2 < MIP_MIN_SIZE:
            return levels
        r = torch.round(t.reshape(H // 2, 2, W // 2, 2, t.shape[-1]) * 255.0).to(torch.int64)
        si = r[:, 0, :, 0] + r[:, 0, :, 1] + r[:, 1, :, 0] + r[:, 1, :, 1]
        levels.append(((si + 2) >> 2).to(t.dtype) / 255.0)


class Texture:
    """One texture's levels in a flat [texels, 4] table, with each level's
    row offset, height and width, and a global id for counting texels."""

    def __init__(self, raw, dtype, mips, tid):
        q = quantize_u8(raw.to(dtype))
        self.levels = build_mips(q) if mips else [q]
        dev = q.device
        self.table = torch.cat([l.reshape(-1, l.shape[-1]) for l in self.levels])
        self.h = torch.tensor([l.shape[0] for l in self.levels], device=dev)
        self.w = torch.tensor([l.shape[1] for l in self.levels], device=dev)
        self.off = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                                           self.h * self.w]), 0)[:-1]
        self.shape0 = (self.levels[0].shape[0], self.levels[0].shape[1])
        self.tid = tid


class Textures:
    """The raw textures of a configuration (``rtbench.textures.make``),
    quantised to RGBA8 and mipmapped here, as the reference's GL upload
    and glGenerateMipmap do; a role the configuration leaves out is
    None (no sphere texture: an empty list)."""

    def __init__(self, cfg, raw, dtype=torch.float64, lod=True):
        names = cfg.get("textures", {})
        self.sphere = [Texture(raw[n], dtype, lod, i)
                       for i, n in enumerate(names.get("sphere", ()))]
        k = len(self.sphere)
        self.ring = Texture(raw[names["ring"]], dtype, lod, k) if names.get("ring") else None
        self.box = Texture(raw[names["box"]], dtype, lod, k + 1) if names.get("box") else None
        self.ring_alpha = (Texture(raw[names["ring"]], dtype, False, k + 2)
                           if names.get("ring") else None)
        self.cubemap = quantize_u8(raw[names["cubemap"]].to(dtype)) if names.get("cubemap") else None


def _wrap(i, n, repeat):
    return torch.remainder(i, n) if repeat else torch.minimum(i.clamp(min=0), n - 1)


def bilinear(table, off, H, W, u, v, repeat=True, keys=None, tid=0):
    """GL bilinear fetch at (u, v) of the H×W image at row ``off`` of a flat
    table (per-ray tensors); with ``keys`` a list, the taps' global keys
    are appended to it."""
    x = u * W.to(u.dtype) - 0.5
    y = v * H.to(u.dtype) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    xa, xb = _wrap(x0, W, repeat), _wrap(x0 + 1, W, repeat)
    ya, yb = _wrap(y0, H, repeat), _wrap(y0 + 1, H, repeat)
    rows = torch.stack([off + ya * W + xa, off + ya * W + xb, off + yb * W + xa, off + yb * W + xb])
    if keys is not None:
        keys.append((rows + (tid << 40)).reshape(-1))
    c00, c01, c10, c11 = table[rows]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def trilinear(tex, u, v, lod, keys=None):
    """textureLod: lod clamped to [0, L − 1 − LOD_EPS], level-0 bilinear
    when ``lod`` is None."""
    if lod is None:
        z = torch.zeros_like(u, dtype=torch.int64)
        return bilinear(tex.table, z + tex.off[0], z + tex.h[0], z + tex.w[0], u, v,
                        keys=keys, tid=tex.tid)
    L = len(tex.levels)
    lod = torch.minimum(torch.clamp(lod, min=0.0),
                        torch.full_like(lod, max(float(L - 1) - LOD_EPS, 0.0)))
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.clamp(l0 + 1, max=L - 1)
    f = (lod - l0.to(lod.dtype))[..., None]
    a = bilinear(tex.table, tex.off[l0], tex.h[l0], tex.w[l0], u, v, keys=keys, tid=tex.tid)
    b = bilinear(tex.table, tex.off[l1], tex.h[l1], tex.w[l1], u, v, keys=keys, tid=tex.tid)
    return a * (1.0 - f) + b * f


def lod_of(texels):
    return torch.log2(torch.clamp(texels, min=1.0))


def footprint(t, cos_in, pix_angle):
    return t * pix_angle / torch.clamp(cos_in, min=LOD_COS_MIN)


def cubemap(cm, d):
    """The environment colour toward d [R, 3]: the GL face rule, level-0
    bilinear, clamp to edge."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    sc = torch.where(is_x, torch.where(x >= 0, -z, z), torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    ma = torch.clamp(ma, min=1e-20)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    S = cm.shape[1]
    n = torch.full_like(face, S)
    return bilinear(cm.reshape(-1, cm.shape[-1]), face * S * S, n, n, u, v, repeat=False)[..., :3]


# -- intersectors: t of each ray against one primitive, +inf on a miss ---------

INF = float("inf")


def _miss(t, ok):
    return torch.where(ok, t, torch.full_like(t, INF))


def sphere_t(ro, rd, pos, radius, hollow):
    """``hollow``: a bool, or a bool tensor of the spheres that are."""
    oc = ro - pos
    b = dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    h = b * b - c
    hs = sqrt(h)
    t = -b - hs
    if torch.is_tensor(hollow) or hollow:
        t = torch.where(hollow & (t < 0), -b + hs, t)
    return _miss(t, (h >= 0) & (t > 0))


def plane_t(ro, rd, n, p, one_side):
    denom = torch.clamp(dot(rd, n), -1.0, 1.0)
    ok = denom < -1e-6 if one_side else denom.abs() > 1e-6
    t = dot(p - ro, n) / torch.where(ok, denom, torch.ones_like(denom))
    return _miss(t, ok & (t > 0))


def _ring_local(ro, rd, pos, q):
    return rot(q, ro - pos), rot(q, rd)


def ring_t(ro, rd, pos, q, r1, r2):
    lo, ld = _ring_local(ro, rd, pos, q)
    ok = ld[..., 2] != 0
    t = -lo[..., 2] / torch.where(ok, ld[..., 2], torch.ones_like(ld[..., 2]))
    x = lo[..., 0] + ld[..., 0] * t
    y = lo[..., 1] + ld[..., 1] * t
    p = x * x + y * y
    return _miss(t, ok & (t > 0) & (p > r1) & (p < r2))


def ring_uv(ro, rd, t, pos, q, r1, r2):
    lo, ld = _ring_local(ro, rd, pos, q)
    x = lo[..., 0] + ld[..., 0] * t
    y = lo[..., 1] + ld[..., 1] * t
    p = x * x + y * y
    return (p - r1) / (r2 - r1), x / torch.clamp(sqrt(p), min=1e-20)


def _box_slabs(ro, rd, pos, q, form):
    rdd = rot(q, rd)
    roo = rot(q, ro - pos)
    mag = torch.clamp(rdd.abs(), min=1e-30)
    m = torch.where(rdd >= 0, 1.0, -1.0).to(rdd.dtype) / mag
    n = m * roo
    k = m.abs() * form
    return rdd, -n - k, -n + k


def box_t(ro, rd, pos, q, form):
    _, t1, t2 = _box_slabs(ro, rd, pos, q, form)
    tN = t1.amax(-1)
    tF = t2.amin(-1)
    return _miss(tN, (tN <= tF) & (tF >= 0))


def box_normal(ro, rd, pos, q, form):
    rdd, t1, _ = _box_slabs(ro, rd, pos, q, form)
    step1 = (t1 >= t1[..., [1, 2, 0]]).to(t1.dtype)
    step2 = (t1 >= t1[..., [2, 0, 1]]).to(t1.dtype)
    return rot(qinv(q), -torch.sign(rdd) * step1 * step2)


def surface_t(ro, rd, pos, q, coef, vmin, vmax):
    lo, ld = rot(q, ro - pos), rot(q, rd)
    a, b, c, d, e, f = coef.unbind(-1)
    d1, d2, d3 = ld.unbind(-1)
    o1, o2, o3 = lo.unbind(-1)
    p1 = 2 * a * d1 * o1 + 2 * b * d2 * o2 + 2 * c * d3 * o3 + d * d3 + d2 * e
    p2 = a * d1 * d1 + b * d2 * d2 + c * d3 * d3
    p3 = a * o1 * o1 + b * o2 * o2 + c * o3 * o3 + d * o3 + e * o2 + f
    disc = p1 * p1 - 4 * p2 * p3
    ok = (p2.abs() >= 1e-6) & (disc >= 0)
    p4 = sqrt(disc)
    den = 2 * torch.where(ok, p2, torch.ones_like(p2))
    t1 = (-p1 - p4) / den
    t2 = (-p1 + p4) / den
    eps = 1e-4
    inf = torch.full_like(t1, INF)
    c1 = t1 > eps
    tn, tf = torch.where(c1, t1, inf), torch.where(c1, t2, inf)
    c2 = (t2 > eps) & (t2 < tn)
    tn, tf = torch.where(c2, t2, tn), torch.where(c2, t1, tf)

    def between(tt):
        fin = torch.isfinite(tt)
        pt = rd * torch.where(fin, tt, torch.zeros_like(tt))[..., None] + ro
        return fin & (pt > vmin).all(-1) & (pt < vmax).all(-1)

    ok_n = between(tn)
    ok_f = (tf >= eps) & between(tf)
    return _miss(torch.where(ok_n, tn, tf), ok & (ok_n | ok_f))


def surface_normal(ro, rd, t, pos, q, coef):
    lo, ld = rot(q, ro - pos), rot(q, rd)
    tm = ld * t[..., None] + lo
    a, b, c, d, e, _ = coef.unbind(-1)
    n = torch.stack([2 * a * tm[..., 0], 2 * b * tm[..., 1] + e, 2 * c * tm[..., 2] + d], -1)
    return nrm(rot(qinv(q), n))


def _torus_quartic(ro, rd, pos, q, form):
    lo, ld = rot(q, ro - pos), rot(q, rd)
    R, r = form[..., 0], form[..., 1]
    A = dot(ld, ld)
    B = 2.0 * dot(lo, ld)
    C = dot(lo, lo) + R * R - r * r
    a2 = ld[..., 0] ** 2 + ld[..., 1] ** 2
    b2 = 2.0 * (lo[..., 0] * ld[..., 0] + lo[..., 1] * ld[..., 1])
    c2 = lo[..., 0] ** 2 + lo[..., 1] ** 2
    return (A * A, 2 * A * B, B * B + 2 * A * C - 4 * R * R * a2,
            2 * B * C - 4 * R * R * b2, C * C - 4 * R * R * c2)


def _horner(c, z):
    return (((c[0] * z + c[1]) * z + c[2]) * z + c[3]) * z + c[4]


def _horner_d(c, z):
    return ((4 * c[0] * z + 3 * c[1]) * z + 2 * c[2]) * z + c[3]


def torus_crosses(ro, rd, pos, q, form, scale):
    """Whether each line crosses the torus's bounding sphere of radius
    (R + r)·scale, in its local frame."""
    lo, ld = rot(q, ro - pos), rot(q, rd)
    c0, hb, a = dot(lo, lo), dot(lo, ld), dot(ld, ld)
    rho = (form[..., 0] + form[..., 1]) * scale
    return hb * hb >= a * (c0 - rho * rho)


@torch.no_grad()
def torus_t(ro, rd, pos, q, form):
    """The shader's torus, rays ro, rd [B, P, 3] against the P toruses of
    pos, q, form → t [B, P]: Durand-Kerner on the quartic (complex, up to
    60 sweeps, stopping at a step under 1e-3), three complex Newton polishes
    per root, the least real root (|imag| ≤ 1e-3, real ≥ 0), then two real
    Newton polishes; a hit when 0 < t < 100.  Only lines that pass near the
    bounding sphere are solved, torus by torus: no other line can meet the
    torus."""
    t = torch.full(ro.shape[:-1], INF, dtype=ro.dtype, device=ro.device)
    near = torus_crosses(ro, rd, pos, q, form, TORUS_CULL)
    p, r = torch.nonzero(near.t(), as_tuple=True)
    n = r.numel()
    if not n:
        return t
    cdt = torch.complex128 if ro.dtype == torch.float64 else torch.complex64
    rdt = torch.float64 if ro.dtype == torch.float64 else torch.float32
    c = [x.to(rdt) for x in _torus_quartic(ro[r, p], rd[r, p], pos[p], q[p], form[p])]
    cc = [x.to(cdt) for x in c]
    z0 = complex(0.4, 0.9)
    roots = [torch.full((n,), v, dtype=cdt, device=ro.device)
             for v in (complex(1.0, 0.0), z0, z0 ** 2, z0 ** 3)]
    done = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for _ in range(60):
        err = torch.zeros(n, dtype=rdt, device=ro.device)
        for i in range(4):
            den = torch.ones_like(roots[i])
            for j in range(4):
                if j != i:
                    den = den * (roots[i] - roots[j])
            den = torch.where(den == 0, torch.full_like(den, 1e-30), den)
            delta = _horner(cc, roots[i]) / den
            roots[i] = torch.where(done, roots[i], roots[i] - delta)
            err = torch.maximum(err, torch.maximum(delta.real.abs(), delta.imag.abs()))
        done = done | (err < 1e-3)
        if bool(done.all()):
            break
    best = torch.full((n,), 1e4, dtype=rdt, device=ro.device)
    for z in roots:
        stop = torch.zeros(n, dtype=torch.bool, device=ro.device)
        for _ in range(3):
            fp = _horner_d(cc, z)
            stop = stop | (fp.abs() ** 2 < 1e-30)
            z = torch.where(stop, z, z - _horner(cc, z) / torch.where(stop, torch.ones_like(fp), fp))
        ok = (z.imag.abs() <= 1e-3) & (z.real >= 0)
        best = torch.where(ok, torch.minimum(best, z.real), best)
    hit = (best > 0) & (best < 100)
    for _ in range(2):
        fp = _horner_d(c, best)
        go = hit & (fp.abs() > 1e-6)
        best = torch.where(go, best - _horner(c, best) / torch.where(go, fp, torch.ones_like(fp)),
                           best)
    t[r, p] = torch.where(hit, best, torch.full_like(best, INF)).to(ro.dtype)
    return t


def torus_t_grad(ro, rd, pos, q, form, t0):
    """t with its gradient: one Newton step from the solved root t0."""
    c = _torus_quartic(ro, rd, pos, q, form)
    fp = _horner_d(c, t0)
    flat = fp == 0
    return torch.where(flat, t0, t0 - _horner(c, t0) / torch.where(flat, torch.ones_like(fp), fp))


def torus_normal(ro, rd, t, pos, q, form):
    lo, ld = rot(q, ro - pos), rot(q, rd)
    p = lo + ld * t[..., None]
    R, r = form[..., 0:1], form[..., 1:2]
    k = torch.tensor([1.0, 1.0, -1.0], dtype=p.dtype, device=p.device)
    n = p * (dot(p, p)[..., None] - r * r - R * R * k)
    return nrm(rot(qinv(q), n))


# -- scene queries --------------------------------------------------------------

def _prim(S, kind, at, *names):
    return [S[f"{kind}.{n}"][at] for n in names]


def _t_of(S, cfg, kind, at, ro, rd, shadow=False):
    """t of rays against primitives of one kind: ``at`` an index, rays
    [n, 3] against that primitive (not a torus: its t with a gradient is
    ``torus_t_grad``'s); a slice of P primitives, rays [B, P, 3] against
    each.  A shadow ray sees no sphere hollow and every plane from both
    sides."""
    args = _prim(S, kind, at, *PARAMS[kind])
    if kind == "planes":
        pos, n = args
        return plane_t(ro, rd, n, pos, cfg.plane_oneside and not shadow)
    if kind in ("spheres", "lights_point"):
        hollow = (False if shadow or kind == "lights_point" else
                  S.hollow[kind][at] if isinstance(at, int) else S.hollow_mask[kind][at])
        return sphere_t(ro, rd, *args, hollow)
    if kind == "surfaces":
        return surface_t(ro, rd, *args)
    if kind == "boxes":
        return box_t(ro, rd, *args)
    if kind == "toruses":
        return torus_t(ro, rd, *args)
    return ring_t(ro, rd, *args)


def _sweep(S, cfg, kinds, ro, rd, take, shadow=False):
    """Every primitive of ``kinds`` against the rays ro, rd [R, 3], in
    blocks of at most PAIR_BLOCK (ray, primitive) pairs, each ray's
    primitives in slot order: ``take(kind, rays, prims, t)`` gets each
    block's slices and its t [rays, prims]."""
    R = ro.shape[0]
    for kind in kinds:
        P = S.count[kind]
        if not P:
            continue
        per_rays, per_prims = max(1, PAIR_BLOCK // P), min(P, PAIR_BLOCK)
        for r0 in range(0, R, per_rays):
            rays = slice(r0, min(R, r0 + per_rays))
            for p0 in range(0, P, per_prims):
                prims = slice(p0, min(P, p0 + per_prims))
                shape = (rays.stop - r0, prims.stop - p0, 3)
                o, d = ro[rays, None].expand(shape), rd[rays, None].expand(shape)
                take(kind, rays, prims, _t_of(S, cfg, kind, prims, o, d, shadow))


def _groups(S, typ, num, alone):
    """The rays (typ, num) name grouped by the primitive they hit →
    [(kind, at, rows)] in slot order, each group's rows ascending (as
    ``nonzero`` gives them): a primitive for which ``alone(kind, i)`` holds
    on its own (at = i), the others of a kind together (at = the num of
    each row).  Rays of type −1 are in none.  One sort and one copy to the
    host in place of a pass over the rays per primitive."""
    gid, groups, shared = [], [], {}
    for kind in SLOT_KINDS:
        for i in range(S.count[kind]):
            if alone(kind, i):
                gid.append(len(groups))
                groups.append((kind, i))
                continue
            if kind not in shared:
                shared[kind] = len(groups)
                groups.append((kind, None))
            gid.append(shared[kind])
    if not gid:
        return []
    table = torch.tensor(gid, dtype=torch.int64, device=typ.device)
    key = torch.where(typ < 0, len(groups), table[S.slot_of(typ, num).clamp(max=len(gid) - 1)])
    order = torch.sort(key, stable=True).indices
    out, start = [], 0
    for (kind, i), n in zip(groups, torch.bincount(key, minlength=len(groups)).tolist()):
        if n:
            rows = order[start:start + n]
            out.append((kind, num[rows] if i is None else i, rows))
        start += n
    return out


def calc_inter(S, cfg, ro, rd):
    """The nearest hit (calcInter) → (t, type, index); a miss is t ≥
    MAX_DIST.  The winner is searched detached; with gradients on, its t is
    recomputed from the winning primitive alone."""
    R = ro.shape[0]
    with torch.no_grad():
        tmin = torch.full((R,), MAX_DIST, dtype=ro.dtype, device=ro.device)
        typ = torch.full((R,), -1, dtype=torch.int64, device=ro.device)
        num = torch.zeros(R, dtype=torch.int64, device=ro.device)

        def take(kind, rays, prims, t):
            # the block's least t, its first primitive on a tie; NaN never wins
            t = torch.where(torch.isnan(t), INF, t)
            m = t.amin(1)
            at = torch.arange(t.shape[1], device=t.device)
            j = torch.where(t == m[:, None], at, t.shape[1]).amin(1)
            up = m < tmin[rays]
            tmin[rays] = torch.where(up, m, tmin[rays])
            typ[rays] = torch.where(up, TYPE_OF[kind], typ[rays])
            num[rays] = torch.where(up, j + prims.start, num[rays])

        _sweep(S, cfg, SLOT_KINDS, ro.detach(), rd.detach(), take)
    if not (torch.is_grad_enabled() and (ro.requires_grad or rd.requires_grad
                                          or any(v.requires_grad for v in S.leaves.values()))):
        return tmin, typ, num
    t = tmin
    # one graph piece per winning primitive: gathering the parameters of a
    # whole type would sum the leaves' gradients in another order
    for kind, i, sel in _groups(S, typ, num, lambda kind, i: True):
        o, d = ro[sel], rd[sel]
        if kind == "toruses":
            tv = torus_t_grad(o, d, *_prim(S, kind, i, "pos", "quat", "form"), tmin[sel])
        else:
            tv = _t_of(S, cfg, kind, i, o, d)
        t = t.index_put((sel,), tv)
    return t, typ, num


@torch.no_grad()
def in_shadow(S, T, cfg, ro, rd, dist, tally=None):
    """inShadow (rt.frag:630-658), detached → shadow ∈ [0, 1] [R]: a solid
    occluder before ``dist`` shadows fully, a textured ring adds its
    level-0 alpha at the hit, an untextured one shadows fully.  With
    ``tally`` a dict, it gains ``solid`` [R] bool and ``ring_keys`` (the
    alpha taps' keys)."""
    solid = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)

    def take(kind, rays, prims, t):
        solid[rays] |= (t < dist[rays, None]).any(1)

    kinds = ("spheres", "surfaces", "boxes", "toruses")
    _sweep(S, cfg, kinds + (() if cfg.plane_oneside else ("planes",)), ro, rd, take, shadow=True)
    shadow = solid.to(ro.dtype)
    keys = [] if tally is not None else None
    for i in range(S.count["rings"]):
        pos, q, r1, r2 = _prim(S, "rings", i, "pos", "quat", "r1", "r2")
        t = ring_t(ro, rd, pos, q, r1, r2)
        hit = t < dist
        if S.texture["rings"][i] > 0 and T.ring_alpha is not None:
            sel = torch.nonzero(hit).squeeze(-1)
            if sel.numel():
                u, v = ring_uv(ro[sel], rd[sel], t[sel], pos, q, r1, r2)
                a = trilinear(T.ring_alpha, u, v, None, keys=keys)[..., 3]
                shadow = shadow.index_add(0, sel, a)
        else:
            shadow = torch.maximum(shadow, hit.to(ro.dtype))
    if tally is not None:
        tally.update(solid=solid, ring_keys=keys)
    return torch.clamp(shadow, max=1.0)


def _lights(S, pt):
    """Each light seen from the points pt [R, 3] → [(direction toward it,
    distance, colour, intensity, linear k or None, quadratic k)]: point
    lights, then directional ones (at MAX_DIST)."""
    out = []
    for i in range(S.count["lights_point"]):
        ldir = S["lights_point.pos"][i] - pt
        out.append((ldir, sqrt(dot(ldir, ldir)), S["lights_point.color"][i],
                    S["lights_point.intensity"][i], S["lights_point.linear_k"][i],
                    S["lights_point.quadratic_k"][i]))
    for i in range(S.count["lights_direct"]):
        far = torch.full(pt.shape[:-1], MAX_DIST, dtype=pt.dtype, device=pt.device)
        out.append((-S["lights_direct.direction"][i].expand(pt.shape), far,
                    S["lights_direct.color"][i], S["lights_direct.intensity"][i], None, None))
    return out


def calc_shade(S, T, cfg, pt, rd, mat, normal):
    """calcShade: ambient, then per light Lambert and Phong, each light
    dimmed by its shadow (floored at the shadow ambient) → [R, 3]."""
    color = mat["color"]
    pixel = S["ambient_color"] * color
    diffuse = torch.zeros_like(pixel)
    specular = torch.zeros_like(pixel)
    has_spec = (mat["specular"] > 0)[..., None]
    for ldir, dist, lcol, inten, lk, qk in _lights(S, pt):
        ld = nrm(ldir)
        div = torch.ones_like(dist) if lk is None else 1.0 + lk * dist + qk * dist * dist
        dp = torch.clamp(dot(normal, ld), 0.0, 1.0)
        lc = lcol * dp[..., None]
        if cfg.shadow_enabled:
            sh = 1.0 - in_shadow(S, T, cfg, pt.detach(), ld.detach(), dist.detach())
            lc = lc * torch.maximum(sh[..., None], S["shadow_ambient"])
        w = (inten / div)[..., None]
        diffuse = diffuse + lc * color * mat["diffuse"][..., None] * w
        sdp = torch.clamp(dot(rd, reflect(ld, normal)), 0.0, 1.0)
        spec = torch.clamp(sdp, min=1e-12) ** mat["specular"]
        specular = specular + torch.where(has_spec, lc * spec[..., None] * w,
                                          torch.zeros_like(lc))
    return pixel + diffuse * mat["kd"][..., None] + specular * mat["ks"][..., None]


def _scatter(base, sel, val):
    return base.index_put((sel,), val)


def _crossings(S, ro, rd):
    """[per torus] how many of the lines ro, rd cross its bounding sphere
    (shrunk by CROSS_SHRINK), the lines the work model prices a solve."""
    return [int(torus_crosses(ro, rd, *_prim(S, "toruses", i, "pos", "quat", "form"),
                              CROSS_SHRINK).sum()) for i in range(S.count["toruses"])]


@torch.no_grad()
def _shadow_tally(S, T, cfg, so):
    """The shadow rays of the points so toward each light, as the probe
    casts them → ([per light dict(n, solid, cross_clear)], ring-alpha tap
    keys)."""
    rows, keys = [], []
    if not cfg.shadow_enabled or not so.shape[0]:
        return rows, keys
    for ldir, dist, *_ in _lights(S, so):
        part = {}
        ld = nrm(ldir)
        in_shadow(S, T, cfg, so, ld, dist, part)
        clear = ~part["solid"]
        rows.append(dict(n=so.shape[0], solid=int(part["solid"].sum()),
                         cross_clear=_crossings(S, so[clear], ld[clear])))
        keys += part["ring_keys"]
    return rows, keys


def _distinct(keys):
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


def _merge_shadows(a, b):
    if not a or not b:
        return a or b
    return [dict(n=x["n"] + y["n"], solid=x["solid"] + y["solid"],
                 cross_clear=[p + q for p, q in zip(x["cross_clear"], y["cross_clear"])])
            for x, y in zip(a, b)]


def hit_info(S, T, cfg, ro, rd, t, typ, num, pix_angle, keys=None, key_mask=None):
    """getHitInfo for hits that are not light bulbs → (material dict of
    per-ray rows, normal [R, 3], bias [R], alpha [R], textured [R] bool).
    Textures replace the colour (spheres, rings: and alpha); with ``keys``
    a list, the taps of the textured fetches of the rays ``key_mask``
    marks are appended to it (of a box its dominant face, as the program
    fetches)."""
    R = t.shape[0]
    slot = S.slot_of(typ, num)
    mat = {m: v[slot] for m, v in S.mat_table().items()}
    pt = ro + rd * t[..., None]
    normal = torch.zeros_like(ro)
    alpha = torch.ones_like(t)
    textured = torch.zeros(R, dtype=torch.bool, device=t.device)

    def lod(sel, n, texels_per_world):
        if pix_angle is None:
            return None
        return lod_of(footprint(t[sel], dot(rd[sel], n).abs(), pix_angle) * texels_per_world)

    def count_taps(tx, u, v, lv, sel):
        if keys is not None:
            m = key_mask[sel]
            if bool(m.any()):
                trilinear(tx, u[m], v[m], None if lv is None else lv[m], keys)

    def fetch(tx, u, v, lv, sel):
        count_taps(tx, u, v, lv, sel)
        return trilinear(tx, u, v, lv)

    # with gradients on, one graph piece per primitive (the leaves' gradients
    # then sum as a primitive-by-primitive pass sums them); else textured
    # primitives one by one and the others of a type together
    grad = torch.is_grad_enabled() and (t.requires_grad or ro.requires_grad or rd.requires_grad
                                        or any(v.requires_grad for v in S.leaves.values()))
    for kind, i, sel in _groups(S, typ, num,
                                lambda kind, i: grad or _textured(S, T, kind, i)):
        o, d, p, tt = ro[sel], rd[sel], pt[sel], t[sel]
        tex = _textured(S, T, kind, i) if isinstance(i, int) else False
        c = None
        if kind == "spheres":
            pos, radius, q = _prim(S, kind, i, "pos", "radius", "quat")
            n = nrm(p - pos)
            if tex:
                tx = T.sphere[S.texture[kind][i] - 1]
                sn = rot(q, n)
                pole = (sn[..., 0] == 0) & (sn[..., 2] == 0)
                sx = torch.where(pole, torch.ones_like(sn[..., 0]), sn[..., 0])
                u = 0.5 + torch.atan2(sn[..., 2], sx) / (2 * PI)
                edge = 1.0 - torch.finfo(sn.dtype).eps
                v = 0.5 - torch.asin(torch.clamp(sn[..., 1], -edge, edge)) / PI
                H, W = tx.shape0
                tpw = max(W / (2.0 * PI), H / PI) / torch.clamp(radius, min=1e-6)
                c = fetch(tx, u, v, lod(sel, n, tpw), sel)
                alpha = _scatter(alpha, sel, c[..., 3])
        elif kind == "planes":
            n = nrm(S["planes.normal"][i]).expand(p.shape)
        elif kind == "surfaces":
            pos, q, coef = _prim(S, kind, i, "pos", "quat", "coef")
            n = surface_normal(o, d, tt, pos, q, coef)
        elif kind == "boxes":
            pos, q, form = _prim(S, kind, i, "pos", "quat", "form")
            n = box_normal(o, d, pos, q, form)
            if tex:
                bp, pp, nn = rot(q, pos.expand(p.shape)), rot(q, p), rot(q, n)
                H, W = T.box.shape0
                lv = lod(sel, n, 0.5 * max(H, W))
                rel = pp - bp
                fu = 0.5 * torch.stack([rel[..., 2], rel[..., 2], rel[..., 0]], -1) - 0.5
                fv = 0.5 * torch.stack([rel[..., 1], rel[..., 0], rel[..., 1]], -1) - 0.5
                c = sum(nn[..., k:k + 1].abs() * trilinear(T.box, fu[..., k], fv[..., k], lv)
                        for k in range(3))
                # the program fetches the dominant face alone: its taps
                dom = nn.abs().argmax(-1, keepdim=True)
                count_taps(T.box, fu.gather(-1, dom)[..., 0], fv.gather(-1, dom)[..., 0],
                           lv, sel)
        elif kind == "toruses":
            pos, q, form = _prim(S, kind, i, "pos", "quat", "form")
            n = torus_normal(o, d, tt, pos, q, form)
        else:
            pos, q, r1, r2 = _prim(S, kind, i, "pos", "quat", "r1", "r2")
            zdir = torch.tensor([0.0, 0.0, -1.0], dtype=p.dtype, device=p.device)
            n = rot(qinv(q), zdir.expand(p.shape))
            if tex:
                u, v = ring_uv(o, d, tt, pos, q, r1, r2)
                H, W = T.ring.shape0
                rm = sqrt(torch.clamp(0.5 * (r1 + r2), min=1e-12))
                tpw = torch.maximum(W * 2.0 * rm / torch.clamp(r2 - r1, min=1e-12),
                                    H / (PI * rm))
                c = fetch(T.ring, u, v, lod(sel, n, tpw), sel)
                alpha = _scatter(alpha, sel, c[..., 3])
        if c is not None:
            mat["color"] = _scatter(mat["color"], sel, c[..., :3])
            textured[sel] = True
        normal = _scatter(normal, sel, n)
    bias = (9e-3 * sqrt(dot(pt - ro, pt - ro)) + 35.0) / 35e3
    return mat, normal, bias, alpha, textured


def _textured(S, T, kind, i):
    """Whether hit_info fetches a texture for primitive i of ``kind``."""
    tex = S.texture[kind][i] if kind in ("spheres", "boxes", "rings") else 0
    return ((kind == "spheres" and 0 < tex <= len(T.sphere))
            or (kind == "boxes" and tex > 0 and T.box is not None)
            or (kind == "rings" and tex > 0 and T.ring is not None))


def _env(S, T, rd):
    if T.cubemap is not None:
        return cubemap(T.cubemap, rd)
    return S["bg_color"].expand(rd.shape)


def reflected_color(S, T, cfg, ro, rd, pix_angle, tally=None):
    """getReflectedColor: the shaded colour of the glossy ray's first hit,
    a light bulb's colour, or black on a miss (rt.frag:787-802).  With
    ``tally`` a dict, it gains this probe's lane counts."""
    t, typ, num = calc_inter(S, cfg, ro, rd)
    out = torch.zeros_like(ro)
    hit = t < MAX_DIST
    light = hit & (typ == T_LIGHT)
    if light.any():
        sel = torch.nonzero(light).squeeze(-1)
        out = _scatter(out, sel, S["lights_point.color"][num[sel]])
    sel = torch.nonzero(hit & ~light).squeeze(-1)
    keys = [] if tally is not None else None
    o2 = ro[:0]
    if sel.numel():
        o, d = ro[sel], rd[sel]
        mat, n, bias, _, textured = hit_info(S, T, cfg, o, d, t[sel], typ[sel], num[sel],
                                             pix_angle, keys,
                                             torch.ones_like(sel, dtype=torch.bool))
        pt = o + d * t[sel][..., None]
        front = (dot(d, n) < 0)[..., None]
        o2 = torch.where(front, pt + n * bias[..., None], pt - n * bias[..., None])
        out = _scatter(out, sel, calc_shade(S, T, cfg, o2, d, mat, n))
    if tally is not None:
        shadows, ring_keys = _shadow_tally(S, T, cfg, o2.detach())
        tally.update(live=ro.shape[0], hit=int(hit.sum()), surf=sel.numel(),
                     cross=_crossings(S, ro.detach(), rd.detach()), shadows=shadows,
                     part=dict(lanes=sel.numel(),
                               textured=int(textured.sum()) if sel.numel() else 0,
                               texels=_distinct(keys), ring_texels=_distinct(ring_keys)))
    return out


def _fresnel_tir(rd, n, outside, ior, refl, do_fresnel):
    if not do_fresnel:
        return refl
    one = torch.ones_like(ior)
    n1 = torch.where(outside, one, ior)
    n2 = torch.where(outside, ior, one)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_x = -dot(rd, n)
    dense = n1 > n2
    sin_t2 = (n1 / n2) ** 2 * (1.0 - cos_x * cos_x)
    full = dense & (sin_t2 > 1.0)
    cos_x = torch.where(dense, sqrt(1.0 - sin_t2), cos_x)
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x ** 5
    return torch.where(full, one, refl + (1.0 - refl) * ret)


def _schlick(rd, n, refl):
    ndotv = torch.clamp(dot(n, -rd), 0.0, 1.0)
    return refl + (1.0 - refl) * (1.0 - ndotv) ** 5


def trace(S, T, cfg, ro, rd, pix_angle, tally=None):
    """The bounce loop of each ray (rt.frag:846-911) → colour [N, 3].
    Rays that end leave the batch; their colours are added at their index.
    With ``tally`` a list, it gains one dict of lane counts per bounce step
    for the work model (``rtbench/work``): the step's probe, the glossy
    probe, the glossy rays and the consume."""
    N = ro.shape[0]
    out = torch.zeros_like(ro)
    idx = torch.arange(N, device=ro.device)
    mask = torch.ones_like(ro)
    absorb_d = torch.zeros_like(ro[:, 0])
    bounce = torch.zeros(N, dtype=torch.int64, device=ro.device)
    refract_of = S.mat_table()["refract"]
    for _ in range(cfg.max_steps):
        if not idx.numel():
            break
        t, typ, num = calc_inter(S, cfg, ro, rd)
        miss = t >= MAX_DIST
        light = ~miss & (typ == T_LIGHT)
        if tally is not None:
            live, n_hit = idx.numel(), int((~miss).sum())
            cross = _crossings(S, ro.detach(), rd.detach())
        if miss.any():
            s = torch.nonzero(miss).squeeze(-1)
            out = out.index_add(0, idx[s], _env(S, T, rd[s]) * mask[s])
        if light.any():
            s = torch.nonzero(light).squeeze(-1)
            out = out.index_add(0, idx[s], S["lights_point.color"][num[s]] * mask[s])
        keep = torch.nonzero(~miss & ~light).squeeze(-1)
        idx, ro, rd, mask, absorb_d, bounce = (x[keep] for x in (idx, ro, rd, mask, absorb_d,
                                                                 bounce))
        t, typ, num = t[keep], typ[keep], num[keep]
        if not idx.numel():
            if tally is not None:
                tally.append(_step_record(live, n_hit, 0, cross, [], None, 0, 0, None))
            break
        keys = [] if tally is not None else None
        opaque = refract_of[S.slot_of(typ, num)] <= 0
        mat, n, bias, alpha, textured = hit_info(S, T, cfg, ro, rd, t, typ, num, pix_angle,
                                                 keys, opaque)
        pt = ro + rd * t[..., None]
        outside = dot(rd, n) < 0
        n = torch.where(outside[..., None], n, -n)
        refr = mat["refract"] > 0
        refl = mat["reflect"]
        ior = torch.where(refr, mat["refract"], torch.full_like(refl, 1.5))
        if cfg.total_internal_reflection:
            rm = torch.where(refr, _fresnel_tir(rd, n, outside, ior, refl, cfg.do_fresnel),
                             _schlick(rd, n, refl))
        else:
            rm = _schlick(rd, n, refl)
        refr_m = 1.0 - rm
        off_out = pt + n * bias[..., None]
        off_in = pt - n * bias[..., None]
        alive = torch.ones_like(refr)
        # refracting hits: the glossy pass outside, absorption inside, then
        # through the surface
        glossy = refr & outside & (refl > 0) & cfg.refractive_glossy
        g_rec = {} if tally is not None else None
        if glossy.any():
            s = torch.nonzero(glossy).squeeze(-1)
            rc = reflected_color(S, T, cfg, off_out[s], reflect(rd[s], n[s]), pix_angle, g_rec)
            out = out.index_add(0, idx[s], rc * rm[s][..., None] * mask[s])
        nxt_mask = torch.where(glossy[..., None], mask * refr_m[..., None], mask)
        inside = refr & ~outside
        absorb_d = absorb_d + torch.where(inside, t, torch.zeros_like(t))
        nxt_mask = torch.where(inside[..., None],
                               nxt_mask * torch.exp(-mat["absorb"] * absorb_d[..., None]),
                               nxt_mask)
        if cfg.total_internal_reflection:
            alive = alive & ~(refr & (rm >= 1.0))
        eta = torch.where(outside, 1.0 / ior, ior)
        nxt_rd = torch.where(refr[..., None], refract(rd, n, eta), rd)
        if not cfg.reflect_reduce_iteration:
            bounce = bounce + refr.to(torch.int64)
        # opaque hits shade: a reflecting one bounces, another passes by alpha
        shade = ~refr
        if shade.any():
            s = torch.nonzero(shade).squeeze(-1)
            w = torch.where((refl[s] > 0)[..., None], refr_m[s][..., None] * mask[s],
                            mask[s] * alpha[s][..., None])
            c = calc_shade(S, T, cfg, off_out[s], rd[s], {k: v[s] for k, v in mat.items()}, n[s])
            out = out.index_add(0, idx[s], c * w)
        mirror = shade & (refl > 0)
        thin = shade & ~(refl > 0)
        nxt_ro = torch.where(mirror[..., None], off_out, off_in)
        nxt_rd = torch.where(mirror[..., None], reflect(rd, n), nxt_rd)
        nxt_mask = torch.where(mirror[..., None], mask * rm[..., None], nxt_mask)
        nxt_mask = torch.where(thin[..., None], mask * (1.0 - alpha)[..., None], nxt_mask)
        alive = alive & ~(thin & (alpha >= 1.0))
        bounce = bounce + shade.to(torch.int64)
        alive = alive & (bounce < cfg.iterations)
        if tally is not None:
            so = off_out.detach()
            sh_shade, ring_keys = _shadow_tally(S, T, cfg, so[shade])
            sh_refr, _ = _shadow_tally(S, T, cfg, so[refr])
            part = dict(lanes=int(shade.sum()), textured=int((shade & textured).sum()),
                        texels=_distinct(keys), ring_texels=_distinct(ring_keys))
            tally.append(_step_record(live, n_hit, idx.numel(), cross,
                                      _merge_shadows(sh_shade, sh_refr), part,
                                      int(inside.sum()), int(glossy.sum()),
                                      g_rec if glossy.any() else None))
        k = torch.nonzero(alive).squeeze(-1)
        idx, ro, rd, mask, absorb_d, bounce = (x[k] for x in (idx, nxt_ro, nxt_rd, nxt_mask,
                                                              absorb_d, bounce))
    return out


def _step_record(live, hit, surf, cross, shadows, part, refr_inside, glossy, g):
    """One bounce step's lane counts, by the launches the work model
    prices (``rtbench/work/prices.py``)."""
    parts = [] if part is None else [part]
    if g is not None:
        parts.append(g["part"])
    return dict(
        probe=dict(live=live, cross=cross, shadows=shadows),
        glossy_probe=None if g is None else dict(live=g["live"], cross=g["cross"],
                                                  shadows=g["shadows"]),
        glossy_rays=dict(live=live, hit=hit, surf=surf, glossy=glossy),
        consume=dict(live=live, hit=hit, surf=surf, refr_inside=refr_inside, glossy=glossy,
                     glossy_hit=0 if g is None else g["hit"], parts=parts))


# -- frames ---------------------------------------------------------------------

def primary_rays(S, cfg, pix, ss):
    """The ss×ss sub-sample rays of flat row-major pixels ``pix`` →
    (ro, rd) [len(pix)·ss², 3], sub-samples of a pixel consecutive."""
    H, W = cfg.height, cfg.width
    r, c = pix // W, pix % W
    jj = torch.arange(ss * ss, device=pix.device)
    gx = ((c[:, None] * ss + jj % ss).to(S.dtype) + 0.5) / ss
    gy = H - ((r[:, None] * ss + jj // ss).to(S.dtype) + 0.5) / ss
    d = torch.stack([(gx - W / 2.0) / H, (gy - H / 2.0) / H, torch.ones_like(gx)], -1)
    rd = nrm(rot(S["camera.quat"], d.reshape(-1, 3)))
    return S["camera.pos"].expand(rd.shape), rd


def _colors(S, T, cfg, pix, ss, chunk, tally=None, grad_fn=None):
    """The mean colour of each pixel's ss² sub-samples, traced ``chunk``
    rays at a time; ``grad_fn(rows, colours)`` is called per chunk (its
    backward runs there) and the colours are kept detached."""
    pix_angle = 1.0 / (cfg.height * ss) if cfg.texture_lod else None
    per = max(1, chunk // (ss * ss))
    outs = []
    for part in torch.split(pix, per):
        ro, rd = primary_rays(S, cfg, part, ss)
        col = trace(S, T, cfg, ro, rd, pix_angle, tally)
        col = col.reshape(-1, ss * ss, 3)
        acc = col[:, 0]
        for j in range(1, ss * ss):
            acc = acc + col[:, j]
        col = acc / (ss * ss)
        if grad_fn is not None:
            grad_fn(part, col)
        outs.append(col.detach())
    return torch.cat(outs)


LUMA = (0.2126, 0.7152, 0.0722)


def edge_pixels(base, cfg):
    """The pixels edge AA re-renders: flat row-major indices of the first
    min(H·W, edge_budget_mult·(H + W)) pixels whose luma differs from a
    four-neighbour's by more than the threshold."""
    lum = base[..., 0] * LUMA[0] + base[..., 1] * LUMA[1] + base[..., 2] * LUMA[2]
    dv = (lum[1:] - lum[:-1]).abs()
    dh = (lum[:, 1:] - lum[:, :-1]).abs()
    pad = torch.nn.functional.pad
    delta = torch.maximum(torch.maximum(pad(dv, (0, 0, 1, 0)), pad(dv, (0, 0, 0, 1))),
                          torch.maximum(pad(dh, (1, 0)), pad(dh, (0, 1))))
    budget = min(cfg.height * cfg.width, cfg.edge_budget_mult * (cfg.height + cfg.width))
    return torch.nonzero((delta > cfg.edge_threshold).reshape(-1)).squeeze(-1)[:budget]


def render(S, T, cfg, chunk=1 << 18, tally=None, grad_fn=None):
    """The frame [H, W, 3], row 0 on top: 1 spp, then with edge AA the edge
    pixels at supersample² spp written over it.  ``tally``: a list that
    gains the lane counts of every bounce step of each pass (a dict with
    ``pass``); ``grad_fn`` as in ``_colors`` (1 spp frames only)."""
    H, W = cfg.height, cfg.width
    pix = torch.arange(H * W, device=S.device)
    steps = [] if tally is not None else None
    img = _colors(S, T, cfg, pix, 1, chunk, steps, grad_fn).reshape(H, W, 3)
    if tally is not None:
        tally.append(dict(name="frame", steps=steps))
    if cfg.aa_edge and cfg.supersample > 1:
        if grad_fn is not None:
            raise ValueError("reference: the gradient is taken of 1-spp frames only")
        edge = edge_pixels(img, cfg)
        esteps = [] if tally is not None else None
        if edge.numel():
            aa = _colors(S, T, cfg, edge, cfg.supersample, chunk, esteps)
            img = img.reshape(-1, 3).index_put((edge,), aa).reshape(H, W, 3)
        if tally is not None:
            tally.append(dict(name="edge", steps=esteps, edge_pixels=edge.numel()))
    return img


def loss_and_grad(S, T, cfg, chunk=1 << 17, rows=None, tally=None):
    """mean(img²) over the 1-spp frame and its gradient with respect to
    every leaf of ``S`` (made with ``requires_grad``) → (loss, {path:
    gradient}, image), the backward run chunk by chunk.  ``rows``: the
    image rows the mean is taken over (default all); ``tally`` as in
    ``render``."""
    H, W = cfg.height, cfg.width
    keep = torch.zeros(H * W, dtype=torch.bool, device=S.device)
    keep.view(H, W)[slice(None) if rows is None else rows] = True
    n = float(int(keep.sum()) * 3)
    total = [0.0]
    leaves = list(S.leaves.items())
    grads = {k: torch.zeros_like(v) for k, v in leaves}

    def grad_fn(pix, col):
        col = col * keep[pix][:, None].to(col.dtype)
        part = (col * col).sum() / n
        got = torch.autograd.grad(part, [v for _, v in leaves], allow_unused=True)
        for (k, _), g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total[0] += float(part.detach())

    img = render(S, T, cfg, chunk, tally=tally, grad_fn=grad_fn)
    return total[0], grads, img
