"""Analytic work model of the renderer, and the least time the card could
take for a kernel launch (txr/utils/flops.py).

The first half is the JAX package's per-ray FLOP model, with the same
prices and results: hand counts of the per-primitive intersector math (the
dominant cost) times the sweeps a frame performs (a nearest-hit sweep and
one shadow any-hit sweep per light per shading step), weighted by the
share of live lanes in each bounce step (``live_fractions``).

Counting convention: every f32 scalar arithmetic op (add/mul/sub/div/sqrt/
min/max/compare/select) counts 1; transcendentals (acos/cos/cbrt in the
Ferrari solve) also count 1 each, so this is a lower bound on the work.
Excluded: texture gathers (memory, not flops), hit-info select chains and
Phong shading (about 300 flops a live ray a step, under 5 % of a sweep),
bookkeeping, and the backward pass.

The second half prices one launch of each of the port's kernels
(``step_probe_work``, ``nearest_hit_work``, ``shadow_sweep_work``,
``glossy_rays_work``, ``step_consume_work``, ``lane_compact_work`` and
``lane_scatter_work``) and turns
it into a bound (``bound_ms``): the larger of its operations over
the card's FP32 peak and its bytes over the card's memory rate.  A launch
is priced from the scene's counts and its live lanes only, never from its
capacity, its padding or the kernel's own loop, so the same work reads the
same bound whatever kernel does it.  Where a correct kernel may skip a
test, only what remains is priced, at its cheapest: a torus whose bounding
sphere the line misses costs one sphere test, and a shadow ray that the
kernel reports solid costs its cheapest occluder test (and its rings).
When in doubt the model counts less, so no correct kernel reads over 100 %
of its bound.  ``priced_launches`` prices every launch the render path
makes while it is open.
"""

from __future__ import annotations

import contextlib

import torch

# Per-(ray, primitive) test costs, hand-counted from the Pallas kernel
# transcriptions (txr/kernels/pallas_intersect.py; same math as
# txr/geometry/intersect.py).  A quaternion rotate is ~40 ops; types that
# rotate the ray into a local frame pay it twice (origin + direction).
TEST_FLOPS = {
    "planes": 20,        # _plane_test: dot, div, compares
    "spheres": 25,       # _sphere_test: quadratic + hollow select
    "surfaces": 180,     # _surface_test: 2 rotates + quadratic + clip box
    "boxes": 120,        # _box_test: 2 rotates + slab test
    "toruses": 500,      # _torus_test: 2 rotates + Ferrari quartic +
                         # 4x Newton polish (the reference's 60-iteration
                         # Durand-Kerner costs ~20x this, rt.frag:462-487)
    "rings": 95,         # _ring_test: 2 rotates + plane + annulus test
    "lights_point": 25,  # light bulbs test as plain spheres
}
ACCEPT_FLOPS = 3         # running (tmin, slot) argmin update per slot

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# a line that misses a torus's bounding sphere needs no quartic: the least
# a kernel can spend on it is one sphere test (in world space)
CULLED_TORUS_FLOPS = TEST_FLOPS["spheres"]
# the bounding sphere the model prices against, shrunk a little below
# R + r, so that rounding never prices a line the kernel culls as a solve
CROSS_SHRINK = 1.0 - 1e-4
_OCCLUDERS = ("spheres", "surfaces", "boxes", "toruses")
_INF_T = 1.0e30          # kernels.primitives.INF_T: t of a miss
_BASE_ROWS = 23          # the probe's rows before its light rows (step_probe.n_rows)

# the consume's prices, hand-counted from csrc/step_consume.cu as the
# intersector prices are: per live lane the miss test; per hit that is not
# a light bulb the hit point, the two shade origins and the state update
# (refraction or reflection, Beer, the masks, the bounce); per lane that
# shades, ambient and the Phong sum, and per light the shadow factor and
# its two products; per textured hit the sphere UV (transcendentals count
# 1), the taps and the trilinear blend of 4 channels at two levels
CONSUME_FLOPS = dict(live=1, act=40, shade=21, light=21, texel=120)
GLOSSY_RAY_FLOPS = 25    # the glossy lane's hit point, origin and reflection
# the bounce state: ro, rd, color, mask [3] f32, absorb_dist f32, bounces
# i32, alive and missed u8
STATE_BYTES = 4 * 12 + 4 + 4 + 1 + 1


def sweep_flops(counts) -> int:
    """Flops per ray for ONE nearest-hit sweep over the whole scene
    (calcInter, rt.frag:587-628)."""
    total = 0
    for k, per in TEST_FLOPS.items():
        total += counts[k] * (per + ACCEPT_FLOPS)
    return total


def shadow_flops(counts, one_side_planes=True) -> int:
    """Flops per ray for ONE shadow any-hit sweep (inShadow,
    rt.frag:630-658): same occluder tests minus one-sided planes and
    light bulbs."""
    total = 0
    for k in ("spheres", "surfaces", "boxes", "toruses", "rings"):
        total += counts[k] * (TEST_FLOPS[k] + 1)
    if not one_side_planes:
        total += counts["planes"] * (TEST_FLOPS["planes"] + 1)
    return total


def step_flops(counts, n_lights, shadow_enabled=True) -> int:
    """Flops per LIVE ray for one bounce step: one nearest-hit sweep plus
    one shadow sweep per light for the shading pass."""
    f = sweep_flops(counts)
    if shadow_enabled:
        f += n_lights * shadow_flops(counts)
    return f


def frame_flops_per_ray(scene, cfg, live_frac) -> float:
    """Average forward flops per primary ray for a frame.

    live_frac: per-step alive fractions (len == cfg.max_steps), measured on
    the actual frame (``live_fractions``).  Glossy extra passes are priced
    at one extra step for the refractive-hit fraction — negligible for the
    demo (<0.2% of rays) and folded into the +5% bookkeeping margin below.
    """
    counts = scene.counts
    n_lights = counts["lights_point"] + counts["lights_direct"]
    per_step = step_flops(counts, n_lights, cfg.shadow_enabled)
    total = sum(live_frac) * per_step
    return float(total) * 1.05  # +5%: raygen, hit info, Phong, updates


@torch.no_grad()
def live_fractions(scene, textures, cfg, device=None):
    """The share of live lanes before each of the ``cfg.max_steps`` bounce
    steps of one frame of ``cfg.width`` × ``cfg.height`` primary rays in
    raster order, stepped by the port's ``trace.make_step`` on ``device``
    (CUDA unless the caller passes "cpu"), as bench.py:355-361 measures
    the JAX package's frame.  Reads the count on the host at every step."""
    from txr_torch import resolve_device
    from txr_torch.kernels.scene_table import pack_scene
    from txr_torch.render import texture as tx
    from txr_torch.render import trace as tr
    from txr_torch.render.raygen import primary_rays

    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = tx.with_mips(textures.to(dev))
    ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, 1)
    st = tr.initial_state(ro, rd)
    step = tr.make_step(scene, textures, cfg, pack_scene(scene, textures.atlas))
    n = float(ro.shape[0])
    out = []
    for _ in range(cfg.max_steps):
        out.append(int(st["alive"].sum()) / n)
        st = step(st)
    return out


def bound_ms(ops, nbytes):
    """The least milliseconds the card can take for ``ops`` FP32 operations
    that move ``nbytes`` bytes."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S) * 1e3


def bound_by(ops, nbytes):
    """Which of the two sets ``bound_ms``: "operations" or "bytes"."""
    return "operations" if ops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_S else "bytes"


def _live(mask):
    """The live lanes of a launch: [L] int64 indices (None: every lane)."""
    if mask is None:
        return None
    return torch.nonzero(mask.to(torch.bool)).squeeze(-1)


def _rows(x, lanes):
    return x if lanes is None else x[lanes]


def _crossing(sec, o, d):
    """[(bool [N])] for each torus of the table: the lines o + s·d (float64
    [N, 3]) that cross its bounding sphere (radius (R + r)·CROSS_SHRINK),
    in its local frame, as the kernel's cull enters it."""
    from txr_torch.geometry import quaternion as quat

    out = []
    for row in sec["toruses"]:
        pos = torch.tensor(row[0:3].tolist(), dtype=torch.float64, device=o.device)
        q = torch.tensor(row[3:7].tolist(), dtype=torch.float64, device=o.device)
        lo, ld = quat.rotate(q, o - pos), quat.rotate(q, d)
        c0, hb, a = (lo * lo).sum(-1), (lo * ld).sum(-1), (ld * ld).sum(-1)
        rho = (float(row[7]) + float(row[8])) * CROSS_SHRINK
        out.append(hb * hb >= a * (c0 - rho * rho))
    return out


def _torus_flops(sec, o, d, full):
    """Sum over the lines o, d of each torus test's price: ``full`` where
    the line crosses the torus's bounding sphere, else CULLED_TORUS_FLOPS."""
    total = 0.0
    for cross in _crossing(sec, o, d):
        n_cross = int(cross.sum())
        total += n_cross * full + (cross.numel() - n_cross) * CULLED_TORUS_FLOPS
    return total


def _sweep_ops(cnt, sec, o, d):
    """Operations of nearest-hit sweeps of the lines o, d [L, 3]."""
    flat = sweep_flops(cnt) - cnt["toruses"] * (TEST_FLOPS["toruses"] + ACCEPT_FLOPS)
    return o.shape[0] * flat + _torus_flops(sec, o, d, TEST_FLOPS["toruses"] + ACCEPT_FLOPS)


def _shadow_ops(cnt, sec, o, d, solid, one_side):
    """Operations of shadow any-hit sweeps of the rays o, d [L, 3], whose
    answer ``solid`` [L] bool the kernel gave: a solid ray at its cheapest
    occluder test, any other at every occluder (a torus by its line), both
    with every ring's (hit, u, v)."""
    kinds = [k for k in _OCCLUDERS if cnt[k]] + ([] if one_side or not cnt["planes"]
                                                   else ["planes"])
    rings = cnt["rings"] * (TEST_FLOPS["rings"] + 1)
    n_solid = int(solid.sum())
    cheapest = min((TEST_FLOPS[k] + 1 for k in kinds), default=0)
    clear = ~solid
    o, d = o[clear], d[clear]
    flat = sum(cnt[k] * (TEST_FLOPS[k] + 1) for k in kinds if k != "toruses")
    ops = n_solid * (cheapest + rings) + o.shape[0] * (flat + rings)
    return ops + _torus_flops(sec, o, d, TEST_FLOPS["toruses"] + 1)


def nearest_hit_work(buf, hdr, ro, rd, alive=None):
    """(operations, bytes) of one nearest-hit launch: a sweep of each live
    lane (``alive``, None for every lane); each live lane's ray read once
    and (tmin, slot) written once, and the table read once."""
    from txr_torch.kernels.scene_table import sections

    cnt, sec = sections(buf, hdr)
    lanes = _live(alive)
    o, d = _rows(ro, lanes).double(), _rows(rd, lanes).double()
    ops = _sweep_ops(cnt, sec, o, d)
    return ops, o.shape[0] * (24 + 8) + buf.numel() * 4


def shadow_sweep_work(buf, hdr, ro, rd, dist, need, solid):
    """(operations, bytes) of one shadow-sweep launch on the rays ``need``
    marks (None: every ray), from the kernel's own ``solid`` answer; each
    live ray's origin, direction and distance read once, its solid bit and
    ring rows written once, and the table read once."""
    from txr_torch.kernels.scene_table import FLAG_ONE_SIDE, sections

    cnt, sec = sections(buf, hdr)
    lanes = _live(need)
    o, d = _rows(ro, lanes).double(), _rows(rd, lanes).double()
    hit = _rows(solid, lanes) > 0.5
    ops = _shadow_ops(cnt, sec, o, d, hit, bool(hdr[9] & FLAG_ONE_SIDE))
    return ops, o.shape[0] * (28 + 4 + 12 * cnt["rings"]) + buf.numel() * 4


def step_probe_work(buf, hdr, ro, rd, alive, f, i):
    """(operations, bytes) of one step-probe launch from its output (f, i):
    a nearest-hit sweep of each live lane, and for each live lane that hits
    a primitive other than a light bulb, one shadow sweep toward each light
    (when the table's flags enable shadows) from the hit point, as the
    kernel offsets it; each live lane's ray read once, and the table read
    once.  Rows written: with the header's ``FLAG_FILL``, every row of each
    live lane (the dead lanes' fills are not counted); without, what the
    kernel stores (``step_probe.cu``, "Lanes"): t alone on a miss, the base
    rows and ints on a light-bulb hit, every row on the other hits."""
    from txr_torch.kernels.scene_table import (FLAG_FILL, FLAG_ONE_SIDE, FLAG_SHADOW, SLOT_ORDER,
                                               sections)
    from txr_torch.kernels.step_probe import n_rows

    cnt, sec = sections(buf, hdr)
    lanes = _live(alive)
    o, d = _rows(ro, lanes).double(), _rows(rd, lanes).double()
    ops = _sweep_ops(cnt, sec, o, d)
    fl = _rows(f.T, lanes)
    t = fl[:, 0].double()
    hit = t < _INF_T
    shaded = hit & (_rows(i[0], lanes) < sum(cnt[k] for k in SLOT_ORDER[:-1]))
    row_bytes = 4 * n_rows(cnt) + 12
    if hdr[9] & FLAG_FILL:
        written = o.shape[0] * row_bytes
    else:
        n_hit, n_shaded = int(hit.sum()), int(shaded.sum())
        written = ((o.shape[0] - n_hit) * 4 + (n_hit - n_shaded) * (4 * _BASE_ROWS + 12)
                   + n_shaded * row_bytes)
    nbytes = o.shape[0] * 24 + written + buf.numel() * 4
    L = cnt["lights_point"] + cnt["lights_direct"]
    if not (L and hdr[9] & FLAG_SHADOW):
        return ops, nbytes
    t, o, d, n = t[shaded], o[shaded], d[shaded], fl[shaded, 1:4].double()
    solid = fl[shaded, _BASE_ROWS:].reshape(-1, L, 3 + 3 * cnt["rings"])[:, :, 2] > 0.5
    so = o + d * t[:, None] + n * ((9e-3 * t + 35.0) / 35e3)[:, None]
    # toward each light: point lights, then direct ones (a line: length free)
    lights = [torch.tensor(p[0:3].tolist(), dtype=torch.float64, device=o.device) - so
              for p in sec["lights_point"]]
    lights += [torch.tensor((-p[0:3]).tolist(), dtype=torch.float64,
                            device=o.device).expand(so.shape) for p in sec["lights_direct"]]
    one_side = bool(hdr[9] & FLAG_ONE_SIDE)
    for l, toward in enumerate(lights):
        ops += _shadow_ops(cnt, sec, so, toward, solid[:, l], one_side)
    return ops, nbytes


def _atlas_texels(atlas, cfg, counts, f, i, lanes):
    """(distinct atlas rows read, requesting lanes) of the texture requests
    of the probe rows (f, i) on ``lanes``, as ``sample_atlas`` takes its
    taps: both levels of a trilinear fetch, level 0 without LOD."""
    from txr_torch.kernels.step_probe import KIND_BOX, KIND_RGBA
    from txr_torch.render import texture as tx

    if atlas is None or not lanes.numel():
        return 0, 0
    kind = i[1, lanes]
    lanes = lanes[(kind == KIND_RGBA) | (kind == KIND_BOX)]
    if not lanes.numel():
        return 0, 0
    slot, kind = i[0, lanes], i[1, lanes]
    b_sp = counts["planes"]
    sphere = (kind == KIND_RGBA) & (slot >= b_sp) & (slot < b_sp + counts["spheres"])
    req = f[6:9, lanes].T
    uv = torch.where(sphere[:, None], tx.sphere_uv(req), req[:, :2])
    k = torch.clamp(i[2, lanes].long(), 0, len(atlas.dims) - 1)
    L = atlas.levels[k]
    levels = [torch.zeros_like(k)]
    if cfg.texture_lod:
        lod = f[9, lanes]
        top = torch.clamp((L - 1).to(lod.dtype) - tx.BLOCK_LOD_EPS, min=0.0)
        l0 = torch.floor(torch.minimum(torch.clamp(lod, min=0.0), top)).long()
        levels = [l0, torch.minimum(l0 + 1, L - 1)]
    rows = [tx._taps(atlas.offset[k, lv], atlas.h0[k] >> lv, atlas.w0[k] >> lv, uv, False)[0]
            for lv in levels]
    return torch.unique(torch.cat(rows, 1)).numel(), lanes.numel()


def _ring_alpha_texels(textures, counts, ring_textured, f, lanes):
    """Distinct ring-alpha texels that the shadow rows f of ``lanes`` read:
    the level-0 taps of each hit of a textured ring."""
    from txr_torch.render import texture as tx

    ra = textures.ring_alpha
    L, nr = counts["lights_point"] + counts["lights_direct"], counts["rings"]
    if ra is None or not (L and nr) or not lanes.numel():
        return 0
    rows = []
    for l in range(L):
        for j in range(nr):
            r = _BASE_ROWS + l * (3 + 3 * nr) + 3 + 3 * j
            hit = lanes[f[r, lanes] > 0.5]
            if ring_textured[j] > 0.5 and hit.numel():
                z = torch.zeros_like(hit)
                rows.append(tx._taps(z, z + ra.shape[0], z + ra.shape[1],
                                     f[r + 1:r + 3, hit].T, False)[0])
    return torch.unique(torch.cat(rows, 1)).numel() if rows else 0


def glossy_lane_most():
    """(operations, bytes) that ``glossy_rays_work`` prices a lane at, at
    most: a glossy lane."""
    return CONSUME_FLOPS["live"] + GLOSSY_RAY_FLOPS, 2 + 4 + 4 + 4 + 24 + 12 + 8 + 24


def consume_lane_most(counts, shadow_enabled=True):
    """(operations, bytes) that ``step_consume_work`` prices a lane at,
    at most: a surface hit that shades, with its own and its glossy hit's
    texels (8 each) and ring-alpha texels (4 per light and ring)."""
    L, nr = counts["lights_point"] + counts["lights_direct"], counts["rings"]
    shade_ops = CONSUME_FLOPS["shade"] + L * CONSUME_FLOPS["light"] + CONSUME_FLOPS["texel"]
    shade_bytes = (24 + L * (12 + 4 * nr if shadow_enabled else 8) + 12 + 8 * 16
                   + L * nr * 16 + 8)
    return (CONSUME_FLOPS["live"] + CONSUME_FLOPS["act"] + 2 * shade_ops,
            2 * STATE_BYTES + 8 + 32 + 12 + 2 * shade_bytes)


def glossy_rays_work(buf, hdr, st, f, i, glossy):
    """(operations, bytes) of one glossy-rays launch of step_consume.cu:
    each live lane's alive bit read, its glossy bit written and its t read
    (a lane that is not live, padding included, is priced at nothing, as
    every launch here is priced from its live lanes), each hit's slot, each surface hit's refractive
    index read; each glossy lane's ray, normal, outside and reflect rows
    read and its glossy ray written."""
    from txr_torch.kernels.scene_table import SLOT_ORDER, counts_of

    cnt = counts_of(hdr)
    alive = st["alive"]
    hit = alive & (f[0] < _INF_T)
    surface = hit & (i[0] < sum(cnt[k] for k in SLOT_ORDER[:-1]))
    n_live, n_glossy = int(alive.sum()), int(glossy.sum())
    nbytes = (n_live * (2 + 4) + int(hit.sum()) * 4 + int(surface.sum()) * 4
              + n_glossy * (24 + 12 + 8 + 24))
    return n_live * CONSUME_FLOPS["live"] + n_glossy * GLOSSY_RAY_FLOPS, nbytes


def step_consume_work(buf, hdr, textures, cfg, st, f, i, gf=None, gi=None):
    """(operations, bytes) of one consume launch of step_consume.cu from its
    inputs: each live lane's state read once, its next state written once
    and its t read (a lane that is not live, padding included, keeps its
    state, which the kernel copies only because it writes out of place: it
    is priced at nothing), each hit's slot; each surface hit's normal,
    outside, Fresnel, reflect, refract and kind rows; a refracting hit
    inside its absorption row; each lane that shades (a surface that does
    not refract, and with ``cfg.refractive_glossy`` each surface hit of the
    glossy probe's rows gf, gi) its material and light rows (and each
    ring's hit bit under shadows), its texture request and the distinct
    atlas texels the requests read; the distinct ring-alpha texels; and
    the table's shading section."""
    from txr_torch.kernels.scene_table import SLOT_ORDER, counts_of, sections

    cnt = counts_of(hdr)
    L, nr = cnt["lights_point"] + cnt["lights_direct"], cnt["rings"]
    n_surf = sum(cnt[k] for k in SLOT_ORDER[:-1])
    ring_textured = sections(buf, hdr)[1]["shade"][6 + 3 * L:]
    shade_row = 24 + L * (12 + 4 * nr if cfg.shadow_enabled else 8)
    alive = st["alive"]

    def surfaces(f_, i_, live):
        hit = live & (f_[0] < _INF_T)
        return hit, hit & (i_[0] < n_surf)

    def shading(f_, i_, mask):
        lanes = torch.nonzero(mask).squeeze(-1)
        texels, textured = _atlas_texels(textures.atlas, cfg, cnt, f_, i_, lanes)
        ops = (lanes.numel() * (CONSUME_FLOPS["shade"] + L * CONSUME_FLOPS["light"])
               + textured * CONSUME_FLOPS["texel"])
        # a request's uv and atlas slot (its LOD and box weight are not
        # always read)
        nbytes = lanes.numel() * shade_row + textured * 12 + texels * 16
        if cfg.shadow_enabled:
            nbytes += 4 * _ring_alpha_texels(textures, cnt, ring_textured, f_, lanes)
        return ops, nbytes

    hit, surf = surfaces(f, i, alive)
    refractive = surf & (f[19] > 0.0)
    n_live, n_surf_hits = int(alive.sum()), int(surf.sum())
    ops = n_live * CONSUME_FLOPS["live"] + n_surf_hits * CONSUME_FLOPS["act"]
    nbytes = (n_live * (2 * STATE_BYTES + 4) + int(hit.sum()) * 4
              + n_surf_hits * 32 + int((refractive & ~(f[4] > 0.5)).sum()) * 12
              + (6 + 3 * L + nr) * 4)
    parts = [shading(f, i, surf & ~refractive)]
    if cfg.refractive_glossy:
        glossy = refractive & (f[4] > 0.5) & (f[18] > 0.0)
        ghit, gsurf = surfaces(gf, gi, glossy)
        nbytes += int(glossy.sum()) * 4 + int(ghit.sum()) * 4
        parts.append(shading(gf, gi, gsurf))
    return ops + sum(p[0] for p in parts), nbytes + sum(p[1] for p in parts)


def lane_compact_work(st, lane):
    """(operations, bytes) of one lane_compact call of lane_map.cu: the
    alive bytes read, each mapped live lane's state row read, a fill's one
    shared row read once, the lane map and the C rows written."""
    R, C = st["alive"].shape[0], lane.shape[0]
    live = int((lane < R).sum())
    return 0, R + STATE_BYTES * (live + (live < C)) + (8 + STATE_BYTES) * C


def lane_scatter_work(lane, R):
    """(operations, bytes) of one lane_scatter call of lane_map.cu: the lane
    map read, each non-fill lane's new row read and written back, the count
    written."""
    return 0, 8 * lane.shape[0] + 2 * STATE_BYTES * int((lane < R).sum()) + 8


@contextlib.contextmanager
def priced_launches():
    """While open, every call the render path makes to a kernel's wrapper
    (``render/fused.py: step_probe``, ``glossy_rays``, ``step_consume``,
    ``render/intersect.py: nearest_hit_sweep``, ``shadow_sweep``,
    ``kernels/lane_map.py: compact``, ``scatter``, which their callers look
    up at each call) runs as before and is priced:
    yields a list that gains dict(kernel, lanes, live, ops, bytes,
    bound_ms) per call.  Pricing reads
    the host, so a pass under it is not a timed one; it cannot run inside
    a graph capture."""
    from txr_torch.kernels import lane_map
    from txr_torch.kernels.scene_table import pack_scene, set_flags
    from txr_torch.render import fused, intersect

    calls = []
    probe, sweep, shadow = fused.step_probe, intersect.nearest_hit_sweep, intersect.shadow_sweep
    rays, consume = fused.glossy_rays, fused.step_consume
    compact, scatter = lane_map.compact, lane_map.scatter

    def note(kernel, n, mask, work):
        live = n if mask is None else int(mask.to(torch.bool).sum())
        calls.append(dict(kernel=kernel, lanes=n, live=live, ops=work[0], bytes=work[1],
                          bound_ms=bound_ms(*work)))

    def priced_probe(scene, atlas, ro, rd, *, one_side=True, shadow_enabled=True, table=None,
                     alive=None, **kw):
        f, i = probe(scene, atlas, ro, rd, one_side=one_side, shadow_enabled=shadow_enabled,
                     table=table, alive=alive, **kw)
        buf, hdr = pack_scene(scene, atlas) if table is None else table
        # priced with every live lane's rows, whatever the call's ``fill``,
        # as rtbench/work/prices.py prices a probe
        hdr = set_flags(hdr, one_side=one_side, shadow_enabled=shadow_enabled, fill=True)
        note("step_probe", ro.shape[0], alive, step_probe_work(buf, hdr, ro, rd, alive, f, i))
        return f, i

    def priced_sweep(buf, hdr, ro, rd, alive=None):
        out = sweep(buf, hdr, ro, rd, alive)
        note("nearest_hit", ro.shape[0], alive, nearest_hit_work(buf, hdr, ro, rd, alive))
        return out

    def priced_shadow(buf, hdr, ro, rd, dist, need=None):
        out = shadow(buf, hdr, ro, rd, dist, need)
        note("shadow_sweep", ro.shape[0], need,
             shadow_sweep_work(buf, hdr, ro, rd, dist, need, out[0]))
        return out

    def priced_rays(scene, st, pr, table):
        out = rays(scene, st, pr, table)
        note("glossy_rays", st["ro"].shape[0], st["alive"],
             glossy_rays_work(*table, st, pr.f, pr.i, out[0]))
        return out

    def priced_consume(scene, textures, cfg, st, pr, gpr, table):
        out = consume(scene, textures, cfg, st, pr, gpr, table)
        g = (None, None) if gpr is None else (gpr.f, gpr.i)
        note("step_consume", st["ro"].shape[0], st["alive"],
             step_consume_work(*table, textures, cfg, st, pr.f, pr.i, *g))
        return out

    def priced_compact(st, C):
        lane, sub, live = compact(st, C)
        R = st["alive"].shape[0]
        note("lane_compact", C, lane < R, lane_compact_work(st, lane))
        return lane, sub, live

    def priced_scatter(new, lane, rows, live):
        scatter(new, lane, rows, live)
        R = rows["alive"].shape[0] - 1
        note("lane_scatter", lane.shape[0], lane < R, lane_scatter_work(lane, R))

    fused.step_probe, fused.glossy_rays, fused.step_consume = (priced_probe, priced_rays,
                                                               priced_consume)
    intersect.nearest_hit_sweep, intersect.shadow_sweep = priced_sweep, priced_shadow
    lane_map.compact, lane_map.scatter = priced_compact, priced_scatter
    try:
        yield calls
    finally:
        fused.step_probe, fused.glossy_rays, fused.step_consume = probe, rays, consume
        intersect.nearest_hit_sweep, intersect.shadow_sweep = sweep, shadow
        lane_map.compact, lane_map.scatter = compact, scatter
