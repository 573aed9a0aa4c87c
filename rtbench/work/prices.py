"""The least time of a frame's kernel work on one H100: a frozen copy of
the program's price model (txr_torch/utils/flops.py as of its consume
kernel), priced from lane counts that the benchmark's own reference run
makes (``reference.render.trace``'s tally), never from the program's
launch arguments.  So the same frame reads the same least time whatever
kernels the program runs it with.

Prices: hand counts of each intersector's operations per (ray, primitive),
a torus whose bounding sphere the line misses at one sphere test, a shadow
ray that some solid occluder stops at its cheapest occluder test (and its
rings); each live lane's rows read and written once; the scene table read
once a launch.  A kernel's least time is the larger of its operations
over the FP32 peak and its bytes over the memory rate.
"""

from __future__ import annotations

# per-(ray, primitive) operations (txr/kernels/pallas_intersect.py's math)
TEST_FLOPS = {"planes": 20, "spheres": 25, "surfaces": 180, "boxes": 120, "toruses": 500,
              "rings": 95, "lights_point": 25}
ACCEPT_FLOPS = 3
CULLED_TORUS_FLOPS = TEST_FLOPS["spheres"]
OCCLUDERS = ("spheres", "surfaces", "boxes", "toruses")
# the consume's operations per live lane, surface hit, shading lane, light
# and textured fetch; the glossy ray's
CONSUME_FLOPS = dict(live=1, act=40, shade=21, light=21, texel=120)
GLOSSY_RAY_FLOPS = 25
# a lane's bounce state: ro, rd, color, mask f32[3], absorb f32, bounces
# i32, alive and missed u8
STATE_BYTES = 4 * 12 + 4 + 4 + 1 + 1
# the probe's rows before its per-light rows
BASE_ROWS = 23
# the packed scene table's floats per primitive (scene_table.REC) and per
# slot (material 12, texture slot 1)
RECORD_FLOATS = dict(planes=6, spheres=9, surfaces=19, boxes=10, toruses=9, rings=9,
                     lights_point=7, lights_direct=4)
SLOTS = ("planes", "spheres", "surfaces", "boxes", "toruses", "rings", "lights_point")

# NVIDIA H100 SXM (data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12


def bound_ms(ops, nbytes):
    """The least milliseconds for ``ops`` FP32 operations moving
    ``nbytes`` bytes."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S) * 1e3


def n_lights(cnt):
    return cnt["lights_point"] + cnt["lights_direct"]


def table_floats(cnt, n_textures):
    """Floats of the packed scene table: every record, each slot's
    material and texture slot, the textures' sizes and the shading
    constants."""
    slots = sum(cnt[k] for k in SLOTS)
    return (sum(RECORD_FLOATS[k] * cnt[k] for k in RECORD_FLOATS) + 13 * slots
            + 2 * max(n_textures, 1) + 6 + 3 * n_lights(cnt) + cnt["rings"])


def n_rows(cnt):
    return BASE_ROWS + n_lights(cnt) * (3 + 3 * cnt["rings"])


def sweep_flops(cnt):
    """Operations of one nearest-hit test of a ray against every slot."""
    return sum(cnt[k] * (per + ACCEPT_FLOPS) for k, per in TEST_FLOPS.items())


def _torus(cross, n, full):
    """Torus tests of n lines, ``cross`` [per torus] crossing its sphere."""
    return sum(c * full + (n - c) * CULLED_TORUS_FLOPS for c in cross)


def sweep_ops(cnt, n, cross):
    """A nearest-hit sweep of n lines."""
    flat = sweep_flops(cnt) - cnt["toruses"] * (TEST_FLOPS["toruses"] + ACCEPT_FLOPS)
    return n * flat + _torus(cross, n, TEST_FLOPS["toruses"] + ACCEPT_FLOPS)


def shadow_ops(cnt, n, solid, cross_clear, one_side=True):
    """Shadow any-hit sweeps of n rays, ``solid`` of them stopped by a solid
    occluder, ``cross_clear`` [per torus] of the others crossing it."""
    kinds = [k for k in OCCLUDERS if cnt[k]] + ([] if one_side or not cnt["planes"]
                                                  else ["planes"])
    rings = cnt["rings"] * (TEST_FLOPS["rings"] + 1)
    cheapest = min((TEST_FLOPS[k] + 1 for k in kinds), default=0)
    clear = n - solid
    flat = sum(cnt[k] * (TEST_FLOPS[k] + 1) for k in kinds if k != "toruses")
    return solid * (cheapest + rings) + clear * (flat + rings) + _torus(
        cross_clear, clear, TEST_FLOPS["toruses"] + 1)


def probe(cnt, n_tex, rec, shadow_enabled=True, one_side=True):
    """(operations, bytes) of one step-probe launch: a sweep of its live
    lanes, and from each of their hits that is not a light bulb a shadow
    sweep toward each light; each live lane's ray in and rows out, the
    table once.  ``rec``: dict(live, cross, shadows=[dict(n, solid,
    cross_clear)] per light)."""
    ops = sweep_ops(cnt, rec["live"], rec["cross"])
    nbytes = rec["live"] * (24 + 4 * n_rows(cnt) + 12) + table_floats(cnt, n_tex) * 4
    if shadow_enabled and n_lights(cnt):
        for s in rec["shadows"]:
            ops += shadow_ops(cnt, s["n"], s["solid"], s["cross_clear"], one_side)
    return ops, nbytes


def glossy_rays(rec):
    """(operations, bytes) of one glossy-rays launch: each live lane's
    alive bit and t, each hit's slot, each surface hit's index of
    refraction, each glossy lane's rows and ray.  ``rec``: dict(live, hit,
    surf, glossy)."""
    nbytes = (rec["live"] * (2 + 4) + rec["hit"] * 4 + rec["surf"] * 4
              + rec["glossy"] * (24 + 12 + 8 + 24))
    return rec["live"] * CONSUME_FLOPS["live"] + rec["glossy"] * GLOSSY_RAY_FLOPS, nbytes


def consume(cnt, rec, shadow_enabled=True, refractive_glossy=True):
    """(operations, bytes) of one consume launch: each live lane's state in
    and out and its t, each hit's slot, each surface hit's rows, a hit
    inside a refracting body its absorption row; per shading part (the
    step's opaque hits; the glossy probe's surface hits) each lane's
    material and light rows, each textured request and the distinct
    texels it reads, and the distinct ring-alpha texels; the shading
    constants.  ``rec``: dict(live, hit, surf, refr_inside, glossy,
    glossy_hit, parts=[dict(lanes, textured, texels, ring_texels)])."""
    L, nr = n_lights(cnt), cnt["rings"]
    shade_row = 24 + L * (12 + 4 * nr if shadow_enabled else 8)
    ops = rec["live"] * CONSUME_FLOPS["live"] + rec["surf"] * CONSUME_FLOPS["act"]
    nbytes = (rec["live"] * (2 * STATE_BYTES + 4) + rec["hit"] * 4 + rec["surf"] * 32
              + rec["refr_inside"] * 12 + (6 + 3 * L + nr) * 4)
    if refractive_glossy:
        nbytes += rec["glossy"] * 4 + rec["glossy_hit"] * 4
    for p in rec["parts"]:
        ops += (p["lanes"] * (CONSUME_FLOPS["shade"] + L * CONSUME_FLOPS["light"])
                + p["textured"] * CONSUME_FLOPS["texel"])
        nbytes += p["lanes"] * shade_row + p["textured"] * 12 + p["texels"] * 16
        if shadow_enabled:
            nbytes += 4 * p["ring_texels"]
    return ops, nbytes


def frame(cnt, n_tex, tally):
    """{kernel: dict(ops, bytes, least_ms, launches)} of a frame from the
    reference's tally (passes of bounce steps): the step probe (each
    step's and its glossy probe's), the glossy rays and the consume of
    every step with a live lane."""
    out = {k: dict(ops=0.0, bytes=0.0, least_ms=0.0, launches=0)
           for k in ("step_probe", "glossy_rays", "step_consume")}

    def add(k, work):
        out[k]["ops"] += work[0]
        out[k]["bytes"] += work[1]
        out[k]["least_ms"] += bound_ms(*work)
        out[k]["launches"] += 1

    for p in tally:
        for step in p["steps"]:
            if not step["probe"]["live"]:
                continue
            add("step_probe", probe(cnt, n_tex, step["probe"]))
            if step["glossy_probe"] is not None:
                add("step_probe", probe(cnt, n_tex, step["glossy_probe"]))
            add("glossy_rays", glossy_rays(step["glossy_rays"]))
            add("step_consume", consume(cnt, step["consume"]))
    return out
