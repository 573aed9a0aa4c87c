#!/usr/bin/env python3
"""On-card smoke test of the txr_torch port: builds its three kernels, holds
each against its plain twin, drives the demo scene's forward render, its
gradient and a few inverse-rendering steps, and times them.  Needs one CUDA
card; run from the repository root:

    python3 chip_smoke.py

Phases, one line each:
  1. build     compile the step-probe and shadow-sweep kernels and the demo
               topology's nearest-hit kernel (its counts fixed at compile
               time) from the sources in the checkout, one nvcc each, all
               at once
  2. probe     probe kernel vs its plain PyTorch twin on the card: the demo's
               1080p primary rays plus 8192 random rays, both probe variants;
               then the state at step 1 of the 1080p frame with its alive
               mask; every lane, fills included
  3. sweeps    nearest-hit kernel vs twin on every lane, fills included:
               the same rays, then step 1's state with its alive mask, then
               the same rays on a second topology (the demo without its
               torus and ring, whose library is built at first use); no
               host synchronisation in a CUDA nearest_hit call
               (set_sync_debug_mode("error")); shadow-sweep kernel vs twin
               on the shadow rays of the 1080p primary hits toward both
               lights plus 8192 random rays, on every ray and with the need
               mask of step 0's act lanes
  4. gate      96×54 demo render on the probe route vs the f64 oracle image
               (txr/ref/gate_oracle.npz), golden criterion
  5. gate-off  the same render on the eager route (fused="off"), through the
               nearest-hit and shadow-sweep kernels
  6. forward   the 1920×1080 demo frame: finite, probe launches counted from
               zero around one frame, frame time by CUDA events; then for
               each bounce step its alive lanes, alive-and-hit lanes, rays
               crossing the torus's bounding sphere, the probe's time on the
               step's state (CUDA events through the wrapper, and the kernel's
               device time) and its two bounds, and the probe's sum per
               frame; then the eager route's nearest_hit on each of its
               bounce steps' states with their alive masks: lanes, time,
               device time (also of a sweep of every lane) and the bound of
               the live work
  7. grad      demo scene at 48×27, loss mean(img²) over the interior
               pixels: card vs CPU gradients leaf by leaf on the eager
               route, and the probe route's gradients vs the eager route's
               on the card
  8. fwd+bwd   1920×1080 forward and backward of mean(img²), both routes:
               finite and nonzero gradients, step time by CUDA events, peak
               memory, launches per kernel per step; the eager route again
               with the camera nudged by 1e-6 (how well conditioned the
               whole-frame gradient is) and without per-step checkpointing
               (its peak memory)
  9. optimize  optimize_scene, 5 Adam steps at 1080p on the camera and the
               spheres from a perturbed demo scene toward the demo frame
Then each kernel alone, one full-width launch on tables packed once, timed
through its wrapper by CUDA events (``ms``, as earlier records) and by its
device time in a torch.profiler trace (``device_ms``, the kernel alone), vs
its twin and two bounds: the work these inputs need (live lanes, the torus
only on rays crossing its sphere, a shadow ray up to its first occluder)
and the full work of every lane.  Every line those bounds counted also goes
through the uncut torus solve, which must hit no line the cull rejects.
Last, a JSON line of per-kernel numbers, the card's name and power limit,
and the line {"ok": true, "device": {...}}.  Any failure exits non-zero and
prints no result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
GATE_W, GATE_H = 96, 54
GRAD_W, GRAD_H = 48, 27
N_RANDOM = 8192
FRAMES = 5
TRAIN_STEPS = 3
OPT_STEPS = 5
KERNEL_REPS = 20

# The kernel comparisons' thresholds (as tpu_smoke.py:101-108): f32 root
# placement at silhouettes may legitimately flip a lane between kernel and
# twin, so agreement is a share of lanes, not every lane.
AGREE = 0.999
T_REL = 5e-3
ROW_ABS, ROW_REL = 1e-3, 1e-3
UV_ABS = 1e-3
# card vs CPU, and probe route vs eager route, gradients of one leaf:
# |g - g_ref| <= GRAD_REL |g_ref| + GRAD_ABS (float32 sums in another order).
# The loss sums img² over interior pixels only, whose 3×3 neighbourhood
# sees one primitive (as tests/test_grads.py picks its pixels): a pixel
# whose ray grazes a silhouette carries a gradient spike (dt/dθ ~ 1/√disc),
# so a nudge of the camera by two float32 ulps moves some leaf's
# whole-frame gradient by more than half its norm but every interior one
# by under 1 % (tests/test_torch_grads.py::test_interior_grads_are_stable).
GRAD_REL, GRAD_ABS = 2e-2, 1e-6

# H100 SXM peaks (NVIDIA data sheet): FP32 without tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# FP32 operations per ray and primitive test, hand-counted from
# txr_torch/kernels/csrc/txr_common.cuh (one per add, mul, compare, select,
# sqrt, div, min/max; a quaternion rotate is 42, and the local-frame types
# rotate origin and direction).  The torus is the Ferrari solve: a 20-step
# resolvent Newton loop (~320), the two quadratic splits, and two Newton
# steps on each of the four roots and on the winner.
TEST_OPS = dict(planes=20, spheres=26, surfaces=192, boxes=130, toruses=863,
                rings=104, lights_point=26)
ACCEPT_OPS = 4        # running (tmin, slot) update per slot
OCCLUDE_OPS = 2       # t < dist and the OR into the any-hit bit
RING_UV_OPS = 8       # shadow-ray ring (u, v)
LANE_OPS = 300        # hit info, texture request, Fresnel, Phong terms
# the torus's bounding-sphere cull (txr_common.cuh: torus_culled): the
# local-frame rotations of origin and direction, then three dot products,
# the inflated radius and the compare; a culled line stops there
TORUS_ROT_OPS = 84
TORUS_CULL_OPS = 29


def sweep_ops_per_ray(c):
    """The nearest-hit sweep over every slot (calcInter)."""
    return sum(c[k] * (TEST_OPS[k] + ACCEPT_OPS) for k in TEST_OPS)


def shadow_ops_per_ray(c, one_side=True):
    """One shadow ray's any-hit sweep, with every ring's (hit, u, v)."""
    ops = sum(c[k] * (TEST_OPS[k] + OCCLUDE_OPS)
              for k in ("spheres", "surfaces", "boxes", "toruses"))
    ops += c["rings"] * (TEST_OPS["rings"] + OCCLUDE_OPS + RING_UV_OPS)
    if not one_side:
        ops += c["planes"] * (TEST_OPS["planes"] + OCCLUDE_OPS)
    return ops


def probe_ops_per_ray(c, one_side=True):
    L = c["lights_point"] + c["lights_direct"]
    return sweep_ops_per_ray(c) + L * shadow_ops_per_ray(c, one_side) + LANE_OPS


def bound(flops, nbytes):
    """(least ms on the card, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The work these inputs need, per ray, as the redesigned kernels do it: the
# torus solve only on lines that cross its inflated bounding sphere, a
# shadow ray's occluders in the kernel's order up to the first that hits.
# Computed with the twins' primitive tests, on the card.

# every line torus_ops sees is also run through the uncut Ferrari solve: a
# culled line that the solve hits would change a pixel
CULL = dict(lines=0, culled=0, culled_hits=0)


def torus_ops(sec, o3, d3):
    """[(ops [N], crosses [N] bool)] of each torus test on rays o3, d3."""
    import torch

    from txr_torch.kernels import primitives as prim

    TO = sec["toruses"]
    out = []
    for i in range(TO.shape[0]):
        lo, ld = prim._torus_local(TO[:, 0:3], TO[:, 3:7], i, o3, d3)
        cross = ~prim._torus_culled(lo, ld, TO[i, 7], TO[i, 8])
        _, hit = prim._torus_solve(lo, ld, TO[i, 7], TO[i, 8])
        CULL["lines"] += cross.numel()
        CULL["culled"] += int((~cross).sum())
        CULL["culled_hits"] += int((hit & ~cross).sum())
        out.append((torch.where(cross, float(TEST_OPS["toruses"] + TORUS_CULL_OPS),
                                float(TORUS_ROT_OPS + TORUS_CULL_OPS)), cross))
    return out


def sweep_needed_ops(cnt, sec, o3, d3):
    """[N] operations of the nearest-hit sweep of each ray."""
    ops = sum(cnt[k] * (TEST_OPS[k] + ACCEPT_OPS) for k in TEST_OPS if k != "toruses")
    for t_ops, _ in torus_ops(sec, o3, d3):
        ops = ops + t_ops + ACCEPT_OPS
    return ops + 0.0 * o3[0]


def shadow_needed_ops(cnt, sec, o3, d3, dist, one_side=True):
    """[N] operations of each shadow ray: occluders up to the first that
    hits, in the kernel's order, then every ring's (hit, u, v)."""
    import torch

    from txr_torch.kernels.scene_table import occluder_tests

    kinds = (["spheres"] * cnt["spheres"] + ([] if one_side else ["planes"] * cnt["planes"])
             + ["boxes"] * cnt["boxes"] + ["surfaces"] * cnt["surfaces"]
             + ["toruses"] * cnt["toruses"])
    tor = iter(torus_ops(sec, o3, d3))
    ops = torch.zeros_like(o3[0])
    done = torch.zeros(o3[0].shape, dtype=torch.bool, device=o3[0].device)
    for kind, (t, h) in zip(kinds, occluder_tests(cnt, sec, o3, d3, one_side)):
        cost = next(tor)[0] if kind == "toruses" else float(TEST_OPS[kind])
        ops = ops + torch.where(done, 0.0, cost + OCCLUDE_OPS)
        done = done | (h & (t < dist))
    return ops + cnt["rings"] * (TEST_OPS["rings"] + OCCLUDE_OPS + RING_UV_OPS)


def toward_lights(scene, pt):
    """Shadow rays from points pt [M, 3] toward every light, point lights
    first, as calc_shade builds them → (origins, directions [M·L, 3],
    distances [M·L])."""
    import torch

    from txr_torch.geometry.intersect import safe_normalize
    from txr_torch.render.intersect import MAX_DIST

    d = scene.lights_point.pos - pt[:, None, :]
    n_ld = scene.counts["lights_direct"]
    dirs = torch.cat([d, (-scene.lights_direct.direction).expand((pt.shape[0], n_ld, 3))], 1)
    dist = torch.cat([torch.sqrt((d * d).sum(-1) + 1e-30),
                      torch.full((pt.shape[0], n_ld), MAX_DIST, device=pt.device)], 1)
    return (pt[:, None, :].expand(dirs.shape).reshape(-1, 3).contiguous(),
            safe_normalize(dirs).reshape(-1, 3).contiguous(), dist.reshape(-1).contiguous())


def probe_work(scene, buf, hdr, ro, rd, alive, f, i):
    """(needed operations, bytes, crossing rays) of one probe launch on the
    state ro, rd with lane mask ``alive`` (None: every lane, and no mask
    read), from its output (f, i): live lanes' sweeps, and the per-light
    shadow probes of live hits that are not light bulbs; every lane's rows
    are written, fills included (the table's bytes not counted)."""
    import torch

    from txr_torch.kernels.scene_table import SLOT_ORDER, counts_of, sections
    from txr_torch.kernels.step_probe import n_rows

    cnt, sec = sections(buf, hdr)
    lanes = (torch.arange(ro.shape[0], device=ro.device) if alive is None
             else torch.nonzero(alive).squeeze(-1))
    o, d = ro[lanes], rd[lanes]
    o3, d3 = o.unbind(-1), d.unbind(-1)
    crossing = sum(c for _, c in torus_ops(sec, o3, d3)) if cnt["toruses"] else 0 * lanes
    ops = float((sweep_needed_ops(cnt, sec, o3, d3) + LANE_OPS).sum())
    t = f[0, lanes]
    shaded = (t < 1e30) & (i[0, lanes] < sum(cnt[k] for k in SLOT_ORDER[:-1]))
    L = cnt["lights_point"] + cnt["lights_direct"]
    if L and bool(shaded.any()):
        t, o, d, n = t[shaded], o[shaded], d[shaded], f[1:4, lanes][:, shaded].T
        so = o + d * t[:, None] + n * ((9e-3 * t + 35.0) / 35e3)[:, None]
        sro, srd, sdist = toward_lights(scene, so)
        ops += float(shadow_needed_ops(cnt, sec, sro.unbind(-1), srd.unbind(-1), sdist).sum())
    mask_bytes = 0 if alive is None else 1
    nbytes = ro.shape[0] * (mask_bytes + 4 * n_rows(counts_of(hdr)) + 12) + lanes.numel() * 24
    return ops, nbytes, int((crossing > 0).sum())


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare_probe(fk, ik, fr, ir, counts):
    """Kernel output (fk, ik) vs twin output (fr, ir) → (ok, stats)."""
    import torch

    from txr_torch.kernels.step_probe import n_rows

    L = counts["lights_point"] + counts["lights_direct"]
    nr = counts["rings"]
    hk, hr = fk[0] < 1e30, fr[0] < 1e30
    both = hk & hr
    agree = both & (ik[0] == ir[0])
    stats = dict(hit_agree=float((hk == hr).float().mean()),
                 slot_agree=float(agree.sum()) / max(int(both.sum()), 1))
    a = agree
    rel = (fk[0, a] - fr[0, a]).abs() / torch.clamp(fr[0, a].abs(), min=1e-30)
    stats["t_ok"] = float((rel < T_REL).float().mean())
    binary = {4}
    for l in range(L):
        base = 23 + l * (3 + 3 * nr)
        binary |= {base + 2} | {base + 3 + 3 * j for j in range(nr)}
    # every lane, fills included: t both fills or within T_REL, 0/1 rows and
    # ints equal, the other rows within ROW_ABS + ROW_REL |y|
    lane = (ik == ir).all(0) & ((hk == hr) & (~hk | ((fk[0] - fr[0]).abs() <= T_REL * fr[0].abs())))
    for r in range(1, n_rows(counts)):
        x, y = fk[r], fr[r]
        lane &= (x == y) if r in binary else ((x - y).abs() <= ROW_ABS + ROW_REL * y.abs())
    stats["lanes_agree"] = float(lane.float().mean())
    worst_row, worst_share, max_abs = None, 1.0, 0.0
    for r in range(1, n_rows(counts)):
        x, y = fk[r, a], fr[r, a]
        if r in binary:
            share = float((x == y).float().mean())
        else:
            share = float(((x - y).abs() <= ROW_ABS + ROW_REL * y.abs()).float().mean())
            max_abs = max(max_abs, float((x - y).abs().max()))
        if share < worst_share:
            worst_row, worst_share = r, share
    for r in (1, 2):
        share = float((ik[r, a] == ir[r, a]).float().mean())
        if share < worst_share:
            worst_row, worst_share = f"i{r}", share
    stats.update(worst_row=worst_row, worst_row_share=worst_share, max_abs_err=max_abs)
    ok = (stats["hit_agree"] > AGREE and stats["slot_agree"] > AGREE
          and stats["t_ok"] >= AGREE and worst_share >= AGREE and stats["lanes_agree"] > AGREE)
    return ok, stats


def compare_nearest(tk, sk, tr, sr):
    """nearest_hit kernel (tk, sk) vs twin (tr, sr) → (ok, stats); every
    lane, fills included: a lane agrees when both hit the same slot with t
    within T_REL, or both hold the fill of a miss (INF_T, slot 0)."""
    import torch

    hk, hr = tk < 1e30, tr < 1e30
    both = hk & hr
    agree = both & (sk == sr)
    rel = (tk - tr).abs() / tr.abs().clamp(min=1e-30)
    err = (tk[agree] - tr[agree]).abs()
    lane = torch.where(both, agree & (rel < T_REL), (hk == hr) & (tk == tr) & (sk == sr))
    stats = dict(hit_agree=float((hk == hr).float().mean()),
                 slot_agree=float(agree.sum()) / max(int(both.sum()), 1),
                 t_ok=float((rel[agree] < T_REL).float().mean()) if err.numel() else 1.0,
                 lanes_agree=float(lane.float().mean()),
                 max_abs_err=float(err.max()) if err.numel() else 0.0)
    ok = (stats["hit_agree"] > AGREE and stats["slot_agree"] > AGREE and stats["t_ok"] >= AGREE
          and stats["lanes_agree"] > AGREE)
    return ok, stats


def compare_shadow(k, r):
    """shadow_sweep kernel (solid, ring_hit, ring_uv) vs twin → (ok, stats)."""
    stats = dict(solid_agree=float((k[0] == r[0]).float().mean()))
    lane = k[0] == r[0]
    if k[1] is not None:
        both = k[1] & r[1]
        err = (k[2] - r[2]).abs().amax(-1)[both]
        stats.update(ring_hit_agree=float((k[1] == r[1]).float().mean()),
                     ring_hits=int(both.sum()),
                     uv_ok=float((err <= UV_ABS).float().mean()) if err.numel() else 1.0,
                     max_abs_err=float(err.max()) if err.numel() else 0.0)
        lane &= (k[1] == r[1]).all(-1) & ((k[2] - r[2]).abs() <= UV_ABS).all(-1).all(-1)
    else:
        stats["max_abs_err"] = 0.0
    stats["lanes_agree"] = float(lane.float().mean())
    ok = stats["solid_agree"] > AGREE and stats["lanes_agree"] > AGREE
    if k[1] is not None:
        ok = ok and stats["ring_hit_agree"] > AGREE and stats["uv_ok"] >= AGREE
    return ok, stats


def cuda_ms(fn, reps):
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, kernel, reps):
    """Mean device time of the CUDA kernel named ``kernel`` per call of
    ``fn``, from a torch.profiler trace of ``reps`` calls: the kernel alone,
    without the wrapper's host work or the other small ops it launches."""
    import torch

    from txr_torch.apps.profile_frame import device_events

    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        times = [ms for name, ms in device_events(path) if kernel in name]
    # the tracer may drop a few device records; the mean needs only some
    if len(times) < reps // 2:
        fail(f"the trace holds {len(times)} launches of {kernel}, fewer than half of the "
             f"{reps} made")
    return sum(times) / len(times)


def shadow_rays(scene, textures, ro, rd, table, pix):
    """The shadow rays of the primary hits toward every light, [R·L] —
    what calc_shade hands the shadow sweep on the first bounce — and its
    ``need`` mask: the step's act lanes (hits that are not a light bulb),
    repeated per light."""
    import torch

    from txr_torch.render.intersect import nearest_hit
    from txr_torch.render.trace import hit_info
    from txr_torch.scene.types import TYPE_POINT_LIGHT

    with torch.no_grad():
        t, ty, idx = nearest_hit(scene, ro, rd, True, table)
        hi = hit_info(scene, textures, ro, rd, t, ty, idx, pix)
        n = hi["normal"]
        n = torch.where(((rd * n).sum(-1) < 0)[..., None], n, -n)
        so, sd, dist = toward_lights(scene, hi["pt"] + n * hi["bias"][..., None])
        act = torch.isfinite(t) & (ty != TYPE_POINT_LIGHT)
        L = dist.shape[0] // t.shape[0]
        return so, sd, dist, act[:, None].expand(-1, L).reshape(-1).contiguous()


def frame_states(scene, textures, cfg, device):
    """The per-ray state at the start of each bounce step of one frame on
    cfg's route (the probe's ``_fused_step`` or the eager ``step_jnp``),
    recorded from render()'s own bounce loop."""
    import torch

    from txr_torch.render import trace as tr
    from txr_torch.render.render import render

    name = "step_jnp" if cfg.fused == "off" else "_fused_step"
    states, step = [], getattr(tr, name)

    def record(scene, textures, cfg, st, *args, **kw):
        states.append(st)
        return step(scene, textures, cfg, st, *args, **kw)

    setattr(tr, name, record)
    try:
        with torch.no_grad():
            render(scene, textures, cfg, device=device)
    finally:
        setattr(tr, name, step)
    return states


def without(group):
    """A scene group with no members: every tensor cut to length 0."""
    kw = {}
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        kw[f.name] = without(v) if dataclasses.is_dataclass(v) else v[:0]
    return dataclasses.replace(group, **kw)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from txr_torch.apps.demo import build_scene, demo_textures
        from txr_torch.diff.optimize import optimize_scene
        from txr_torch.kernels import build
        from txr_torch.kernels import nearest_hit as nh
        from txr_torch.kernels import shadow_sweep as ss
        from txr_torch.kernels import step_probe as sp
        from txr_torch.kernels.scene_table import pack_scene, sections
        from txr_torch.render.intersect import nearest_hit
        from txr_torch.render.raygen import primary_rays
        from txr_torch.render.render import render
        from txr_torch.render.texture import with_mips
        from txr_torch.render.trace import RenderConfig, auto_refraction_steps
        from txr_torch.scene.types import float_leaves, unflatten_like
        from txr_torch.utils.image import golden_check
    except ImportError as e:
        fail(f"the txr_torch package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    counters = dict(step_probe=sp.step_probe, nearest_hit=nh.launch, shadow_sweep=ss.launch)

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    # 1. build -----------------------------------------------------------------
    scene, _ = build_scene(W, H)
    demo_top = build.topology(pack_scene(scene, None)[1])
    t0 = time.perf_counter()
    built = build.build_all([("step_probe", ()), ("shadow_sweep", ()), ("nearest_hit", demo_top)])
    build_s = time.perf_counter() - t0
    log(f"phase build: {build_s:.1f} s for {len(built)} libraries (one nvcc each, in parallel)")
    for (name, defines), (path, nvcc_log) in built.items():
        ptxas = " | ".join(ln.strip() for ln in nvcc_log.splitlines()
                           if "registers" in ln or "spill" in ln)
        log(f"  {name} {' '.join(defines)}: {os.path.relpath(path, ROOT)} [{ptxas}]")

    scene = scene.to(dev)
    textures = with_mips(demo_textures().to(dev))
    ncount = scene.counts
    L = ncount["lights_point"] + ncount["lights_direct"]
    pix = 1.0 / H
    table = pack_scene(scene, textures.atlas)

    # 2. probe kernel vs twin --------------------------------------------------
    ro, rd = primary_rays(scene.camera, W, H)
    rng = np.random.default_rng(0)
    ro2 = rng.uniform([-12.0, -3.0, -6.0], [12.0, 6.0, 10.0], (N_RANDOM, 3))
    rd2 = rng.normal(size=(N_RANDOM, 3))
    rd2 /= np.linalg.norm(rd2, axis=-1, keepdims=True)
    ro2 = torch.from_numpy(ro2.astype(np.float32)).to(dev)
    rd2 = torch.from_numpy(rd2.astype(np.float32)).to(dev)
    ro_all = torch.cat([ro, ro2]).contiguous()
    rd_all = torch.cat([rd, rd2]).contiguous()
    err = {}
    for flipped in (True, False):
        fk, ik = sp.step_probe(scene, textures.atlas, ro_all, rd_all, pix_angle=pix,
                               shade_flipped=flipped, device=dev)
        torch.cuda.synchronize()
        buf, hdr = sp.pack_scene(scene, textures.atlas, shade_flipped=flipped)
        fr, ir = sp.step_probe_ref(buf, hdr, ro_all, rd_all, pix)
        ok, st = compare_probe(fk, ik, fr, ir, ncount)
        err["step_probe"] = max(err.get("step_probe", 0.0), st["max_abs_err"])
        log(f"phase probe (shade_flipped={flipped}, {ro_all.shape[0]} rays): "
            + json.dumps(st) + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("step_probe kernel disagrees with its twin")
        del fk, ik, fr, ir
    # with a real mask: the state at step 1 of the 1080p frame, its alive lanes
    cfg = RenderConfig(width=W, height=H, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    states = frame_states(scene, textures, cfg, dev)
    s1 = states[1]
    for flipped in (True, False):
        hdr_f = sp.set_flags(table[1], shade_flipped=flipped)
        fk, ik = sp.launch(table[0], hdr_f, s1["ro"], s1["rd"], pix, s1["alive"])
        torch.cuda.synchronize()
        fr, ir = sp.step_probe_ref(table[0], hdr_f, s1["ro"], s1["rd"], pix, s1["alive"])
        ok, st = compare_probe(fk, ik, fr, ir, ncount)
        err["step_probe"] = max(err["step_probe"], st["max_abs_err"])
        log(f"phase probe (step 1 of the 1080p frame, alive mask: {int(s1['alive'].sum())} of "
            f"{s1['alive'].numel()} lanes, shade_flipped={flipped}): " + json.dumps(st)
            + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("step_probe kernel with a lane mask disagrees with its twin")
        del fk, ik, fr, ir

    # 3. sweep kernels vs twins ------------------------------------------------
    buf, hdr = table
    # the demo without its torus and ring: zero counts, a second library
    scene2 = dataclasses.replace(scene, toruses=without(scene.toruses), rings=without(scene.rings))
    table2 = pack_scene(scene2, None)
    err["nearest_hit"] = 0.0
    build2_s = None
    for what, (b_, h_), o_, d_, alive in (
            ("the same rays, no mask", table, ro_all, rd_all, None),
            (f"step 1 of the 1080p frame, alive mask: {int(s1['alive'].sum())} of "
             f"{s1['alive'].numel()} lanes", table, s1["ro"], s1["rd"], s1["alive"]),
            (f"the same rays on a second topology {' '.join(build.topology(table2[1]))}, "
             "no mask", table2, ro_all, rd_all, None)):
        t0 = time.perf_counter()
        tk, sk = nh.launch(b_, h_, o_, d_, alive)
        torch.cuda.synchronize()
        if b_ is table2[0]:
            build2_s = time.perf_counter() - t0
            what += f", its library built at first use in {build2_s:.1f} s"
        tr, sr = nh.nearest_hit_ref(b_, h_, o_, d_, alive)
        ok, st = compare_nearest(tk, sk, tr, sr)
        err["nearest_hit"] = max(err["nearest_hit"], st["max_abs_err"])
        log(f"phase sweeps nearest_hit ({o_.shape[0]} rays, {what}): {json.dumps(st)}"
            + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("nearest_hit kernel disagrees with its twin")
        del tk, sk, tr, sr
    # a CUDA nearest_hit call waits on nothing: no sync, no host-to-device copy
    ro_g = s1["ro"].clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            nearest_hit(scene, s1["ro"], s1["rd"], True, table, alive=s1["alive"])
        nearest_hit(scene, ro_g, s1["rd"], True, table, alive=s1["alive"])
    except RuntimeError as e:
        fail(f"a CUDA nearest_hit call synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("phase sweeps nearest_hit: two calls of render.intersect.nearest_hit (detached, and "
        "with a gradient) on step 1's state under torch.cuda.set_sync_debug_mode('error'): no "
        "host synchronisation -> PASS")
    del ro_g
    so, sd, sdist, sneed = shadow_rays(scene, textures, ro, rd, table, pix)
    sdist2 = torch.from_numpy(rng.uniform(0.5, 3e4, N_RANDOM).astype(np.float32)).to(dev)
    so_all = torch.cat([so, ro2]).contiguous()
    sd_all = torch.cat([sd, rd2]).contiguous()
    sdist_all = torch.cat([sdist, sdist2]).contiguous()
    # need: step 0's act lanes per light, then a random 30 % of the random rays
    need_all = torch.cat([sneed, torch.from_numpy(rng.random(N_RANDOM) < 0.3).to(dev)])
    err["shadow_sweep"] = 0.0
    for need in (None, need_all):
        k = ss.launch(buf, hdr, so_all, sd_all, sdist_all, need)
        torch.cuda.synchronize()
        ok, st = compare_shadow(k, ss.shadow_sweep_ref(buf, hdr, so_all, sd_all, sdist_all, need))
        err["shadow_sweep"] = max(err["shadow_sweep"], st["max_abs_err"])
        what = "every ray" if need is None else f"need mask: {int(need.sum())} rays"
        log(f"phase sweeps shadow_sweep ({so_all.shape[0]} rays: {L} lights x {ro.shape[0]} "
            f"primary rays + {N_RANDOM} random; {what}): {json.dumps(st)}"
            + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("shadow_sweep kernel disagrees with its twin")
        del k
    del so_all, sd_all, sdist_all, need_all

    # 4-5. gate, both routes -----------------------------------------------------
    gscene, _ = build_scene(GATE_W, GATE_H)
    want = np.load(os.path.join(ROOT, "txr", "ref", "gate_oracle.npz"))["img"]
    for fused, kernels in (("auto", ("step_probe",)), ("off", ("nearest_hit", "shadow_sweep"))):
        gcfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6,
                            fused=fused)
        reset_counts()
        got = render(gscene, textures, gcfg, device=dev).cpu().numpy()
        c = counts()
        ok, frac, worst = golden_check(got, want)
        name = "gate" if fused == "auto" else "gate-off"
        log(f"phase {name} ({GATE_W}x{GATE_H}, fused={fused}): {frac:.3%} pixels over 2e-3 "
            f"(limit 1.5%), worst interior |err| {worst:.4f} (limit 0.5), launches {c} -> "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok or not all(c[k] for k in kernels):
            fail(f"{name} render does not match the oracle or did not launch {kernels}")

    # 6. 1080p forward -----------------------------------------------------------
    reset_counts()
    img = render(scene, textures, cfg, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    finite = bool(torch.isfinite(img).all())
    if img.shape != (H, W, 3) or not finite or launches["step_probe"] == 0:
        fail(f"1080p frame: shape {tuple(img.shape)}, finite {finite}, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(lambda: render(scene, textures, cfg, device=dev), FRAMES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase forward ({W}x{H}): {frame_ms:.2f} ms/frame, {W * H / frame_ms * 1e3:.4g} "
        f"rays/s, launches {launches}/frame, peak {peak_gb:.2f} GB")
    target = img.detach()
    del img
    # the probe on each bounce step's state: lanes, work, time, bounds
    probe_frame_ms = probe_frame_device_ms = 0.0
    for k, st in enumerate(states):
        args = (buf, hdr, st["ro"], st["rd"], pix, st["alive"])
        fk, ik = sp.launch(*args)
        ms = cuda_ms(lambda: sp.launch(*args), KERNEL_REPS)
        dev_ms = device_ms(lambda: sp.launch(*args), "step_probe_kernel", KERNEL_REPS)
        probe_frame_ms += ms
        probe_frame_device_ms += dev_ms
        ops, nbytes, crossing = probe_work(scene, buf, hdr, st["ro"], st["rd"], st["alive"], fk, ik)
        need_ms, need_by = bound(ops, nbytes + buf.numel() * 4)
        full_ms, full_by = bound(probe_ops_per_ray(ncount) * W * H, nbytes + buf.numel() * 4)
        hits = int((st["alive"] & (fk[0] < 1e30)).sum())
        log(f"phase forward step {k}: alive {int(st['alive'].sum())}, alive and hit {hits}, "
            f"crossing the torus sphere {crossing} (of the alive), probe {ms:.4f} ms through "
            f"its wrapper by CUDA events (kernel device time {dev_ms:.4f} ms), bound "
            f"{need_ms:.4f} ms by {need_by} for this work ({ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.0f} MB), {full_ms:.4f} ms by {full_by} at full work")
        del fk, ik
    log(f"phase forward: probe {probe_frame_ms:.3f} ms per frame over {len(states)} bounce "
        f"steps by CUDA events ({probe_frame_device_ms:.3f} ms kernel device time; the glossy "
        f"passes' launches not included)")
    del states, s1
    # the eager route's nearest_hit on each bounce step's state, as step_jnp
    # calls it (the alive mask), beside a sweep of every lane of the state
    cnt, sec = sections(buf, hdr)
    eager = dict(ms=0.0, device_ms=0.0, every_lane_device_ms=0.0)
    for k, st in enumerate(frame_states(scene, textures, dataclasses.replace(cfg, fused="off"),
                                        dev)):
        o_, d_, alive = st["ro"], st["rd"], st["alive"]
        ms = cuda_ms(lambda: nh.launch(buf, hdr, o_, d_, alive), KERNEL_REPS)
        dms = device_ms(lambda: nh.launch(buf, hdr, o_, d_, alive), "nearest_hit_kernel",
                        KERNEL_REPS)
        ems = device_ms(lambda: nh.launch(buf, hdr, o_, d_), "nearest_hit_kernel", KERNEL_REPS)
        for key, v in zip(eager, (ms, dms, ems)):
            eager[key] += v
        lanes = torch.nonzero(alive).squeeze(-1)
        o3, d3 = o_[lanes].unbind(-1), d_[lanes].unbind(-1)
        crossing = int(sum(c for _, c in torus_ops(sec, o3, d3)).sum()) if cnt["toruses"] else 0
        ops = float(sweep_needed_ops(cnt, sec, o3, d3).sum())
        # the mask read and (t, slot) written for every lane, the live lanes' rays read
        nbytes = o_.shape[0] * (1 + 8) + lanes.numel() * 24 + buf.numel() * 4
        need_ms, need_by = bound(ops, nbytes)
        log(f"phase forward eager step {k}: alive {lanes.numel()}, crossing the torus sphere "
            f"{crossing} (of the alive), nearest_hit {ms:.4f} ms through its wrapper by CUDA "
            f"events (kernel device time {dms:.4f} ms; every lane, no mask, {ems:.4f} ms), bound {need_ms:.4f} ms by {need_by} for the live work "
            f"({ops / 1e9:.4f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"phase forward eager: nearest_hit {eager['ms']:.4f} ms per frame over its bounce "
        f"steps by CUDA events (device {eager['device_ms']:.4f} ms; every lane "
        f"{eager['every_lane_device_ms']:.4f} ms; the glossy passes not included)")

    # 7. gradients: card vs CPU, probe route vs eager route ----------------------
    def interior(w, h):
        """[h, w] mask of pixels whose 3×3 neighbours hit the same primitive
        first (CPU sweep)."""
        s, _ = build_scene(w, h)
        with torch.no_grad():
            pro, prd = primary_rays(s.camera, w, h)
            _, ty, idx = nearest_hit(s, pro, prd)
            slot = (ty * 1000 + idx).reshape(1, 1, h, w).double()
            pad = lambda x: torch.nn.functional.pad(x, (1, 1, 1, 1), mode="replicate")
            hi = torch.nn.functional.max_pool2d(pad(slot), 3, 1)
            lo = -torch.nn.functional.max_pool2d(pad(-slot), 3, 1)
        return (hi == lo).reshape(h, w)

    def grads(w, h, device, tex, fused, mask):
        s, _ = build_scene(w, h)
        leaves = float_leaves(s)
        for v in leaves.values():
            v.requires_grad_(True)
        gcfg = RenderConfig(width=w, height=h, iterations=5,
                            extra_refraction_steps=auto_refraction_steps(s), fused=fused)
        img = render(s, tex, gcfg, device=device)
        loss = (img * img * mask.to(img.device)[..., None]).sum() / (w * h)
        g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return {k: torch.zeros_like(v) if x is None else x.detach().cpu()
                for (k, v), x in zip(leaves.items(), g)}

    def grad_diff(got, ref):
        """Leaves over the bound, and the largest |g − g_ref| / (|g_ref| + tiny)."""
        bad, worst = [], 0.0
        for k, r in ref.items():
            d, n = float((got[k] - r).norm()), float(r.norm())
            worst = max(worst, d / max(n, 1e-12) if d > GRAD_ABS else 0.0)
            if d > GRAD_REL * n + GRAD_ABS:
                bad.append((k, d, n))
        return bad, worst

    mask = interior(GRAD_W, GRAD_H)
    g_cpu = grads(GRAD_W, GRAD_H, torch.device("cpu"), demo_textures(), "off", mask)
    g_off = grads(GRAD_W, GRAD_H, dev, textures, "off", mask)
    g_fused = grads(GRAD_W, GRAD_H, dev, textures, "auto", mask)
    nonzero = sum(float(v.abs().sum()) > 0 for v in g_cpu.values())
    for name, got, ref in (("card vs CPU, fused=off", g_off, g_cpu),
                           ("card, fused=auto vs fused=off", g_fused, g_off)):
        bad, worst = grad_diff(got, ref)
        log(f"phase grad ({GRAD_W}x{GRAD_H}, {int(mask.sum())} interior pixels, {name}): "
            f"{len(ref)} leaves ({nonzero} nonzero "
            f"on the CPU), worst relative difference {worst:.3g} (limit {GRAD_REL}) -> "
            + ("PASS" if not bad else f"FAIL {bad}"))
        if bad or not nonzero:
            fail(f"gradients differ ({name})")

    # 8. 1080p forward + backward ------------------------------------------------
    scene_cpu, _ = build_scene(W, H)
    train = {}

    def train_step(fused, remat=True, nudge=0.0):
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in float_leaves(scene_cpu).items()}
        if nudge:
            moved = leaves["camera.pos"].detach() + torch.tensor([nudge, 0.0, 0.0], device=dev)
            leaves["camera.pos"] = moved.requires_grad_(True)
        s = unflatten_like(scene_cpu, leaves)
        tcfg = RenderConfig(width=W, height=H, iterations=5,
                            extra_refraction_steps=auto_refraction_steps(scene_cpu),
                            fused=fused, remat=remat)
        img = render(s, textures, tcfg, device=dev)
        return leaves, torch.autograd.grad((img * img).mean(), list(leaves.values()),
                                           allow_unused=True)

    for fused in ("off", "auto"):
        reset_counts()
        leaves, g = train_step(fused)
        torch.cuda.synchronize()
        c = counts()
        finite = all(bool(torch.isfinite(x).all()) for x in g if x is not None)
        total = sum(float(x.abs().sum()) for x in g if x is not None)
        kernels = ("nearest_hit", "shadow_sweep") if fused == "off" else ("step_probe",)
        if not finite or total == 0.0 or not all(c[k] for k in kernels):
            fail(f"1080p fwd+bwd (fused={fused}): finite {finite}, sum |g| {total}, "
                 f"launches {c}")
        del leaves, g
        torch.cuda.reset_peak_memory_stats()
        step_ms = cuda_ms(lambda: train_step(fused), TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        train[fused] = dict(step_ms=step_ms, peak_gb=peak, launches=c)
        log(f"phase fwd+bwd ({W}x{H}, fused={fused}): {step_ms:.1f} ms/step over "
            f"{TRAIN_STEPS} steps, peak {peak:.2f} GB, launches per step {c}, "
            f"sum |g| {total:.4g}, all finite -> PASS")
    # the whole-frame gradient's conditioning: the same step with the camera
    # moved by about two float32 ulps
    _, g = train_step("off", nudge=1e-6)
    log(f"phase fwd+bwd ({W}x{H}, fused=off, camera x + 1e-6): sum |g| "
        f"{sum(float(x.abs().sum()) for x in g if x is not None):.4g}")
    del g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        train_step("off", remat=False)
        torch.cuda.synchronize()
        log(f"phase fwd+bwd ({W}x{H}, fused=off, remat=False): "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms for one step (host clock), peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    except torch.cuda.OutOfMemoryError:
        log(f"phase fwd+bwd ({W}x{H}, fused=off, remat=False): out of device memory")
    torch.cuda.empty_cache()

    # 9. optimize ----------------------------------------------------------------
    guess = unflatten_like(scene_cpu, {
        "camera.pos": scene_cpu.camera.pos + torch.tensor([0.04, -0.03, 0.05]),
        "spheres.pos": scene_cpu.spheres.pos + torch.tensor([0.06, 0.04, -0.05])})
    ocfg = RenderConfig(width=W, height=H, iterations=5,
                        extra_refraction_steps=auto_refraction_steps(scene_cpu), fused="off")
    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "steps.jsonl")
        _, losses = optimize_scene(guess, textures, ocfg, target, steps=OPT_STEPS, lr=5e-3,
                                   param_paths=["camera.pos", "spheres.pos",
                                                "spheres.mat.color"],
                                   metrics_path=metrics, device=dev)
        with open(metrics) as f:
            walls = [json.loads(line)["wall_s"] for line in f]
    ok = losses[-1] < losses[0] and all(np.isfinite(losses))
    log(f"phase optimize ({W}x{H}, fused=off, {OPT_STEPS} Adam steps): losses "
        f"{[f'{v:.6g}' for v in losses]}, wall s per step {walls} -> "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("optimize_scene did not lower the loss")

    # each kernel alone, on tables packed once, at the widths of earlier
    # records: the 1080p primary rays, in raster order, every lane live (the
    # probe, the sweep);
    # their shadow rays toward both lights (the shadow sweep, with the need
    # mask of step 0's act lanes as the eager route passes it, and without)
    n, ns = ro.shape[0], so.shape[0]
    tab = buf.numel() * 4
    full = dict(step_probe=(probe_ops_per_ray(ncount) * n, n * (24 + 4 * sp.n_rows(ncount) + 12)),
                nearest_hit=(sweep_ops_per_ray(ncount) * n, n * (24 + 8)),
                shadow_sweep=(shadow_ops_per_ray(ncount) * ns,
                              ns * (28 + 4 + 12 * ncount["rings"])))
    fk, ik = sp.launch(buf, hdr, ro, rd, pix)
    p_ops, p_bytes, _ = probe_work(scene, buf, hdr, ro, rd, None, fk, ik)
    del fk, ik
    o3, d3 = ro.unbind(-1), rd.unbind(-1)
    lanes = torch.nonzero(sneed).squeeze(-1)
    s_ops = float(shadow_needed_ops(cnt, sec, so[lanes].unbind(-1), sd[lanes].unbind(-1),
                                    sdist[lanes]).sum())
    needed = dict(step_probe=(p_ops, p_bytes),
                  nearest_hit=(float(sweep_needed_ops(cnt, sec, o3, d3).sum()), n * (24 + 8)),
                  shadow_sweep=(s_ops, ns * (1 + 4 + 12 * ncount["rings"]) + lanes.numel() * 28))
    runs = dict(step_probe=(lambda: sp.launch(buf, hdr, ro, rd, pix),
                            lambda: sp.step_probe_ref(buf, hdr, ro, rd, pix)),
                nearest_hit=(lambda: nh.launch(buf, hdr, ro, rd),
                             lambda: nh.nearest_hit_ref(buf, hdr, ro, rd)),
                shadow_sweep=(lambda: ss.launch(buf, hdr, so, sd, sdist, sneed),
                              lambda: ss.shadow_sweep_ref(buf, hdr, so, sd, sdist, sneed)))
    sources = dict(step_probe="txr/kernels/pallas_step.py:652",
                   nearest_hit="txr/kernels/pallas_intersect.py:375",
                   shadow_sweep="txr/kernels/pallas_intersect.py:489")
    main_launches = dict(step_probe=launches["step_probe"],
                         nearest_hit=train["off"]["launches"]["nearest_hit"],
                         shadow_sweep=train["off"]["launches"]["shadow_sweep"])
    rows = []
    for name, (kernel, twin) in runs.items():
        ms = cuda_ms(kernel, KERNEL_REPS)
        extra = dict(device_ms=device_ms(kernel, f"{name}_kernel", KERNEL_REPS))
        twin()
        plain_ms = cuda_ms(twin, 2)
        bound_ms, bound_by = bound(needed[name][0], needed[name][1] + tab)
        full_ms, full_by = bound(full[name][0], full[name][1] + tab)
        rays = n if name != "shadow_sweep" else ns
        if name == "step_probe":
            extra.update(frame_ms=probe_frame_ms, frame_device_ms=probe_frame_device_ms)
        elif name == "nearest_hit":
            extra.update(eager_steps_ms=eager["ms"], eager_steps_device_ms=eager["device_ms"],
                         eager_steps_device_ms_every_lane=eager["every_lane_device_ms"],
                         build_s_second_topology=build2_s)
        elif name == "shadow_sweep":
            every_ray = lambda: ss.launch(buf, hdr, so, sd, sdist)
            extra.update(ms_every_ray=cuda_ms(every_ray, KERNEL_REPS),
                         device_ms_every_ray=device_ms(every_ray, "shadow_sweep_kernel",
                                                       KERNEL_REPS))
        log(f"kernel {name}: {ms:.4f} ms per launch at {rays} rays, through its wrapper by "
            f"CUDA events (twin {plain_ms:.1f} ms), "
            f"bound {bound_ms:.4f} ms by {bound_by} for the work these inputs need "
            f"({needed[name][0] / 1e9:.3f} GFLOP, {(needed[name][1] + tab) / 1e6:.0f} MB), "
            f"{full_ms:.4f} ms by {full_by} at full work ({full[name][0] / 1e9:.2f} GFLOP); "
            + json.dumps(extra))
        rows.append(dict(name=name, route="cuda", source=f"txr_torch/kernels/csrc/{name}.cu",
                         replaces=sources[name], launches=main_launches[name],
                         max_abs_err=err[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, bound_full_ms=full_ms,
                         bound_full_by=full_by, **extra))

    log(f"phase torus cull (every line the bounds above counted: the frame's bounce steps, "
        f"their shading probes' shadow rays, the primary rays and step 0's eager shadow rays): "
        f"{CULL['lines']} lines, {CULL['culled']} culled, {CULL['culled_hits']} culled lines "
        f"that the uncut Ferrari solve hits -> {'PASS' if not CULL['culled_hits'] else 'FAIL'}")
    if CULL["culled_hits"] or not CULL["culled"]:
        fail("the torus cull rejects a line that the uncut solve hits, or saw no line")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
