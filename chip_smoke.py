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
 10. aa        96×54 edge AA (k = 4) on both routes: re-rendered pixels
               within 1e-5 of the card's uniform SSAA, every other pixel
               the 1-spp frame's bit for bit, the card's image against the
               CPU's by the gate's criterion
 11. aa 1080p  the demo frame with with_aa_preset("ultra") on the probe
               route: edge pixels against the budget and the share left at
               1 spp, the edge pass's probe launches, the edge-AA frame's
               time beside the 1-spp frame's (CUDA events, same call)
 12. chunk     96×54 with ray_chunk = 1024 against the unchunked render
 13. debug     render_debug at 96×54, bounce 0 and 1, card against CPU:
               type and index equal but on lanes where t ties, a torus is
               involved or a silhouette ray hits on one side only (counted,
               at most 0.5 %); t within 1e-4 relative; normals within 1e-4
               on all but 0.1 % of the lanes and 1e-3 on every one
 14. checkpoint  48×27, 6 Adam steps on each route: two plain runs (are
               they bit-identical on the card?), 4 steps with a checkpoint
               every 2 and a resume to 6 in a fresh optimiser; the
               restored parameters and Adam moments equal the saved ones
               bit for bit
 15. demo      apps.demo.main at 1920×1080, 3 frames, --aa ultra, a short
               --fly script, the last frame written as a PNG (in a
               temporary directory) and read back
 16. texel determinism  48×27, 4 Adam steps on the sphere and box texture
               contents, twice, on each route: losses and texels bit for
               bit; the same with the former index_add_ backward, recorded
 17. dist world 1  a world of one rank in this process (nccl): the 1080p
               render_sharded against render bit for bit; one
               make_train_step step on the probe route (every float leaf)
               against a plain render and backward of the same loss; the
               frame's and the step's ms
 18. dist world 2  two ranks spawned on the one card (gloo): the same
               checks on every rank, the ranks' ms
 19. ring      ring_nearest_hit over worlds of 2 and 4 on the one card
               against the whole scene's nearest hit on the 1080p primary
               rays (type and index on at least 1 − 1e-5 of the lanes, t
               equal where they agree), the tie scene (8 identical spheres)
               at index 0, nearest_hit launches per sweep, the sweep's ms
 20. entry     entry()'s render on the card, then dryrun_multichip(2)
 21. live      apps.live.main at 1920×1080 for 8 s on a free port of
               127.0.0.1: one JPEG read from /stream decodes to
               (1080, 1920, 3); its FPS
The nearest-hit libraries of the ring's shard topologies are built in
phase 1, before any rank is spawned.  Every phase from 4 on counts kernel
launches from zero around its own run (a spawned rank counts its own and
returns them) and fails if a kernel of its path did not launch.
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
AA_K = 4                  # the "ultra" preset's factor
AA_FRAMES = 3
CK_W, CK_H, CK_STEPS = 48, 27, 6
TX_W, TX_H, TX_STEPS = 48, 27, 4
DIST_REPS = 3
RING_WORLDS = (2, 4)
LIVE_SECONDS = 8.0
# a sharded train step's gradient against a plain render and backward of
# the same loss: ||g - g_ref|| <= DIST_REL ||g_ref|| + GRAD_ABS per leaf
# (the same per-lane work, float32 sums over the rays in another order)
DIST_REL = 1e-4

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


# -- the ranks of the spawned worlds (phases dist world 2 and ring) -----------
# Module-level, so a spawned rank imports them by name; each returns numpy
# arrays and its own kernel launch counts.


def keep_grads_sgd(params):
    """An SGD optimiser (lr 1e-3) that keeps each step's gradients in
    ``.grads``, so a train step's all_reduced gradients can be read."""
    import torch

    class KeepGrads(torch.optim.SGD):
        def step(self, closure=None):
            self.grads = [p.grad.detach().clone() for p in self.param_groups[0]["params"]]
            return super().step(closure)

    return KeepGrads(params, lr=1e-3)


def host_ms(fn, reps):
    """Mean host-clock ms of ``fn`` in every rank of the world, started
    together after a barrier and fenced by a synchronize."""
    import torch
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def tie_scene():
    """8 identical spheres: every ray that hits ties across all of them."""
    from txr_torch.scene.factories import SceneBuilder

    b = SceneBuilder(camera_pos=(0, 0, -5))
    for _ in range(8):
        b.add_sphere((0, 0, 3), 1.0, b.material((1, 0, 0)))
    return b.build()


def ring_part(device, width, height, reps):
    """The ring sweep of the demo's primary rays and of the tie scene's
    over a 1-axis mesh of every rank → dict(demo, tie: (t, type, index) as
    numpy, launches of one demo sweep, ms of one sweep)."""
    import torch

    from txr_torch.apps.demo import build_scene
    from txr_torch.dist.mesh import make_mesh, world
    from txr_torch.dist.ring import ring_nearest_hit
    from txr_torch.kernels import launch_counts, reset_launch_counts
    from txr_torch.render.raygen import primary_rays

    n, _ = world()
    mesh = make_mesh((n,), axis_names=("ring",))
    out = {}
    for name, scene in (("demo", build_scene()[0]), ("tie", tie_scene())):
        scene = scene.to(device)
        ro, rd = primary_rays(scene.camera, width, height, 1)
        reset_launch_counts()
        res = ring_nearest_hit(scene, ro, rd, mesh, device=device)
        torch.cuda.synchronize()
        if name == "demo":
            out["launches"] = launch_counts()
            out["ms"] = host_ms(lambda: ring_nearest_hit(scene, ro, rd, mesh, device=device),
                                reps)
        out[name] = tuple(x.cpu().numpy() for x in res)
    return out


def dist_rank(device, width, height, reps):
    """One rank of the world of 2: the 1080p sharded frame and one sharded
    train step on the probe route (target 0.9 × the frame, every float
    leaf, SGD), each timed; then the ring sweep."""
    import torch

    from txr_torch.apps.demo import build_scene, demo_textures
    from txr_torch.dist.mesh import make_mesh
    from txr_torch.dist.sharded import make_train_step, render_sharded
    from txr_torch.kernels import launch_counts, reset_launch_counts
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps

    scene = build_scene()[0].to(device)
    textures = with_mips(demo_textures().to(device))
    cfg = RenderConfig(width=width, height=height, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    mesh = make_mesh()
    out = {}
    reset_launch_counts()
    with torch.no_grad():
        img = render_sharded(scene, textures, cfg, mesh, device=device)
    torch.cuda.synchronize()
    out["frame_launches"] = launch_counts()
    with torch.no_grad():
        out["frame_ms"] = host_ms(lambda: render_sharded(scene, textures, cfg, mesh,
                                                         device=device), reps)
    target = 0.9 * img
    init, step = make_train_step(textures, cfg, mesh, keep_grads_sgd, device=device)
    state = init(scene)
    reset_launch_counts()
    _, _, loss = step(scene, state, target)
    torch.cuda.synchronize()
    out["step_launches"] = launch_counts()
    out["loss"] = float(loss)
    out["grads"] = {p: g.cpu().numpy() for p, g in zip(state.params, state.optimizer.grads)}
    out["step_ms"] = host_ms(lambda: step(scene, state, target), reps)
    out["img"] = img.cpu().numpy()
    out["ring"] = ring_part(device, width, height, reps)
    return out


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
    # the tracer may drop device records, at times every one of a trace's;
    # the mean needs at least half of them, from one of three traces
    for _ in range(3):
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            times = [ms for name, ms in device_events(path) if kernel in name]
        if len(times) >= reps // 2:
            return sum(times) / len(times)
    fail(f"three traces hold at most {len(times)} launches of {kernel}, fewer than half of "
         f"the {reps} made")


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
        from txr_torch.apps import demo as demo_app
        from txr_torch.apps.demo import build_scene, demo_textures
        from txr_torch.diff import optimize as opt_mod
        from txr_torch.diff.optimize import optimize_scene
        from txr_torch.kernels import build
        from txr_torch.kernels import nearest_hit as nh
        from txr_torch.kernels import shadow_sweep as ss
        from txr_torch.kernels import step_probe as sp
        from txr_torch.kernels.scene_table import pack_scene, sections
        from txr_torch.render.intersect import nearest_hit
        from txr_torch.render.raygen import primary_rays
        from txr_torch.render import render as rr
        from txr_torch.render.render import edge_pixels, render, render_debug
        from txr_torch.render.texture import with_mips
        from txr_torch.render.trace import RenderConfig, auto_refraction_steps
        from txr_torch.scene.types import (TYPE_TORUS, flatten_with_paths, float_leaves,
                                           unflatten_like)
        from txr_torch.utils.checkpoint import load_arrays
        from txr_torch.utils.image import golden_check, load_image
        from txr_torch.dist.ring import shard_topologies
        from txr_torch.kernels import launch_counts as counts
        from txr_torch.kernels import reset_launch_counts as reset_counts
    except ImportError as e:
        fail(f"the txr_torch package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    # 1. build -----------------------------------------------------------------
    scene, _ = build_scene(W, H)
    demo_top = build.topology(pack_scene(scene, None)[1])
    t0 = time.perf_counter()
    # and the shard topologies of the ring phases (worlds of 2 and 4, the
    # demo and the tie scene), so no spawned rank compiles
    shard_tops = [lib for n in RING_WORLDS for sc in (scene, tie_scene())
                  for lib in shard_topologies(sc, n)]
    built = build.build_all([("step_probe", ()), ("shadow_sweep", ()), ("nearest_hit", demo_top)]
                            + shard_tops)
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

    # 10. edge AA at the gate's size, both routes ------------------------------
    for fused, kernels in (("auto", ("step_probe",)), ("off", ("nearest_hit", "shadow_sweep"))):
        acfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6,
                            fused=fused)
        ecfg = dataclasses.replace(acfg, supersample=AA_K)
        with torch.no_grad():
            one = render(gscene, textures, acfg, device=dev)
            ssaa = render(gscene, textures, dataclasses.replace(ecfg, aa_mode="ssaa"), device=dev)
            reset_counts()
            edge = render(gscene, textures, ecfg, device=dev)
            torch.cuda.synchronize()
            c = counts()
        chosen = torch.zeros(GATE_H * GATE_W, dtype=torch.bool, device=dev)
        chosen[edge_pixels(one, ecfg)] = True
        chosen = chosen.reshape(GATE_H, GATE_W)
        d_ssaa = float((edge - ssaa)[chosen].abs().max())
        kept = bool(torch.equal(edge[~chosen], one[~chosen]))
        ok = d_ssaa <= 1e-5 and kept and all(c[k] for k in kernels) and bool(chosen.any())
        line = (f"phase aa ({GATE_W}x{GATE_H}, k={AA_K}, fused={fused}): "
                f"{int(chosen.sum())} edge pixels re-rendered, max |edge AA - uniform SSAA| "
                f"there {d_ssaa:.3g} (limit 1e-5), other pixels equal to the 1-spp frame: "
                f"{kept}, launches {c}")
        if fused == "auto":
            cpu = render(gscene, demo_textures(), ecfg, device="cpu")
            okc, frac, worst = golden_check(edge.cpu().numpy(), cpu.numpy())
            ok = ok and okc
            line += (f"; card vs CPU edge AA: {frac:.3%} pixels over 2e-3 (limit 1.5%), worst "
                     f"interior |err| {worst:.4f} (limit 0.5)")
        log(line + (" -> PASS" if ok else " -> FAIL"))
        if not ok:
            fail(f"edge AA at {GATE_W}x{GATE_H} (fused={fused})")
        del one, ssaa, edge

    # 11. edge AA of the 1080p demo frame ("ultra"), probe route ----------------
    ucfg = cfg.with_aa_preset("ultra")
    budget = min(W * H, ucfg.edge_budget_mult * (W + H))
    with torch.no_grad():
        base = render(scene, textures, cfg, device=dev)
        n_edges = edge_pixels(base, dataclasses.replace(ucfg, edge_budget_mult=W * H)).numel()
        reset_counts()
        aa_img = rr._edge_aa(scene, textures, ucfg, base, dev)
        torch.cuda.synchronize()
        edge_launches = counts()
        finite = bool(torch.isfinite(aa_img).all())
        del base, aa_img
        one_ms = cuda_ms(lambda: render(scene, textures, cfg, device=dev), AA_FRAMES)
        aa_ms = cuda_ms(lambda: render(scene, textures, ucfg, device=dev), AA_FRAMES)
        one_ms2 = cuda_ms(lambda: render(scene, textures, cfg, device=dev), AA_FRAMES)
    left = max(0, n_edges - budget)
    aa_1080 = dict(edge_pixels=n_edges, budget=budget, left_at_1spp=left,
                   left_share=left / max(n_edges, 1), edge_rays=min(n_edges, budget) * AA_K ** 2,
                   edge_pass_launches=edge_launches, frame_1spp_ms=[one_ms, one_ms2],
                   frame_edge_aa_ms=aa_ms, ratio=aa_ms / ((one_ms + one_ms2) / 2))
    log(f"phase aa 1080p ({W}x{H}, ultra, probe route): {json.dumps(aa_1080)}"
        + (" -> PASS" if finite and edge_launches["step_probe"] else " -> FAIL"))
    if not finite or not edge_launches["step_probe"]:
        fail("1080p edge AA: not finite, or the edge pass launched no probe")

    # 12. ray chunks ------------------------------------------------------------
    ccfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6)
    with torch.no_grad():
        whole = render(gscene, textures, ccfg, device=dev)
        reset_counts()
        chunked = render(gscene, textures, dataclasses.replace(ccfg, ray_chunk=1024), device=dev)
        torch.cuda.synchronize()
        c = counts()
    d_chunk = float((whole - chunked).abs().max())
    ok = d_chunk <= 1e-6 and c["step_probe"] > 0
    log(f"phase chunk ({GATE_W}x{GATE_H}, ray_chunk=1024): max |chunked - whole| {d_chunk:.3g} "
        f"(limit 1e-6), launches {c} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("ray_chunk changes the image or launched no probe")

    # 13. debug channels, card vs CPU ------------------------------------------
    dcfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6)
    for bounce in (0, 1):
        reset_counts()
        got = render_debug(gscene, textures, dcfg, bounce, device=dev)
        torch.cuda.synchronize()
        c = counts()
        got = {k: v.cpu() for k, v in got.items()}
        ref = render_debug(gscene, demo_textures(), dcfg, bounce, device="cpu")
        both = torch.isfinite(got["t"]) & torch.isfinite(ref["t"])
        rel_t = (got["t"] - ref["t"]).abs() / ref["t"].abs().clamp(min=1e-6)
        differ = (got["type"] != ref["type"]) | (got["index"] != ref["index"])
        tie = differ & both & (rel_t <= 1e-4)
        torus = differ & ((got["type"] == TYPE_TORUS) | (ref["type"] == TYPE_TORUS))
        # a silhouette ray that one side hits and the other misses (f32 root
        # placement, as the kernel-vs-twin phases allow on a share of lanes)
        edge = differ & (torch.isfinite(got["t"]) != torch.isfinite(ref["t"])) & ~torus
        other = differ & ~tie & ~torus & ~edge
        same = ~differ & both
        plain = same & (ref["type"] != TYPE_TORUS)
        t_err = float(rel_t[plain].max()) if plain.any() else 0.0
        torus_t_err = float(rel_t[same & ~plain].max()) if (same & ~plain).any() else 0.0
        n_lane = (got["normal"] - ref["normal"]).abs().amax(-1)
        n_err = float(n_lane[plain].max()) if plain.any() else 0.0
        # unit normals: 1e-4 on all but AGREE's share of the lanes, the kernel
        # rows' ROW_ABS on every lane
        n_over = plain & (n_lane > 1e-4)
        n_over_types = sorted({int(v) for v in ref["type"][n_over]})
        alive_diff = int((got["alive"] != ref["alive"]).sum())
        need = ("nearest_hit",) + (("step_probe",) if bounce else ())
        ok = (int(differ.sum()) <= 0.005 * differ.numel() and not other.any() and t_err <= 1e-4
              and int(n_over.sum()) <= (1 - AGREE) * int(plain.sum()) + 1 and n_err <= ROW_ABS
              and torus_t_err <= T_REL and alive_diff <= 0.005 * differ.numel()
              and all(c[k] for k in need) and int(same.sum()) > 0)
        log(f"phase debug ({GATE_W}x{GATE_H}, bounce {bounce}): {int(same.sum())} hit lanes "
            f"agree on type and index; {int(differ.sum())} differ (limit 0.5%: {int(tie.sum())} "
            f"t ties, {int(torus.sum())} involving the torus, {int(edge.sum())} silhouette "
            f"hit/miss flips, {int(other.sum())} other, limit 0); max relative |t| error "
            f"{t_err:.3g} (limit 1e-4; torus lanes {torus_t_err:.3g}, limit {T_REL}); max "
            f"|normal| error {n_err:.3g} (limit {ROW_ABS}), over 1e-4 on {int(n_over.sum())} "
            f"lanes of types {n_over_types} (limit {1 - AGREE:.1%} of {int(plain.sum())}); "
            f"alive differs on {alive_diff} lanes; launches {c} -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"render_debug at bounce {bounce}: card and CPU disagree")

    # 14. checkpoint and resume on the card, both routes --------------------------
    ck_true, _ = build_scene(CK_W, CK_H)
    ck_guess = unflatten_like(ck_true, {
        "camera.pos": ck_true.camera.pos + torch.tensor([0.04, -0.03, 0.05]),
        "spheres.pos": ck_true.spheres.pos + torch.tensor([0.06, 0.04, -0.05])})
    ck_paths = ["camera.pos", "spheres.pos", "spheres.mat.color"]
    checkpoint_rows = {}
    for fused, kernels in (("off", ("nearest_hit", "shadow_sweep")), ("auto", ("step_probe",))):
        kcfg = RenderConfig(width=CK_W, height=CK_H, iterations=5,
                            extra_refraction_steps=auto_refraction_steps(ck_true), fused=fused)
        with torch.no_grad():
            ck_target = render(ck_true, textures, kcfg, device=dev)

        def run(steps, **kw):
            s, losses = optimize_scene(ck_guess, textures, kcfg, ck_target, steps=steps,
                                       lr=lambda i: 5e-3 * 0.8 ** i, param_paths=ck_paths,
                                       device=dev, **kw)
            return {k: v for k, v in flatten_with_paths(s).items() if opt_mod._selected(k, ck_paths)}, losses

        reset_counts()
        p1, l1 = run(CK_STEPS)
        torch.cuda.synchronize()
        c = counts()
        p2, l2 = run(CK_STEPS)
        plain_same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
        spread = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "run.npz")
            run(4, checkpoint_path=path, checkpoint_every=2)
            arrays = load_arrays(path)[0]
            saved_losses = [float(v) for v in arrays["losses"]]
            # restore into fresh tensors and a fresh Adam: bit for bit the saved state
            flat = flatten_with_paths(ck_guess.to(dev))
            fresh = {k: torch.zeros_like(v).requires_grad_(True) for k, v in flat.items()
                     if v.is_floating_point() and opt_mod._selected(k, ck_paths)}
            adam = torch.optim.Adam(list(fresh.values()), lr=1.0, eps=1e-8)
            step, _ = opt_mod._restore(path, fresh, adam)
            restored = step == 4 and all(
                np.array_equal(fresh[k].detach().cpu().numpy(), arrays[f"params.{k}"])
                and all(np.array_equal(adam.state[fresh[k]][m].cpu().numpy(),
                                       arrays[f"opt_state.{k}.{m}"])
                        for m in ("exp_avg", "exp_avg_sq", "step"))
                for k in fresh)
            p3, l3 = run(CK_STEPS, checkpoint_path=path, checkpoint_every=2, resume=True)
        resumed_same = l3 == l1 and all(torch.equal(p1[k], p3[k]) for k in p1)
        resumed_err = max(float((p1[k] - p3[k]).abs().max()) for k in p1)
        nondet = []
        if not plain_same:
            # name the ops with no deterministic CUDA implementation on this path
            import warnings

            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    run(1)
            finally:
                torch.use_deterministic_algorithms(False)
            nondet = sorted({str(w.message).split(" does not")[0] for w in caught
                             if "deterministic" in str(w.message)})
        ok = (restored and (resumed_same if plain_same else resumed_err <= 4 * spread)
              and len(l3) == CK_STEPS and l3[:4] == saved_losses and all(c[k] for k in kernels)
              and l1[-1] < l1[0])
        checkpoint_rows[fused] = dict(plain_bit_identical=plain_same, plain_spread=spread,
                                      resumed_bit_identical=resumed_same,
                                      resumed_max_abs_diff=resumed_err, restored_bit_for_bit=restored,
                                      nondeterministic_ops=nondet)
        log(f"phase checkpoint ({CK_W}x{CK_H}, fused={fused}, {CK_STEPS} Adam steps): losses "
            f"{[f'{v:.6g}' for v in l1]}; {json.dumps(checkpoint_rows[fused])}; launches of the "
            f"first run {c} -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"checkpoint and resume on the card (fused={fused})")

    # 15. the demo app at 1080p -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "demo_1080p_ultra.png")
        reset_counts()
        t0 = time.perf_counter()
        res = demo_app.main(["--width", str(W), "--height", str(H), "--frames", "3", "--aa",
                             "ultra", "--fly", "w:1, wd:2:4:0", "--out", png])
        demo_s = time.perf_counter() - t0
        c = counts()
        img = load_image(png)
        png_bytes = os.path.getsize(png)
    ok = (img.shape == (H, W, 4) and bool(torch.isfinite(res["img"]).all())
          and tuple(res["img"].shape) == (H, W, 3) and c["step_probe"] > 0)
    log(f"phase demo ({W}x{H}, 3 frames, --aa ultra, --fly): FPS per frame "
        f"{[round(f, 3) for f in res['fps']]}, {demo_s:.1f} s in all, wrote a {png_bytes}-byte "
        f"PNG that reads back as {img.shape}, launches {c} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("the demo app at 1080p")
    del res, img

    # 16. texel determinism: a fit of texture contents, twice, both routes ----
    from txr_torch.render.texture import TextureSet
    from txr_torch.utils import index as index_mod

    tx_scene = build_scene(TX_W, TX_H)[0].to(dev)
    raw = demo_textures()
    tx_true = [t.to(dev) for t in (*raw.sphere, raw.box)]
    trng = np.random.default_rng(1)
    tx_start = [(t * 0.8 + torch.from_numpy(trng.uniform(0.0, 0.1, tuple(t.shape))
                                            .astype(np.float32)).to(dev)).clamp(0.0, 1.0)
                for t in tx_true]

    def texset(ts):
        return TextureSet(sphere=tuple(ts[:3]), box=ts[3], ring=raw.ring.to(dev),
                          cubemap=raw.cubemap.to(dev))

    def texel_fit(tcfg, target):
        ps = [t.clone().requires_grad_(True) for t in tx_start]
        adam = torch.optim.Adam(ps, lr=1e-2, eps=1e-8)
        losses = []
        for _ in range(TX_STEPS):
            adam.zero_grad(set_to_none=True)
            loss = ((render(tx_scene, texset(ps), tcfg, device=dev) - target) ** 2).mean()
            loss.backward()
            adam.step()
            losses.append(float(loss.detach()))
        return losses, [p.detach().clone() for p in ps]

    def same_runs(a, b):
        return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1])), max(
            float((x - y).abs().max()) for x, y in zip(a[1], b[1]))

    def index_add_sum(idx, g2, rows):
        return g2.new_zeros((rows, g2.shape[1])).index_add_(0, idx, g2)

    texel_rows = {}
    for fused, kernels in (("off", ("nearest_hit", "shadow_sweep")), ("auto", ("step_probe",))):
        tcfg = RenderConfig(width=TX_W, height=TX_H, iterations=5,
                            extra_refraction_steps=auto_refraction_steps(tx_scene), fused=fused)
        ph0 = time.perf_counter()
        with torch.no_grad():
            tx_target = render(tx_scene, texset(tx_true), tcfg, device=dev)
        reset_counts()
        a = texel_fit(tcfg, tx_target)
        torch.cuda.synchronize()
        c = counts()
        same, spread = same_runs(a, texel_fit(tcfg, tx_target))
        # the former backward, index_add_ (atomic adds on the card), for the record
        kept, index_mod.segment_sum = index_mod.segment_sum, index_add_sum
        try:
            old_same, old_spread = same_runs(texel_fit(tcfg, tx_target),
                                             texel_fit(tcfg, tx_target))
        finally:
            index_mod.segment_sum = kept
        texel_rows[fused] = dict(bit_identical=same, max_abs_diff=spread,
                                 index_add_bit_identical=old_same,
                                 index_add_max_abs_diff=old_spread)
        ok = same and a[0][-1] < a[0][0] and all(c[k] for k in kernels)
        log(f"phase texel determinism ({TX_W}x{TX_H}, fused={fused}, {TX_STEPS} Adam steps on "
            f"the sphere and box texture contents, two runs): losses "
            f"{[f'{v:.6g}' for v in a[0]]}; {json.dumps(texel_rows[fused])}; launches {c}; "
            f"{time.perf_counter() - ph0:.1f} s -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"a texture-content fit is not bit-identical from run to run (fused={fused})")

    # 17. dist world 1: in process, nccl ---------------------------------------
    import torch.distributed as tdist

    from txr_torch.dist.mesh import default_backend, init_multihost, make_mesh, spawn_world
    from txr_torch.dist.sharded import make_train_step, render_sharded

    def dist_grads(got, ref):
        """Leaves over DIST_REL, and the largest relative difference."""
        bad, worst = [], 0.0
        for k, r in ref.items():
            r = torch.as_tensor(r)
            d, nrm = float((torch.as_tensor(got[k]) - r).norm()), float(r.norm())
            worst = max(worst, d / max(nrm, 1e-12) if d > GRAD_ABS else 0.0)
            if d > DIST_REL * nrm + GRAD_ABS:
                bad.append((k, d, nrm))
        return bad, worst

    ph0 = time.perf_counter()
    dcfg = RenderConfig(width=W, height=H, iterations=5,
                        extra_refraction_steps=auto_refraction_steps(scene))
    with torch.no_grad():
        frame_ref = render(scene, textures, dcfg, device=dev)
    d_target = 0.9 * frame_ref
    # the plain reference: render, then the backward of the same loss
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in float_leaves(scene).items()}
    img = render(unflatten_like(scene, leaves), textures, dcfg, device=dev)
    loss_ref = ((img - d_target) ** 2).mean()
    g_ref = {k: torch.zeros(v.shape) if g is None else g.detach().cpu()
             for (k, v), g in zip(leaves.items(), torch.autograd.grad(
                 loss_ref, list(leaves.values()), allow_unused=True))}
    loss_ref = float(loss_ref.detach())
    del img, leaves
    world_rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_multihost(init_method="file://" + os.path.join(tmp, "store"), world_size=1, rank=0,
                       backend=default_backend([dev]))
        try:
            mesh = make_mesh()
            reset_counts()
            with torch.no_grad():
                frame_1 = render_sharded(scene, textures, dcfg, mesh, device=dev)
            torch.cuda.synchronize()
            c_frame = counts()
            with torch.no_grad():
                frame_ms_1 = cuda_ms(lambda: render_sharded(scene, textures, dcfg, mesh,
                                                            device=dev), DIST_REPS)
            init_s, step_s = make_train_step(textures, dcfg, mesh, keep_grads_sgd, device=dev)
            st = init_s(scene)
            reset_counts()
            _, _, loss_1 = step_s(scene, st, d_target)
            torch.cuda.synchronize()
            c_step = counts()
            g_1 = dict(zip(st.params, (g.cpu() for g in st.optimizer.grads)))
            step_ms_1 = cuda_ms(lambda: step_s(scene, st, d_target), DIST_REPS)
            backend_1 = tdist.get_backend()
        finally:
            tdist.destroy_process_group()
    equal_1 = bool(torch.equal(frame_1, frame_ref))
    bad, worst = dist_grads(g_1, g_ref)
    loss_rel = abs(float(loss_1) - loss_ref) / loss_ref
    world_rows[1] = dict(backend=backend_1, frame_bit_identical=equal_1, frame_ms=frame_ms_1,
                         step_ms=step_ms_1, loss=float(loss_1), loss_rel_diff=loss_rel,
                         worst_grad_rel_diff=worst, frame_launches=c_frame, step_launches=c_step)
    ok = (equal_1 and not bad and loss_rel <= 1e-6 and c_frame["step_probe"] > 0
          and c_step["step_probe"] > 0)
    log(f"phase dist world 1 ({W}x{H}, in process, {backend_1}): render_sharded vs render bit "
        f"for bit: {equal_1}; one make_train_step step on the probe route (every float leaf) "
        f"vs a plain render and backward of the same loss: loss {float(loss_1):.8g} vs "
        f"{loss_ref:.8g} (relative {loss_rel:.3g}, limit 1e-6), worst leaf {worst:.3g} (limit "
        f"{DIST_REL}); frame {frame_ms_1:.2f} ms, step {step_ms_1:.1f} ms (CUDA events, "
        f"{DIST_REPS} reps); launches: frame {c_frame}, step {c_step}; "
        f"{time.perf_counter() - ph0:.1f} s -> "
        + ("PASS" if ok else f"FAIL {bad}"))
    if not ok:
        fail("dist world 1: the sharded frame or step disagrees with the plain one")
    del frame_1, st

    # 18. dist world 2: two ranks spawned on the one card ----------------------
    ph0 = time.perf_counter()
    ranks = spawn_world(2, dist_rank, W, H, DIST_REPS, device=dev)
    ref_np = frame_ref.cpu().numpy()
    equal_2 = all(np.array_equal(r["img"], ref_np) for r in ranks)
    bad2, worst2 = [], 0.0
    for r in ranks:
        b, w_ = dist_grads(r["grads"], g_ref)
        bad2 += b
        worst2 = max(worst2, w_)
    same_ranks = all(r["loss"] == ranks[0]["loss"] and all(
        np.array_equal(r["grads"][k], ranks[0]["grads"][k]) for k in g_ref) for r in ranks)
    loss_rel2 = max(abs(r["loss"] - loss_ref) / loss_ref for r in ranks)
    world_rows[2] = dict(backend="gloo", frame_bit_identical=equal_2,
                         frame_ms=max(r["frame_ms"] for r in ranks),
                         step_ms=max(r["step_ms"] for r in ranks), loss=ranks[0]["loss"],
                         loss_rel_diff=loss_rel2, worst_grad_rel_diff=worst2,
                         ranks_identical=same_ranks,
                         frame_launches=[r["frame_launches"] for r in ranks],
                         step_launches=[r["step_launches"] for r in ranks])
    ok = (equal_2 and not bad2 and loss_rel2 <= 1e-6 and same_ranks
          and all(r["frame_launches"]["step_probe"] and r["step_launches"]["step_probe"]
                  for r in ranks))
    log(f"phase dist world 2 ({W}x{H}, two ranks on one card): {json.dumps(world_rows[2])}; "
        f"frame and step ms: the slower rank's host clock over {DIST_REPS} reps after a "
        f"barrier (world 1: {frame_ms_1:.2f} and {step_ms_1:.1f} ms); the world with its ring "
        f"part {time.perf_counter() - ph0:.1f} s -> "
        + ("PASS" if ok else f"FAIL {bad2}"))
    if not ok:
        fail("dist world 2: the sharded frame or step disagrees with the plain one")
    del frame_ref, ref_np

    # 19. ring: worlds of 2 and 4 against the whole scene's nearest hit -----------
    ring_runs = {2: [r["ring"] for r in ranks]}
    del ranks
    ph0 = time.perf_counter()
    ring_runs[4] = spawn_world(4, ring_part, W, H, DIST_REPS, device=dev)
    ring4_s = time.perf_counter() - ph0
    with torch.no_grad():
        want = [x.cpu().numpy() for x in nearest_hit(scene, ro, rd, True, table)]
        # the ring's miss encoding (JAX's): index -1 where nothing is hit
        want[2] = np.where(want[1] < 0, -1, want[2])
        tie = tie_scene().to(dev)
        tro, trd = primary_rays(tie.camera, W, H)
        tie_want = [x.cpu().numpy() for x in nearest_hit(tie, tro, trd)]
    whole_ms = cuda_ms(lambda: nearest_hit(scene, ro, rd, True, table), KERNEL_REPS)
    ring_rows = {}
    for n, runs in ring_runs.items():
        t1, ty1, i1 = runs[0]["demo"]
        same_ranks = all(all(np.array_equal(a, b) for a, b in zip(r["demo"], runs[0]["demo"]))
                         for r in runs)
        agree = (ty1 == want[1]) & (i1 == want[2])
        t_equal = bool(np.array_equal(t1[agree], want[0][agree]))
        tt, tty, tidx = runs[0]["tie"]
        hit = np.isfinite(tie_want[0])
        tie_ok = (bool(hit.any()) and np.array_equal(tidx, np.where(hit, 0, -1))
                  and np.array_equal(tt, tie_want[0]))
        per_sweep = runs[0]["launches"]["nearest_hit"]
        ring_rows[n] = dict(agree_share=float(agree.mean()), disagree=int((~agree).sum()),
                            t_equal_where_agree=t_equal, tie_index0=tie_ok,
                            ranks_identical=same_ranks, launches_per_sweep_per_rank=per_sweep,
                            ms=max(r["ms"] for r in runs))
        ok = (agree.mean() >= 1 - 1e-5 and t_equal and tie_ok and same_ranks
              and all(r["launches"]["nearest_hit"] == n for r in runs))
        log(f"phase ring (world of {n} on one card, {W}x{H} primary rays of the demo scene): "
            f"{json.dumps(ring_rows[n])}; sweep ms: the slower rank's host clock over "
            f"{DIST_REPS} reps (the whole scene's nearest_hit: {whole_ms:.3f} ms by CUDA "
            f"events)" + (f"; the world of 4 {ring4_s:.1f} s" if n == 4 else "")
            + f" -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"ring sweep over {n} ranks disagrees with the whole scene's nearest hit")
    del ring_runs, want, tie_want

    # 20. entry: entry() on the card, dryrun_multichip(2) ----------------------
    from txr_torch import entry as entry_mod

    ph0 = time.perf_counter()
    reset_counts()
    efn, eargs = entry_mod.entry()
    eimg = efn(*eargs)
    torch.cuda.synchronize()
    c = counts()
    dry = entry_mod.dryrun_multichip(2)
    ok = (tuple(eimg.shape) == (108, 192, 3) and eimg.device == dev
          and bool(torch.isfinite(eimg).all())
          and c["step_probe"] > 0 and all(np.isfinite(r["loss"]) for r in dry)
          and all(r["launches"]["step_probe"] and r["launches"]["nearest_hit"] for r in dry))
    log(f"phase entry: entry() renders {tuple(eimg.shape)} on {eimg.device}, launches {c}; "
        f"dryrun_multichip(2): {dry[0]['lines']}, launches per rank "
        f"{[r['launches'] for r in dry]}; {time.perf_counter() - ph0:.1f} s -> "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("the entry points")
    del eimg

    # 21. live: the MJPEG viewer at 1080p -----------------------------------------
    import http.client
    import io
    import socket
    import threading

    from PIL import Image

    from txr_torch.apps import live as live_app

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    live = {}
    ph0 = time.perf_counter()
    reset_counts()
    runner = threading.Thread(target=lambda: live.update(res=live_app.main(
        ["--width", str(W), "--height", str(H), "--port", str(port),
         "--max-seconds", str(LIVE_SECONDS)])))
    runner.start()
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                conn.request("GET", "/stream")
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        resp = conn.getresponse()
        while resp.readline().strip() != b"--frame":
            pass
        heads = {}
        while line := resp.readline().strip():
            k, v = line.decode().split(":", 1)
            heads[k.strip().lower()] = v.strip()
        jpg = resp.read(int(heads["content-length"]))
        conn.close()
    finally:
        runner.join(LIVE_SECONDS + 120)
    c = counts()
    shape = np.asarray(Image.open(io.BytesIO(jpg))).shape
    res = live.get("res")
    ok = (not runner.is_alive() and res is not None and shape == (H, W, 3)
          and res["frames"] > 0 and c["step_probe"] > 0)
    log(f"phase live ({W}x{H}, {LIVE_SECONDS:.0f} s on 127.0.0.1:{port}): a {len(jpg)}-byte "
        f"JPEG from /stream decodes to {shape}; "
        + (f"{res['frames']} frames in {res['seconds']:.2f} s = {res['fps']:.3f} FPS"
           if res else "no result") + f", launches {c}; {time.perf_counter() - ph0:.1f} s -> "
        + ("PASS" if ok else "FAIL"))
    if not ok:
        fail("the live viewer")

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
            extra.update(frame_ms=probe_frame_ms, frame_device_ms=probe_frame_device_ms,
                         aa_1080p_edge_pass_launches=edge_launches["step_probe"])
        elif name == "nearest_hit":
            extra.update(eager_steps_ms=eager["ms"], eager_steps_device_ms=eager["device_ms"],
                         eager_steps_device_ms_every_lane=eager["every_lane_device_ms"],
                         build_s_second_topology=build2_s,
                         ring_launches_per_sweep_per_rank={
                             n: row["launches_per_sweep_per_rank"]
                             for n, row in ring_rows.items()})
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
