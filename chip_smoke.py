#!/usr/bin/env python3
"""On-card smoke test of the txr_torch port: builds its kernels, holds each
against its plain twin, drives the demo scene's forward render, its
gradient and a few inverse-rendering steps, and times them.  Needs one CUDA
card; run from the repository root:

    python3 chip_smoke.py

Phases, one line each:
  1. build     compile the step-probe, consume, shadow-sweep and lane-map
               kernels and the demo topology's nearest-hit kernel (its
               counts fixed at compile time) from the sources in the
               checkout, one nvcc each, all at once
  2. probe     probe kernel vs its plain PyTorch twin on the card: the demo's
               1080p primary rays plus 8192 random rays, both probe variants;
               then the state at step 1 of the 1080p frame with its alive
               mask; every lane, fills included; each launch again without
               fills (FLAG_FILL clear, as the forward path runs it) into
               rows set to NaN: the rows a reader reads those of the filled
               launch bit for bit and, the fills written in, the twin's;
               NaN on every other row
  3. sweeps    nearest-hit kernel vs twin on every lane, fills included:
               the same rays, then step 1's state with its alive mask, then
               the same rays on a second topology (the demo without its
               torus and ring, whose library is built at first use); no
               host synchronisation in a CUDA nearest_hit call
               (set_sync_debug_mode("error")); shadow-sweep kernel vs twin
               on the shadow rays of the 1080p primary hits toward both
               lights plus 8192 random rays, on every ray and with the need
               mask of step 0's act lanes
  3a. balls    the same kernels on the SPD balls table (rtbench's
               spd-balls-1080p: 7,381 spheres), which each sweeps in tiles
               (``balls_phase``): the probe on its 1080p primary rays, both
               variants, and again without fills into NaN rows, and on the
               first compacted step of a render_jit frame, each launch
               counted from zero around it, vs the twin; nearest-hit on
               the primary rays and shadow-sweep on their shadow rays, with
               and without the need mask, vs the twins; the probe's time
               and bound, its registers and blocks an SM, and the share of
               its (warp, sphere) pairs in which some lane's line crosses
               the sphere, a row ``step_probe_tiled`` of the last line
  4. gate      96×54 demo render on the probe route vs the f64 oracle image
               (txr/ref/gate_oracle.npz), golden criterion
  5. gate-off  the same render on the eager route (fused="off"), through the
               nearest-hit and shadow-sweep kernels
  6. forward   the 1920×1080 demo frame: finite, probe launches counted from
               zero around one frame, frame time by CUDA events; then for
               each bounce step its alive lanes, alive-and-hit lanes, rays
               crossing the torus's bounding sphere, the probe's time on the
               step's state without fills, as the path runs it, and with
               them (CUDA events through the wrapper, and the kernel's
               device time) and its bounds, and the probe's sum per
               frame; then the eager route's nearest_hit on each of its
               bounce steps' states with their alive masks: lanes, time,
               device time (also of a sweep of every lane) and the bound of
               the live work
  6a. probe fill  every probe launch (the step's and the glossy one) of a
               replayed 1080p render_jit frame of the demo at t = 60.5 s,
               1 spp and "ultra", at R and each compacted capacity: without
               fills into NaN rows against the filled launch (as in phase
               2), its live, missing and light-bulb lanes, its time with
               and without fills (``graph_ms``) and its bytes priced each
               way, the dead lanes' fill bytes beside; the frame's sums
  6b. consume  the consume's two kernels, glossy rays and consume
               (``consume_phase``), vs their twins on
               each bounce step's state of the 1080p frame, the same probe
               rows given to both: alive, missed and bounces equal and the
               float fields within ROW_ABS + ROW_REL |y| on more than AGREE
               of the lanes, the glossy lanes equal and their rays within
               ROW_ABS; the share of lanes that differ at all, the largest
               error, each launch's time beside its bound; then a replayed
               render_jit frame launches both
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
 15. demo      apps.demo.main at 1920×1080, 5 frames, --aa ultra, a short
               --fly script, the last frame written as a PNG (in a
               temporary directory) and read back; its frames come from
               render_jit (the first captures the graphs), FPS per frame
 16. texel determinism  48×27, 4 Adam steps on the sphere and box texture
               contents, twice, on each route: losses and texels bit for
               bit; the same with the former index_add_ backward, recorded
 17. dist world 1  a world of one rank in this process (nccl): the 1080p
               render_sharded against render bit for bit, and
               render_sharded_jit against render_sharded bit for bit; one
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
 20. entry     entry()'s render (render_jit) on the card, then
               dryrun_multichip(2)
 21. live      apps.live.main at 1920×1080 for 8 s on a free port of
               127.0.0.1: one JPEG read from /stream decodes to
               (1080, 1920, 3); its FPS, its frames from render_jit
 22. assets 8k  the demo at 45 s into its animation (jupiter and saturn in
               view) with the reference's asset class: jupiter and saturn
               made at 8192×4096 by the demo's generator, written as JPEGs
               and read back through demo_textures(asset_dir) (a: times,
               shapes); with_mips on the card, its time, peak memory and
               bytes, bit for bit the CPU's pyramid (b); 96×54 card vs CPU
               on both routes by the golden criterion (c); the 1080p frame
               on both routes, 8k and the demo's own textures in turns
               (d); the 1080p fwd+bwd on both routes with and without the
               planets' contents in the gradient, in turns, and once with
               the former segment sum, then two 2-step Adam fits of the
               contents bit for bit (e); the 48×27 texture gradients, card
               vs CPU, within 2e-2 of their norm (f)
 23. jit       render_jit, the frame in CUDA graphs (``jit_phase``): the
               96×54 gate through it on both routes (a); at 1080p on both
               routes, 1 spp and "ultra", render_jit against render bit for
               bit at the start pose and at t = 45 s, the first call's
               seconds, peak and held memory beside render's peak, the
               launches of a replayed frame, frame ms of render and
               render_jit in turns (CUDA events and host clock), and at
               1 spp a profiler trace of one replayed frame (device ms,
               busy share) whose kernel events equal the counted
               launches, the lane map's among them (b); a call that wants a gradient raises (c); a
               gather of 16-byte rows by index_select and along the
               transposed table's columns, ms and bit for bit (d)
 24. train jit  the captured train step (``train_jit_phase``) at 1080p on
               both routes, every float leaf, loss mean((img − target)²):
               the first call's seconds, peak and pool memory; the first
               loss bit for bit the op-by-op step's and each gradient
               within 1e-5 of its norm; step ms of both in turns; replays
               under set_sync_debug_mode("error"); a traced replay whose
               kernel events equal the counted launches; 5-step Adam fits
               of both within 1e-4; a resume after 2 of 4 steps bit for
               bit; make_train_step in a world of 1 against the captured
               step
The nearest-hit libraries of the ring's shard topologies are built in
phase 1, before any rank is spawned.  Every phase from 4 on counts kernel
launches from zero around its own run (a spawned rank counts its own and
returns them) and fails if a kernel of its path did not launch.
Then each kernel alone, one full-width launch on tables packed once, timed
through its wrapper by CUDA events (``ms``, as earlier records) and by its
device time in a torch.profiler trace (``device_ms``, the kernel alone; the
probe without fills, as the path runs it, and with them, ``_filled``), vs
its twin and two bounds of txr_torch/utils/flops.py: the work these inputs
need (live lanes, a torus line outside its bounding sphere as one sphere
test, a solid shadow ray at its cheapest occluder) and the full work of
every lane.  The lane map's two kernels
(``lane_map_phase``) run instead on the states each compacted step of a
1080p render_jit frame feeds them, byte for byte their twins', and their
times and bounds are the frame's sums.  Every line those bounds priced
also goes through the uncut torus solve, which must hit no line the
kernels' cull rejects.
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
PROBE_TRIALS = 7          # phase probe fill: replays of a graph of KERNEL_REPS launches
PROBE_T = 60.5            # phase probe fill: the demo's pose, seconds into its animation
AA_K = 4                  # the "ultra" preset's factor
AA_FRAMES = 3
JIT_ROUNDS = 4            # phase jit: rounds of render, render_jit, render_jit, render
CK_W, CK_H, CK_STEPS = 48, 27, 6
TX_W, TX_H, TX_STEPS = 48, 27, 4
DIST_REPS = 3
RING_WORLDS = (2, 4)
LIVE_SECONDS = 8.0
# phase balls: the configuration, the twins' chunk of lanes, timed launches
BALLS = "spd-balls-1080p"
BALLS_CHUNK = 1 << 18
BALLS_REPS = 5
# phase train jit: rounds of an eager and a captured step, in turns (the
# first of a round alternates); the Adam rate of its steps; a gradient's
# tolerance against the eager step's, relative to its norm; the fits'
# losses, relative
TRAIN_ROUNDS = 2
TRAIN_LR = 5e-3
TRAIN_REL = 1e-5
TRAIN_FIT_REL = 1e-4
# the assets-8k phases: the reference's planet textures are 8192×4096 JPEGs;
# the demo at ASSET_T seconds into its animation, where jupiter and saturn
# are both in view (at 96×54, some 200 and 40 pixels)
ASSET_H, ASSET_W = 4096, 8192
ASSET_T = 45.0
ASSET_JPEG_QUALITY = 90
ASSET_FIT_STEPS = 2
# a sharded train step's gradient against a plain render and backward of
# the same loss: ||g - g_ref|| <= DIST_REL ||g_ref|| + GRAD_ABS per leaf
# (the same per-lane work, float32 sums over the rays in another order)
DIST_REL = 1e-4

# the kernels of the probe route's bounce step (render/fused.py)
PROBE_ROUTE = ("step_probe", "glossy_rays", "step_consume")
# the kernels of a compacted bounce step's lane map (kernels/lane_map.py),
# on either route; render_jit compacts at 1080p, not at the gate's size
LANE_MAP = ("lane_compact", "lane_scatter")

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

# Every bound below is txr_torch/utils/flops.py's least time for the work
# the inputs need.  Every line it prices as a ray of a kernel is also run
# through the torus's uncut Ferrari solve: a line that the kernels' cull
# rejects and the solve hits would change a pixel.
CULL = dict(lines=0, culled=0, culled_hits=0)


def cull_check(sec, o3, d3):
    """[N] bool: the rays o3, d3 that the kernels' torus cull keeps for
    some torus; each line also through the uncut solve (counted in CULL)."""
    import torch

    from txr_torch.geometry import torus as ttorus
    from txr_torch.kernels import primitives as prim

    TO = sec["toruses"]
    kept = torch.zeros(o3[0].shape, dtype=torch.bool, device=o3[0].device)
    for i in range(TO.shape[0]):
        lo, ld = prim._torus_local(TO[:, 0:3], TO[:, 3:7], i, o3, d3)
        cross = ~prim._torus_culled(lo, ld, TO[i, 7], TO[i, 8])
        _, hit = ttorus.torus_solve(lo, ld, TO[i, 7], TO[i, 8])
        CULL["lines"] += cross.numel()
        CULL["culled"] += int((~cross).sum())
        CULL["culled_hits"] += int((hit & ~cross).sum())
        kept |= cross
    return kept


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


def probe_lines(scene, buf, hdr, ro, rd, alive, f, i):
    """The lines one probe launch on ro, rd (lane mask ``alive``, None for
    every lane) traces, from its output (f, i), through ``cull_check``: its
    live lanes, and the shadow rays of the live lanes that hit a primitive
    other than a light bulb → how many live lanes the cull keeps."""
    import torch

    from txr_torch.kernels.scene_table import SLOT_ORDER, sections

    cnt, sec = sections(buf, hdr)
    lanes = (torch.arange(ro.shape[0], device=ro.device) if alive is None
             else torch.nonzero(alive).squeeze(-1))
    o, d = ro[lanes], rd[lanes]
    kept = cull_check(sec, o.unbind(-1), d.unbind(-1))
    t = f[0, lanes]
    shaded = (t < 1e30) & (i[0, lanes] < sum(cnt[k] for k in SLOT_ORDER[:-1]))
    if bool(shaded.any()):
        t, o, d, n = t[shaded], o[shaded], d[shaded], f[1:4, lanes][:, shaded].T
        so = o + d * t[:, None] + n * ((9e-3 * t + 35.0) / 35e3)[:, None]
        sro, srd, _ = toward_lights(scene, so)
        cull_check(sec, sro.unbind(-1), srd.unbind(-1))
    return int(kept.sum())


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


def probe_into(buf, hdr, ro, rd, pix, alive, f, i):
    """The probe kernel launched on the packed table (buf, hdr) into rows
    the caller holds, f [NF, N] f32 and i [3, N] int32 (``launch`` makes
    its own): what a launch without FLAG_FILL does not store keeps its
    value."""
    from txr_torch.kernels import build
    from txr_torch.kernels import step_probe as sp
    from txr_torch.kernels.scene_table import check_mask

    mask = check_mask("step_probe", ro.device, alive, ro.shape[0])
    build.run("step_probe", "txr_step_probe", sp._ARGS, ro.device, hdr, buf.data_ptr(),
              float(pix), ro.data_ptr(), rd.data_ptr(),
              None if mask is None else mask.data_ptr(), f.data_ptr(), i.data_ptr(),
              ro.shape[0], 0, None, None)


NAN_BITS = 0x7FC00000     # NaN's bits, set in the int rows before a launch


def probe_over_nan(buf, hdr, ro, rd, pix, alive):
    """The probe kernel with the header's FLAG_FILL cleared, launched into
    rows set to NaN beforehand (the int rows to NaN's bits) → (f, i)."""
    import torch

    from txr_torch.kernels import step_probe as sp
    from txr_torch.kernels.scene_table import counts_of

    N = ro.shape[0]
    f = torch.full((sp.n_rows(counts_of(hdr)), N), float("nan"), device=ro.device)
    i = torch.full((3, N), NAN_BITS, dtype=torch.int32, device=ro.device)
    probe_into(buf, unfilled(hdr), ro, rd, pix, alive, f, i)
    return f, i


def unfilled(hdr):
    """The header ``hdr`` with FLAG_FILL cleared and every other flag kept:
    the flags of a forward step's probe and of a glossy probe."""
    from txr_torch.kernels.scene_table import FLAG_FILL

    return hdr[:9] + (hdr[9] & ~FLAG_FILL,) + hdr[10:]


def check_unfilled(fn, in_, fk, ik, alive, counts):
    """A probe launch without fills into rows set to NaN (fn, in_;
    ``probe_over_nan``) against the same launch with them (fk, ik): the
    rows a reader reads (step_probe.cu, "Lanes") bit for bit — t on every
    live lane, the base rows and ints on a live hit, every row on a live
    hit that shades, that is one that is not a light bulb — and NaN on
    every other row of every lane → (ok, stats, (f, i): fn, in_ with the
    fills written where nothing was stored, to compare with the twin)."""
    import torch

    from txr_torch.kernels.primitives import INF_T
    from txr_torch.kernels.scene_table import SLOT_ORDER

    base = 23
    bits = lambda v: v.contiguous().view(torch.int32)
    live = torch.ones_like(fk[0], dtype=torch.bool) if alive is None else alive.to(torch.bool)
    hit = live & (fn[0] < 1e30)
    shades = hit & (in_[0] < sum(counts[k] for k in SLOT_ORDER[:-1]))
    read = torch.zeros_like(fn, dtype=torch.bool)
    read[0] = live
    read[1:base] = hit
    read[base:] = shades
    read_i = hit.expand(3, -1)
    stored_as_filled = (bool((bits(fn) == bits(fk))[read].all())
                        and bool((in_ == ik)[read_i].all()))
    nan_elsewhere = (bool(torch.isnan(fn[~read]).all())
                     and bool((in_[~read_i] == NAN_BITS).all()))
    fills = torch.zeros_like(fn)
    fills[0] = INF_T
    stats = dict(live=int(live.sum()), miss=int((live & ~hit).sum()),
                 bulb=int((hit & ~shades).sum()), shades=int(shades.sum()),
                 read_rows_as_filled=stored_as_filled, nan_elsewhere=nan_elsewhere)
    return (stored_as_filled and nan_elsewhere, stats,
            (torch.where(read, fn, fills), torch.where(read_i, in_, torch.zeros_like(in_))))


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


def compare_consume(k, r):
    """The consume kernel's next state k vs its twin's r (dicts of the
    state's fields) → (ok, stats): alive, missed and bounces equal, and each
    float field within ROW_ABS + ROW_REL |y|, each on more than AGREE of
    the lanes; the share of lanes that differ at all and the largest
    error."""
    import torch

    n = k["alive"].shape[0]
    differ = torch.zeros(n, dtype=torch.bool, device=k["alive"].device)
    stats, max_abs = {}, 0.0
    for key in ("alive", "missed", "bounces"):
        same = k[key] == r[key]
        stats[f"{key}_agree"] = float(same.float().mean())
        differ |= ~same
    for key in ("ro", "rd", "color", "mask", "absorb_dist"):
        x, y = k[key], r[key]
        err = (x - y).abs()
        within = (err <= ROW_ABS + ROW_REL * y.abs()).reshape(n, -1).all(-1)
        stats[f"{key}_ok"] = float(within.float().mean())
        differ |= (x != y).reshape(n, -1).any(-1)
        max_abs = max(max_abs, float(err.max()))
    stats.update(lanes_differ=float(differ.float().mean()), max_abs_err=max_abs)
    ok = all(v > AGREE for key, v in stats.items() if key.endswith(("_agree", "_ok")))
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
    """Mean device time of the CUDA kernel named ``kernel`` (or of each
    kernel of a tuple of names, summed: the kernels one call launches) per
    call of ``fn``, from a torch.profiler trace of ``reps`` calls: the
    kernels alone, without the wrapper's host work or the other small ops
    it launches.  Should three traces each hold fewer than half of the
    launches of a kernel (the tracer drops device records at times), the
    mean replay time of one CUDA graph of ``reps`` calls instead, which
    adds the graph's own gaps and the other ops ``fn`` launches."""
    import torch

    from txr_torch.apps.profile_frame import device_events, is_kernel, profiled

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = device_events(path)
        times = [[ms for name, ms in events if is_kernel(name, k)] for k in names]
        if all(len(t) >= reps // 2 for t in times):
            return sum(sum(t) / len(t) for t in times)
        times = min(times, key=len)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, 3) / reps
    log(f"  device time of {kernel}: three traces held at most {len(times)} of {reps} launches; "
        f"{ms:.4f} ms a call from a CUDA graph of the calls instead")
    del graph
    return ms


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


def consume_phase(dev):
    """Phase 6b: the consume's two kernels against their twins on each
    bounce step's state of the 1080p demo frame (``frame_states``), the same
    probe rows given to both (the step's probe, and the glossy probe on the
    kernel's glossy rays): alive, missed and bounces equal and the float
    fields within ROW_ABS + ROW_REL |y| on more than AGREE of the lanes, the
    glossy lanes equal and their rays within ROW_ABS; each launch's ms
    through its launcher (CUDA events) and its kernel's device ms, beside
    the bound of the step's work; then a replayed render_jit frame launches
    both.  → dict of the frame's sums, the launches of the replay and each
    kernel's largest error."""
    import torch

    from txr_torch.apps.demo import build_scene, demo_textures
    from txr_torch.kernels import build
    from txr_torch.kernels import launch_counts as counts
    from txr_torch.kernels import reset_launch_counts as reset_counts
    from txr_torch.kernels import step_consume as sc
    from txr_torch.kernels.scene_table import pack_scene
    from txr_torch.render import fused
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.utils import flops

    scene, _ = build_scene(W, H)
    t0 = time.perf_counter()
    (_, nvcc_log), = build.build_all([("step_consume", ())]).values()
    log(f"phase consume build: {time.perf_counter() - t0:.1f} s "
        + " | ".join(ln.strip() for ln in nvcc_log.splitlines()
                     if "registers" in ln or "spill" in ln))
    scene = scene.to(dev)
    textures = with_mips(demo_textures().to(dev))
    cfg = RenderConfig(width=W, height=H, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    table = pack_scene(scene, textures.atlas)
    buf, hdr = table
    states = frame_states(scene, textures, cfg, dev)
    out = dict(ms=0.0, device_ms=0.0, bound_ms=0.0, rays_ms=0.0, rays_device_ms=0.0,
               rays_bound_ms=0.0, max_abs_err=0.0, rays_max_abs_err=0.0)
    with torch.no_grad():
        for k, st in enumerate(states):
            pr = fused._probe(scene, textures, cfg, st["ro"], st["rd"], True, table, st["alive"])
            gk = sc.launch_rays(st, pr, table)
            gr = fused.glossy_rays_ref(scene, st, pr)
            gpr = fused._probe(scene, textures, cfg, gk[1], gk[2], False, table, gk[0])
            nk = sc.launch(textures, cfg, st, pr, gpr, table)
            torch.cuda.synchronize()
            ok, stat = compare_consume(nk, fused.step_consume_ref(scene, textures, cfg, st, pr,
                                                                  gpr))
            both = gk[0] & gr[0]
            ray_err = max([float((a[both] - b[both]).abs().max()) for a, b in
                           zip(gk[1:], gr[1:])] if bool(both.any()) else [0.0])
            stat.update(glossy=int(gk[0].sum()),
                        glossy_agree=float((gk[0] == gr[0]).float().mean()),
                        glossy_ray_max_abs_err=ray_err)
            ok = ok and stat["glossy_agree"] > AGREE and ray_err <= ROW_ABS
            out["max_abs_err"] = max(out["max_abs_err"], stat["max_abs_err"])
            out["rays_max_abs_err"] = max(out["rays_max_abs_err"], ray_err)
            run_c = lambda: sc.launch(textures, cfg, st, pr, gpr, table)
            run_g = lambda: sc.launch_rays(st, pr, table)
            times = dict(ms=cuda_ms(run_c, KERNEL_REPS),
                         device_ms=device_ms(run_c, "step_consume_kernel", KERNEL_REPS),
                         rays_ms=cuda_ms(run_g, KERNEL_REPS),
                         rays_device_ms=device_ms(run_g, "step_consume_rays_kernel", KERNEL_REPS))
            for key, v in times.items():
                out[key] += v
            ops, nbytes = flops.step_consume_work(buf, hdr, textures, cfg, st, pr.f, pr.i,
                                                  gpr.f, gpr.i)
            g_ops, g_bytes = flops.glossy_rays_work(buf, hdr, st, pr.f, pr.i, gk[0])
            out["bound_ms"] += flops.bound_ms(ops, nbytes)
            out["rays_bound_ms"] += flops.bound_ms(g_ops, g_bytes)
            log(f"phase consume step {k} ({int(st['alive'].sum())} of {st['alive'].numel()} "
                f"lanes alive): {json.dumps(stat)}; {json.dumps(times)}; bound "
                f"{flops.bound_ms(ops, nbytes):.4f} ms by {flops.bound_by(ops, nbytes)} "
                f"({nbytes / 1e6:.1f} MB), glossy rays bound "
                f"{flops.bound_ms(g_ops, g_bytes):.4f} ms by {flops.bound_by(g_ops, g_bytes)} "
                f"({g_bytes / 1e6:.2f} MB)" + (" PASS" if ok else " FAIL"))
            if not ok:
                fail("step_consume kernel disagrees with its twin")
            del pr, gk, gr, gpr, nk
        clear_jit_cache()
        render_jit(scene, textures, cfg, device=dev)
        reset_counts()
        render_jit(scene, textures, cfg, device=dev)
        torch.cuda.synchronize()
        out["jit_launches"] = counts()
        clear_jit_cache()
    launched = all(out["jit_launches"][k] for k in ("glossy_rays", "step_consume"))
    log(f"phase consume: {out['ms']:.3f} ms per frame over {len(states)} bounce steps by "
        f"CUDA events ({out['device_ms']:.3f} ms kernel device time, bound "
        f"{out['bound_ms']:.3f} ms, share {out['bound_ms'] / out['device_ms']:.3f}), glossy "
        f"rays {out['rays_ms']:.3f} ms ({out['rays_device_ms']:.3f} ms, bound "
        f"{out['rays_bound_ms']:.4f} ms, share {out['rays_bound_ms'] / out['rays_device_ms']:.3f}); "
        f"a replayed render_jit frame launched {out['jit_launches']} -> "
        + ("PASS" if launched else "FAIL"))
    if not launched:
        fail("render_jit's frame did not launch glossy_rays and step_consume")
    return out


def graph_ms(fn, reps=KERNEL_REPS, trials=PROBE_TRIALS):
    """ms a call of ``fn`` from a CUDA graph of ``reps`` calls, replayed
    ``trials`` times and timed by CUDA events: the median replay over
    ``reps`` (no host work between the calls)."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    out = [cuda_ms(graph.replay, 1) / reps for _ in range(trials)]
    del graph
    return statistics.median(out)


def probe_fill_phase(dev):
    """Every step-probe launch of one replayed 1080p render_jit frame of
    the demo posed at PROBE_T seconds, 1 spp and "ultra" (its pieces run
    eagerly, ``uncaptured``, so each launch's rays and mask are kept; the
    frame asks for no fills in any of them): the launch without fills,
    into rows set to NaN, against the same launch with them
    (``check_unfilled``); its live, missing, light-bulb and shading lanes;
    its time each way (``graph_ms``, into rows held, the device's work
    alone); its bytes as ``utils/flops.py`` prices them each way, and the
    fill rows the filled launch writes on dead lanes, which no price
    counts; one line a launch → {preset: the frame's sums}; fails where a launch without fills stores other rows than a reader
    reads."""
    import torch

    from txr_torch.apps import demo as demo_app
    from txr_torch.apps.profile_frame import uncaptured
    from txr_torch.kernels import step_probe as sp
    from txr_torch.kernels.scene_table import pack_scene, set_flags
    from txr_torch.render import fused as rfused
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, _pix_angle
    from txr_torch.utils import flops

    scene, handles = demo_app.build_scene(W, H)
    scene = demo_app.update_scene(scene.to(dev), handles, 0.0, PROBE_T)
    textures = with_mips(demo_app.demo_textures().to(dev))
    buf, hdr0 = table = pack_scene(scene, textures.atlas)
    row_bytes = 4 * sp.n_rows(scene.counts) + 12
    base = RenderConfig(width=W, height=H, iterations=5, extra_refraction_steps=6)
    out = {}
    for preset in ("1spp", "ultra"):
        cfg = base if preset == "1spp" else base.with_aa_preset(preset)
        kept, probe = [], rfused._probe

        def keep(scene, textures, cfg, ro, rd, shade_flipped, table=None, alive=None,
                 fill=True):
            hdr = set_flags(hdr0, one_side=cfg.plane_oneside,
                            shadow_enabled=cfg.shadow_enabled, do_fresnel=cfg.do_fresnel,
                            tir=cfg.total_internal_reflection, shade_flipped=shade_flipped)
            kept.append(dict(hdr=hdr, pix=_pix_angle(cfg) or 0.0, ro=ro.clone(), rd=rd.clone(),
                             alive=None if alive is None else alive.clone(),
                             glossy=not shade_flipped, fill=fill))
            return probe(scene, textures, cfg, ro, rd, shade_flipped, table, alive, fill)

        clear_jit_cache()
        try:
            with uncaptured(), torch.no_grad():
                render_jit(scene, textures, cfg, device=dev)    # the warm-up steps every capacity
                rfused._probe = keep
                render_jit(scene, textures, cfg, device=dev)
        finally:
            rfused._probe = probe
            clear_jit_cache()
        if not kept or any(c["fill"] for c in kept):
            fail(f"probe fill ({preset}): the frame's {len(kept)} probe launches "
                 f"{[c['fill'] for c in kept]} did not all ask for no fills")
        tot = dict(launches=len(kept), lanes=0, live=0, miss=0, bulb=0, ms=0.0, ms_filled=0.0,
                   step_ms=0.0, step_ms_filled=0.0, glossy_ms=0.0, glossy_ms_filled=0.0,
                   MB=0.0, MB_filled=0.0, MB_dead_fills=0.0)
        for c in kept:
            hdr, N = c["hdr"], c["ro"].shape[0]
            args = (buf, hdr, c["ro"], c["rd"], c["pix"], c["alive"])
            fk, ik = sp.launch(*args)
            fn, in_ = probe_over_nan(*args)
            ok, st, _ = check_unfilled(fn, in_, fk, ik, c["alive"], scene.counts)
            if not ok:
                fail(f"probe fill ({preset}, {N} lanes, glossy {c['glossy']}): the launch without "
                     f"fills stores other rows than a reader reads: {json.dumps(st)}")
            f = torch.empty_like(fk)
            i = torch.empty_like(ik)
            row = dict(lanes=N, glossy=c["glossy"], **{k: st[k] for k in ("live", "miss", "bulb")})
            for tag, h in (("", unfilled(hdr)), ("_filled", hdr)):
                row["ms" + tag] = graph_ms(lambda: probe_into(buf, h, c["ro"], c["rd"], c["pix"],
                                                              c["alive"], f, i))
                work = flops.step_probe_work(buf, h, c["ro"], c["rd"], c["alive"], fk, ik)
                row["MB" + tag] = work[1] / 1e6
                row["bound_ms" + tag] = flops.bound_ms(*work)
            row["MB_dead_fills"] = (N - st["live"]) * row_bytes / 1e6
            part = "glossy" if c["glossy"] else "step"
            for k in ("lanes", "live", "miss", "bulb", "ms", "ms_filled", "MB", "MB_filled",
                      "MB_dead_fills"):
                tot[k] += row[k]
            tot[f"{part}_ms"] += row["ms"]
            tot[f"{part}_ms_filled"] += row["ms_filled"]
            log(f"phase probe fill ({preset}, {part} probe): " + json.dumps(row))
            del fk, ik, fn, in_, f, i
        log(f"phase probe fill ({preset}): every launch of the frame stores only the rows a "
            f"reader reads -> PASS; the frame's sums: " + json.dumps(tot))
        out[preset] = tot
        del kept
    return out


def lane_map_phase(scene, textures, cfg, dev):
    """The lane map's kernels on the states the compacted steps of one
    render_jit frame feed them (its pieces run eagerly, ``uncaptured``, so
    each call's inputs are kept): ``launch_compact`` against
    ``compact_ref`` (the lane map, every byte of the C rows, the count) and
    ``launch_scatter`` against ``scatter_ref`` (every byte of rows[:R], the
    count), then each step's times: through the wrapper by CUDA events
    (``ms``), the kernels alone in a trace (``device_ms``), the twin
    (``plain_ms``), and its least time by ``utils/flops.py`` for these
    inputs and with every row of C live.  → {"lane_compact" |
    "lane_scatter": dict(ms, device_ms, plain_ms, needed, full: the
    frame's sums; steps: a dict per step)}; fails on a byte that
    differs."""
    import torch

    from txr_torch.apps.profile_frame import KERNELS, uncaptured
    from txr_torch.kernels import lane_map as lm
    from txr_torch.kernels.step_consume import STATE_KEYS
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.utils import flops

    kept, compact, scatter = [], lm.compact, lm.scatter

    def keep_compact(st, C):
        kept.append([{k: v.clone() for k, v in st.items()}, C])
        return compact(st, C)

    def keep_scatter(new, lane, rows, live):
        kept[-1] += [{k: v.clone() for k, v in new.items()}, lane.clone(),
                     {k: v.clone() for k, v in rows.items()}, live.clone()]
        return scatter(new, lane, rows, live)

    clear_jit_cache()
    try:
        with uncaptured(), torch.no_grad():
            render_jit(scene, textures, cfg, device=dev)    # the warm-up steps every capacity
            lm.compact, lm.scatter = keep_compact, keep_scatter
            render_jit(scene, textures, cfg, device=dev)
    finally:
        lm.compact, lm.scatter = compact, scatter
        clear_jit_cache()
    same = lambda a, b: torch.equal(a.contiguous().view(-1).view(torch.uint8),
                                    b.contiguous().view(-1).view(torch.uint8))
    out = {k: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, needed=(0, 0), full=(0, 0), steps=[])
           for k in LANE_MAP}
    for st, C, new, lane, rows, live in kept:
        R = st["alive"].shape[0]
        k_lane, k_sub, k_live = lm.launch_compact(st, C)
        t_lane, t_sub, t_live = lm.compact_ref(st, C)
        k_rows = {k: v.clone() for k, v in rows.items()}
        t_rows = {k: v.clone() for k, v in rows.items()}
        s_live, u_live = live.clone(), live.clone()
        lm.launch_scatter(new, lane, k_rows, s_live)
        lm.scatter_ref(new, lane, t_rows, u_live)
        equal = dict(
            lane_compact=(same(k_lane, t_lane) and same(k_live, t_live)
                          and all(same(k_sub[k], t_sub[k]) for k in STATE_KEYS)),
            lane_scatter=(same(s_live, u_live)
                          and all(same(k_rows[k][:R], t_rows[k][:R]) for k in STATE_KEYS)))
        if not all(equal.values()) or not same(lane, t_lane):
            fail(f"the lane map's kernels differ from their twins at R = {R}, C = {C}: {equal}, "
                 f"the step's own lane map {'equal' if same(lane, t_lane) else 'differs'}")
        every = torch.zeros(C, dtype=torch.int64, device=dev)
        calls = dict(lane_compact=(lambda: lm.launch_compact(st, C), lambda: lm.compact_ref(st, C),
                                   flops.lane_compact_work(st, lane),
                                   flops.lane_compact_work(st, every)),
                     lane_scatter=(lambda: lm.launch_scatter(new, lane, k_rows, s_live),
                                   lambda: lm.scatter_ref(new, lane, t_rows, u_live),
                                   flops.lane_scatter_work(lane, R),
                                   flops.lane_scatter_work(every, R)))
        for name, (kernel, twin, needed, full) in calls.items():
            twin()
            step = dict(R=R, C=C, live=int((lane < R).sum()), ms=cuda_ms(kernel, KERNEL_REPS),
                        device_ms=device_ms(kernel, KERNELS[name][1], KERNEL_REPS),
                        plain_ms=cuda_ms(twin, 2), bound_ms=flops.bound_ms(*needed))
            row = out[name]
            row["steps"].append(step)
            for key in ("ms", "device_ms", "plain_ms"):
                row[key] += step[key]
            row["needed"] = tuple(a + b for a, b in zip(row["needed"], needed))
            row["full"] = tuple(a + b for a, b in zip(row["full"], full))
        del k_sub, t_sub, k_rows, t_rows
    if not kept:
        fail(f"a render_jit frame at {cfg.width}x{cfg.height} ran no compacted step")
    return out


def in_chunks(fn, n, *lanes, chunk=BALLS_CHUNK):
    """``fn`` of per-lane inputs (lanes on their first axis, or None) in
    chunks of ``chunk`` lanes, its outputs joined along their lane axis
    (the last: the probe's rows, a sweep's [N] outputs; None kept): the
    twins of the balls phase at 1080p, their [N, 256] blocks held to a
    chunk's size.  Each lane's result is its own, so the chunks give the
    whole call's."""
    import torch

    parts = [fn(*(None if x is None else x[a:a + chunk].contiguous() for x in lanes))
             for a in range(0, n, chunk)]
    return tuple(None if p[0] is None else torch.cat(p, dim=-1) for p in zip(*parts))


def crossing_shares(ro, rd, spheres, chunk=1 << 13):
    """The share of (warp, sphere) pairs of a probe launch on every lane of
    ``ro``, ``rd`` in which some lane's line crosses the sphere (h = b² − c
    ≥ 0, as ``txr_common.cuh: sphere_tile_line`` computes it, one float32
    operation at a time): the pairs whose warp takes the root, where every
    other pair's warp issues nothing after h's sign.  With every lane live
    a warp is 32 neighbouring lanes.  ``spheres``: the table's sphere records
    [S, 9].  → (that share, the share of (lane, sphere) pairs that cross)."""
    import torch

    c = spheres[:, 0:3].float()
    r2 = spheres[:, 3].float() * spheres[:, 3].float()
    n, S = ro.shape[0], c.shape[0]
    warps = lanes = 0
    for a in range(0, n, chunk):
        o, d = ro[a:a + chunk], rd[a:a + chunk]
        ocx, ocy, ocz = o[:, 0:1] - c[:, 0], o[:, 1:2] - c[:, 1], o[:, 2:3] - c[:, 2]
        b = ocx * d[:, 0:1] + ocy * d[:, 1:2] + ocz * d[:, 2:3]
        cc = ocx * ocx + ocy * ocy + ocz * ocz - r2
        x = (b * b - cc) >= 0.0
        lanes += int(x.sum())
        x = torch.cat([x, x.new_zeros((-x.shape[0]) % 32, S)])
        warps += int(x.view(-1, 32, S).any(1).sum())
    return warps / (-(-n // 32) * S), lanes / (n * S)


def probe_occupancy(hdr):
    """The registers a thread and the blocks an SM of the probe kernel that a
    launch on a table with header ``hdr`` takes, at its planned shared
    memory (``step_probe.cu: txr_step_probe_occupancy``)."""
    import ctypes

    from txr_torch.kernels import build

    fn = build.load("step_probe", "txr_step_probe_occupancy", [ctypes.c_void_p] * 3)
    h = (ctypes.c_int * len(hdr))(*hdr)
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(ctypes.addressof(h), ctypes.addressof(regs), ctypes.addressof(blocks))
    if rc != 0:
        fail(f"txr_step_probe_occupancy failed: cudaError {rc}")
    return regs.value, blocks.value


def balls_phase(dev):
    """Phase 3a: the SPD ``balls`` table (``rtbench/configs/spd-balls-1080p.json``:
    7,381 spheres, a floor, 3 point lights; its slot records far larger
    than a block's shared memory), which every kernel sweeps in tiles
    (``csrc/txr_common.cuh: plan_stage``): the step probe on the
    configuration's 1080p primary rays, both shading variants, and on the
    first compacted step of a render_jit frame of it (its pieces run
    eagerly, ``uncaptured``, so the step's rays and mask are kept), each
    launch counted from zero around it (one ``step_probe`` launch, more
    than one tile a sweep), against its twin (``compare_probe``); each
    primary-ray launch again without fills into rows set to NaN
    (``check_unfilled``); the eager route's nearest-hit kernel on the
    primary rays and the shadow-sweep kernel on their shadow rays toward
    the lights, with and without the need mask, against their twins
    (``compare_nearest``, ``compare_shadow``); then the probe on the
    primary rays without fills, as the path runs it, timed through its
    wrapper (CUDA events) and alone (device time), beside its twin and its
    least time by ``utils/flops.py``, its registers and blocks an SM
    (``probe_occupancy``) and its (warp, sphere) pairs' crossing share
    (``crossing_shares``) → the ``kernels`` row ``step_probe_tiled``; fails
    on a disagreement."""
    import torch

    from rtbench import scenedata, system
    from txr_torch.apps.profile_frame import uncaptured
    from txr_torch.kernels import launch_counts, reset_launch_counts
    from txr_torch.kernels import nearest_hit as nh
    from txr_torch.kernels import shadow_sweep as ss
    from txr_torch.kernels import step_probe as sp
    from txr_torch.kernels.scene_table import pack_scene, sections, set_flags
    from txr_torch.render import fused as rfused
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.render.trace import _pix_angle
    from txr_torch.utils import flops

    cfg_file = scenedata.load_config(BALLS)
    scene, _ = system.scene(cfg_file, dev)
    textures = system.textures(cfg_file, {})
    cfg = system.render_config(cfg_file)
    ncount = scene.counts
    L = ncount["lights_point"] + ncount["lights_direct"]
    table = pack_scene(scene, textures.atlas)
    buf, hdr0 = table
    pix = _pix_angle(cfg) or 0.0
    ro, rd = primary_rays(scene.camera, cfg.width, cfg.height)
    n = ro.shape[0]
    err = 0.0

    def counted(fn):
        # the launch's own counts: the launches from zero around it, its tiles
        reset_launch_counts()
        tiles = sp.step_probe.tiles
        out = fn()
        torch.cuda.synchronize()
        c = launch_counts()
        got = dict(launches=c.get("step_probe", 0), tiles=sp.step_probe.tiles - tiles)
        if got["launches"] != 1 or got["tiles"] < 2:
            fail(f"balls: the probe launch was not one launch swept in tiles: {got}, {c}")
        return out, got

    def twin(hdr, ro_, rd_, alive):
        return in_chunks(lambda o, d, a: sp.step_probe_ref(buf, hdr, o, d, pix, a),
                         ro_.shape[0], ro_, rd_, alive)

    for flipped in (True, False):
        hdr = set_flags(hdr0, shade_flipped=flipped)
        (fk, ik), got = counted(lambda: sp.launch(buf, hdr, ro, rd, pix))
        fr, ir = twin(hdr, ro, rd, None)
        ok, st = compare_probe(fk, ik, fr, ir, ncount)
        err = max(err, st["max_abs_err"])
        log(f"phase balls probe ({n} primary rays, shade_flipped={flipped}, {got['tiles']} "
            f"tiles): " + json.dumps(st) + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("balls: the tiled step_probe kernel disagrees with its twin")
        fn, in_ = probe_over_nan(buf, hdr, ro, rd, pix, None)
        ok, st, _ = check_unfilled(fn, in_, fk, ik, None, ncount)
        log(f"phase balls probe (the same, without fills, into rows set to NaN): "
            + json.dumps(st) + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("balls: the tiled step_probe kernel without fills stores other rows than a "
                 "reader reads")
        del fk, ik, fr, ir, fn, in_

    # the first compacted step of a render_jit frame, its rays and mask kept
    kept, probe = [], rfused._probe

    def keep(scene, textures, cfg, ro, rd, shade_flipped, table=None, alive=None, fill=True):
        if alive is not None and ro.shape[0] < n and shade_flipped and not kept:
            kept.append((set_flags(hdr0, one_side=cfg.plane_oneside,
                                   shadow_enabled=cfg.shadow_enabled, do_fresnel=cfg.do_fresnel,
                                   tir=cfg.total_internal_reflection,
                                   shade_flipped=shade_flipped),
                         ro.clone(), rd.clone(), alive.clone()))
        return probe(scene, textures, cfg, ro, rd, shade_flipped, table, alive, fill)

    clear_jit_cache()
    try:
        with uncaptured(), torch.no_grad():
            render_jit(scene, textures, cfg, device=dev)    # the warm-up steps every capacity
            rfused._probe = keep
            render_jit(scene, textures, cfg, device=dev)
    finally:
        rfused._probe = probe
        clear_jit_cache()
    if not kept:
        fail("balls: a render_jit frame ran no compacted step")
    hdr, ro_c, rd_c, alive_c = kept[0]
    (fk, ik), got = counted(lambda: sp.launch(buf, hdr, ro_c, rd_c, pix, alive_c))
    fr, ir = twin(hdr, ro_c, rd_c, alive_c)
    ok, st = compare_probe(fk, ik, fr, ir, ncount)
    err = max(err, st["max_abs_err"])
    log(f"phase balls probe (a compacted step of the render_jit frame: {int(alive_c.sum())} live "
        f"of {ro_c.shape[0]} lanes, {got['tiles']} tiles): " + json.dumps(st)
        + (" PASS" if ok else " FAIL"))
    if not ok:
        fail("balls: the tiled step_probe kernel disagrees with its twin on a compacted step")
    del fk, ik, fr, ir, kept

    # the eager route's kernels: primary rays, and their shadow rays
    tk, sk = nh.launch(buf, hdr0, ro, rd)
    torch.cuda.synchronize()
    tr, sr = in_chunks(lambda o, d: nh.nearest_hit_ref(buf, hdr0, o, d), n, ro, rd)
    ok, st = compare_nearest(tk, sk, tr, sr)
    log(f"phase balls nearest_hit ({n} primary rays): " + json.dumps(st)
        + (" PASS" if ok else " FAIL"))
    if not ok:
        fail("balls: the tiled nearest_hit kernel disagrees with its twin")
    del tk, sk, tr, sr
    so, sd, sdist, sneed = shadow_rays(scene, textures, ro, rd, table, pix)
    for need in (None, sneed):
        k = ss.launch(buf, hdr0, so, sd, sdist, need)
        torch.cuda.synchronize()
        r = in_chunks(lambda o, d, t, m: ss.shadow_sweep_ref(buf, hdr0, o, d, t, m),
                      so.shape[0], so, sd, sdist, need)
        ok, st = compare_shadow(k, r)
        what = "every ray" if need is None else f"need mask: {int(need.sum())} rays"
        log(f"phase balls shadow_sweep ({so.shape[0]} rays: {L} lights x {n} primary rays; "
            f"{what}): " + json.dumps(st) + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("balls: the tiled shadow_sweep kernel disagrees with its twin")
        del k, r
    del so, sd, sdist, sneed

    # the probe on the primary rays, without fills as the path runs it
    hdr_n = unfilled(hdr0)
    run = lambda: sp.launch(buf, hdr_n, ro, rd, pix)
    fk, ik = run()
    needed = flops.step_probe_work(buf, hdr_n, ro, rd, None, fk, ik)
    full = (flops.step_flops(ncount, L) * n,
            n * (24 + 4 * sp.n_rows(ncount) + 12) + buf.numel() * 4)
    del fk, ik
    ms = cuda_ms(run, BALLS_REPS)
    dms = device_ms(run, "step_probe_kernel", BALLS_REPS)
    base = lambda: twin(hdr0, ro, rd, None)
    base()
    plain_ms = cuda_ms(base, 1)
    bound_ms, bound_by = flops.bound_ms(*needed), flops.bound_by(*needed)
    full_ms, full_by = flops.bound_ms(*full), flops.bound_by(*full)
    regs, blocks = probe_occupancy(hdr_n)
    _, sec = sections(buf, hdr0)
    warp_x, lane_x = crossing_shares(ro, rd, torch.as_tensor(sec["spheres"], device=dev))
    row = dict(name="step_probe_tiled", route="cuda", source="txr_torch/kernels/csrc/step_probe.cu",
               replaces="txr/kernels/pallas_step.py:652", table=BALLS, launches=1,
               tiles=got["tiles"], max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bound_full_ms=full_ms,
               bound_full_by=full_by, share=bound_ms / dms, registers=regs, blocks_per_sm=blocks,
               warp_crossing_share=warp_x, lane_crossing_share=lane_x)
    log(f"kernel step_probe_tiled: {ms:.3f} ms per launch at {n} primary rays of {BALLS} "
        f"({got['tiles']} tiles a sweep), through its wrapper by CUDA events (device "
        f"{dms:.3f} ms, twin {plain_ms:.1f} ms), bound {bound_ms:.3f} ms by {bound_by} "
        f"({needed[0] / 1e9:.1f} GFLOP, {needed[1] / 1e6:.0f} MB), {full_ms:.3f} ms by {full_by} "
        f"at full work; {regs} registers, {blocks} blocks an SM; some lane's line crosses the "
        f"sphere in {100 * warp_x:.3f} % of the (warp, sphere) pairs ({100 * lane_x:.4f} % of "
        f"the (lane, sphere) pairs)")
    return row


def without(group):
    """A scene group with no members: every tensor cut to length 0."""
    kw = {}
    for f in dataclasses.fields(group):
        v = getattr(group, f.name)
        kw[f.name] = without(v) if dataclasses.is_dataclass(v) else v[:0]
    return dataclasses.replace(group, **kw)


def former_segment_sum(idx, g2, rows):
    """The texel gradient's former segment sum, dense in the table's rows
    (an arange, two binary searches and a length per row), kept to time it
    beside the current one."""
    import torch

    sidx, perm = torch.sort(idx, stable=True)
    r = torch.arange(rows, device=idx.device)
    lengths = torch.searchsorted(sidx, r, right=True) - torch.searchsorted(sidx, r)
    return torch.segment_reduce(g2.index_select(0, perm), "sum", lengths=lengths, axis=0,
                                unsafe=True)


def write_8k_assets(asset_dir):
    """jupiter.jpg and saturn.jpg at ASSET_H×ASSET_W, made by the demo's own
    generator with its bands, colours and seeds, as RGB8 JPEGs (the
    reference's format; alpha is 1) → {name: (generate s, encode s)}."""
    from PIL import Image

    from txr_torch.apps.demo import PLANETS, _banded_planet

    out = {}
    for name in ("jupiter", "saturn"):
        t0 = time.perf_counter()
        codes = np.round(_banded_planet(ASSET_H, ASSET_W, *PLANETS[name]).numpy()[..., :3]
                         * 255.0).astype(np.uint8)
        t1 = time.perf_counter()
        Image.fromarray(codes, "RGB").save(os.path.join(asset_dir, f"{name}.jpg"),
                                           quality=ASSET_JPEG_QUALITY)
        out[name] = (t1 - t0, time.perf_counter() - t1)
    return out


def assets_8k(dev):
    """Phases 22a-f: the demo with the reference's 8k planet textures, loaded
    through ``demo_textures(asset_dir)``, on the card: the atlas and its mip
    pyramid, the card against the CPU at 96×54, the 1080p forward frame and
    the texture-content forward+backward on both routes, determinism of a
    texture fit, and the texture gradients card against CPU at 48×27.
    → a dict of the phases' numbers."""
    import torch

    from txr_torch.apps.demo import build_scene, demo_textures, update_scene
    from txr_torch.kernels import launch_counts as counts
    from txr_torch.kernels import reset_launch_counts as reset_counts
    from txr_torch.render.intersect import nearest_hit
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.render import render
    from txr_torch.render.texture import MIP_MIN_SIZE, TextureSet, with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.scene.types import float_leaves, unflatten_like
    from txr_torch.utils import index as index_mod
    from txr_torch.utils.image import golden_check

    routes = (("off", ("nearest_hit", "shadow_sweep")), ("auto", PROBE_ROUTE))
    gb = lambda b: b / 1e9
    rec = {}
    scene_cpu, handles = build_scene()
    scene_cpu = update_scene(scene_cpu, handles, 1.0 / 30.0, ASSET_T)
    ascene = scene_cpu.to(dev)

    def cfg_of(w, h, fused):
        return RenderConfig(width=w, height=h, iterations=5, fused=fused,
                            extra_refraction_steps=auto_refraction_steps(scene_cpu))

    def launched(c, kernels):
        return all(c[k] for k in kernels)

    # 22a. load: generate, write as JPEG, read back through the asset directory
    ph0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        made = write_8k_assets(tmp)
        jpg_bytes = {n: os.path.getsize(os.path.join(tmp, f"{n}.jpg")) for n in made}
        t0 = time.perf_counter()
        big = demo_textures(tmp)
        load_s = time.perf_counter() - t0
    shapes = [tuple(t.shape) for t in big.sphere]
    ok = shapes[:2] == [(ASSET_H, ASSET_W, 4)] * 2 and all(
        t.dtype == torch.float32 for t in big.sphere)
    rec["load"] = dict(generate_and_encode_s={n: [round(v, 3) for v in st] for n, st in made.items()},
                       jpeg_bytes=jpg_bytes, load_s=load_s, sphere_shapes=shapes)
    log(f"phase assets 8k load: {json.dumps(rec['load'])}; "
        f"{time.perf_counter() - ph0:.1f} s -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("the 8k assets did not load at their size")

    # 22b. atlas and mip pyramid on the card, against the CPU's bit for bit
    ph0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    raw = big.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big_tex = with_mips(raw)
    torch.cuda.synchronize()
    mips_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    with_mips(raw)
    torch.cuda.synchronize()
    mips_s2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_cpu = with_mips(big)
    mips_cpu_s = time.perf_counter() - t0
    atlas = big_tex.atlas
    same = bool(torch.equal(atlas.texels.cpu(), big_cpu.atlas.texels))
    raw_bytes = sum(t.numel() * 4 for t in (*raw.sphere, raw.box, raw.ring, raw.cubemap))
    rec["atlas"] = dict(levels=atlas.levels.tolist(), dims=[list(d) for d in atlas.dims],
                        texel_rows=atlas.texels.shape[0], atlas_gb=gb(atlas.texels.numel() * 4),
                        raw_textures_gb=gb(raw_bytes), with_mips_s=[mips_s, mips_s2],
                        with_mips_cpu_s=mips_cpu_s, peak_gb_over_start=gb(peak),
                        bit_identical_to_cpu=same)
    # 8192×4096 halves to 8×4 (MIP_MIN_SIZE stops it there): 11 levels
    depth = int(np.log2(min(ASSET_H, ASSET_W) // MIP_MIN_SIZE)) + 1
    ok = same and atlas.levels.tolist()[:2] == [depth, depth]
    log(f"phase assets 8k atlas: {json.dumps(rec['atlas'])}; "
        f"{time.perf_counter() - ph0:.1f} s -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail(f"the 8k atlas on the card is not the CPU's, or its pyramids are not {depth} deep")
    small = with_mips(demo_textures().to(dev))

    # 22c. card against CPU at 96×54, both routes (the golden criterion)
    ph0 = time.perf_counter()
    ro, rd = primary_rays(scene_cpu.camera, GATE_W, GATE_H)
    with torch.no_grad():
        _, ty, idx = nearest_hit(scene_cpu, ro, rd)
    seen = {n: int(((ty == 0) & (idx == getattr(handles, n))).sum()) for n in ("jupiter", "saturn")}
    rec["gate"] = dict(planet_pixels=seen)
    for fused, kernels in routes:
        gcfg = cfg_of(GATE_W, GATE_H, fused)
        with torch.no_grad():
            reset_counts()
            got = render(ascene, big_tex, gcfg, device=dev)
            torch.cuda.synchronize()
            c = counts()
            small_img = render(ascene, small, gcfg, device=dev)
            want = render(scene_cpu, big_cpu, gcfg, device="cpu")
        okc, frac, worst = golden_check(got.cpu().numpy(), want.numpy())
        row = dict(over_2e3=frac, worst_interior=worst,
                   max_abs_diff=float((got.cpu() - want).abs().max()),
                   max_abs_diff_to_small_textures=float((got - small_img).abs().max()),
                   launches=c)
        rec["gate"][fused] = row
        ok = okc and launched(c, kernels) and min(seen.values()) > 0
        log(f"phase assets 8k gate ({GATE_W}x{GATE_H}, fused={fused}, the demo at t={ASSET_T} s, "
            f"planet pixels {seen}): card vs CPU {frac:.3%} pixels over 2e-3 (limit 1.5%), worst "
            f"interior |err| {worst:.4f} (limit 0.5); {json.dumps(row)} -> "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"8k textures at {GATE_W}x{GATE_H}: card and CPU disagree (fused={fused})")
    rec["gate"]["s"] = time.perf_counter() - ph0

    # 22d. 1080p forward, both routes: 8k and the demo's own textures in turns
    ph0 = time.perf_counter()
    rec["forward"] = {}
    for fused, kernels in routes:
        fcfg = cfg_of(W, H, fused)
        with torch.no_grad():
            reset_counts()
            img = render(ascene, big_tex, fcfg, device=dev)
            torch.cuda.synchronize()
            c = counts()
            finite = bool(torch.isfinite(img).all()) and tuple(img.shape) == (H, W, 3)
            del img
            render(ascene, small, fcfg, device=dev)
            row = dict(ms_8k=[], ms_small=[], peak_gb_8k=0.0, peak_gb_small=0.0, launches=c)
            for which in ("8k", "small", "small", "8k"):
                tex = big_tex if which == "8k" else small
                torch.cuda.reset_peak_memory_stats()
                row[f"ms_{which}"].append(cuda_ms(lambda: render(ascene, tex, fcfg, device=dev),
                                                  FRAMES))
                row[f"peak_gb_{which}"] = max(row[f"peak_gb_{which}"],
                                              gb(torch.cuda.max_memory_allocated()))
        row["ratio"] = sum(row["ms_8k"]) / sum(row["ms_small"])
        rec["forward"][fused] = row
        ok = finite and launched(c, kernels)
        log(f"phase assets 8k forward ({W}x{H}, fused={fused}, {FRAMES} frames per run by CUDA "
            f"events, 8k, small, small, 8k): {json.dumps(row)} -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"the 1080p frame with 8k textures (fused={fused})")
    rec["forward"]["s"] = time.perf_counter() - ph0

    # 22e. 1080p forward+backward: the 82 float leaves, with and without the
    # planets' texture contents in the gradient, in turns; then two texture
    # fits of ASSET_FIT_STEPS Adam steps, bit for bit
    ph0 = time.perf_counter()
    jup, sat = (t.detach().clone().requires_grad_(True) for t in raw.sphere[:2])

    def texset(j, s_):
        return TextureSet(sphere=(j, s_, raw.sphere[2]), ring=raw.ring, box=raw.box,
                          cubemap=raw.cubemap)

    def step(tcfg, with_tex):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in float_leaves(ascene).items()}
        tex = with_mips(texset(jup, sat)) if with_tex else big_tex
        img = render(unflatten_like(ascene, leaves), tex, tcfg, device=dev)
        wrt = list(leaves.values()) + ([jup, sat] if with_tex else [])
        return torch.autograd.grad((img * img).mean(), wrt, allow_unused=True)

    raw_atlas_rows = big_tex.atlas.texels.shape[0]
    rec["fwdbwd"] = {}
    for fused, kernels in routes:
        tcfg = cfg_of(W, H, fused)
        reset_counts()
        g = step(tcfg, True)
        torch.cuda.synchronize()
        c = counts()
        finite = all(bool(torch.isfinite(x).all()) for x in g if x is not None)
        tex_norm = [float(x.norm()) for x in g[-2:]]
        del g
        step(tcfg, False)
        row = dict(ms_textures=[], ms_leaves_only=[], peak_gb_textures=0.0,
                   peak_gb_leaves_only=0.0, texture_grad_norms=tex_norm, launches=c)
        for which in ("textures", "leaves_only", "leaves_only", "textures"):
            torch.cuda.reset_peak_memory_stats()
            row[f"ms_{which}"].append(cuda_ms(lambda: step(tcfg, which == "textures"),
                                              TRAIN_STEPS))
            row[f"peak_gb_{which}"] = max(row[f"peak_gb_{which}"],
                                          gb(torch.cuda.max_memory_allocated()))
        row["ratio"] = sum(row["ms_textures"]) / sum(row["ms_leaves_only"])
        # the former segment sum, dense in the table's 90 M rows, one step
        kept, index_mod.segment_sum = index_mod.segment_sum, former_segment_sum
        try:
            torch.cuda.reset_peak_memory_stats()
            row["ms_textures_former_segment_sum"] = cuda_ms(lambda: step(tcfg, True), 1)
            row["peak_gb_textures_former_segment_sum"] = gb(torch.cuda.max_memory_allocated())
        finally:
            index_mod.segment_sum = kept
        # the segment sums of one step, recorded, then each timed alone (CUDA
        # events), the current one and the former, by the table they sum into
        calls = []

        def record(idx, g2, rows):
            calls.append((idx, g2, rows))
            return kept(idx, g2, rows)

        index_mod.segment_sum = record
        try:
            step(tcfg, True)
        finally:
            index_mod.segment_sum = kept
        sums = {}
        for idx, g2, rows in calls:
            kind = "texels" if rows == raw_atlas_rows else f"{rows} rows"
            e = sums.setdefault(kind, dict(calls=0, reads=0, ms=0.0, former_ms=0.0))
            e["calls"] += 1
            e["reads"] += idx.numel()
            e["ms"] += cuda_ms(lambda: kept(idx, g2, rows), 3)
            e["former_ms"] += cuda_ms(lambda: former_segment_sum(idx, g2, rows), 3)
        row["segment_sums_of_a_step"] = sums
        del calls
        rec["fwdbwd"][fused] = row
        ok = finite and launched(c, kernels) and min(tex_norm) > 0
        log(f"phase assets 8k fwd+bwd ({W}x{H}, fused={fused}, {TRAIN_STEPS} steps per run by "
            f"CUDA events; textures = the 82 float leaves and jupiter's and saturn's contents, "
            f"leaves_only = the 82 alone; textures, leaves_only, leaves_only, textures): "
            f"{json.dumps(row)} -> {'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"the 1080p texture-content fwd+bwd with 8k textures (fused={fused})")
    with torch.no_grad():
        target = render(ascene, big_tex, cfg_of(W, H, "auto"), device=dev)
    start = [(0.8 * t + 0.1).detach() for t in raw.sphere[:2]]

    def fit(tcfg):
        ps = [t.clone().requires_grad_(True) for t in start]
        adam = torch.optim.Adam(ps, lr=1e-2, eps=1e-8)
        losses = []
        for _ in range(ASSET_FIT_STEPS):
            adam.zero_grad(set_to_none=True)
            loss = ((render(ascene, with_mips(texset(*ps)), tcfg, device=dev) - target) ** 2
                    ).mean()
            loss.backward()
            adam.step()
            losses.append(float(loss.detach()))
        return losses, ps

    rec["fit"] = {}
    for fused, kernels in routes:
        tcfg = cfg_of(W, H, fused)
        reset_counts()
        l1, p1 = fit(tcfg)
        c = counts()
        l2, p2 = fit(tcfg)
        same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
        moved = max(float((a.detach() - b).abs().max()) for a, b in zip(p1, start))
        rec["fit"][fused] = dict(losses=l1, bit_identical=same, texels_moved_max=moved,
                                 launches=c)
        del p1, p2
        ok = same and moved > 0 and launched(c, kernels)
        log(f"phase assets 8k fit ({W}x{H}, fused={fused}, {ASSET_FIT_STEPS} Adam steps on "
            f"jupiter's and saturn's contents, twice): {json.dumps(rec['fit'][fused])} -> "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"a texture fit at 8k is not bit-identical from run to run (fused={fused})")
    del jup, sat, start, target
    rec["fwdbwd"]["s"] = time.perf_counter() - ph0

    # 22f. texture gradients at 48×27, card against CPU.  The planets cover
    # few pixels there and fewer whose 3×3 neighbours see the same primitive
    # (phase grad's mask), so the loss takes every pixel whose primary ray
    # hits the same primitive on the card and on the CPU: texel gradients
    # carry no silhouette spike, only a hit that flips would move them
    ph0 = time.perf_counter()
    ro, rd = primary_rays(scene_cpu.camera, GRAD_W, GRAD_H)
    with torch.no_grad():
        _, ty, idx = nearest_hit(scene_cpu, ro, rd)
        _, ty_d, idx_d = nearest_hit(ascene, ro.to(dev), rd.to(dev))
        mask = ((ty == ty_d.cpu()) & (idx == idx_d.cpu())).reshape(GRAD_H, GRAD_W)
    planet_px = {n: int((mask.reshape(-1) & (ty == 0) & (idx == getattr(handles, n))).sum())
                 for n in ("jupiter", "saturn")}

    def tex_grads(device, raw_, fused):
        ts = [t.detach().clone().requires_grad_(True) for t in raw_.sphere[:2]]
        tex = with_mips(TextureSet(sphere=(*ts, raw_.sphere[2]), ring=raw_.ring, box=raw_.box,
                                   cubemap=raw_.cubemap))
        s = ascene if device == dev else scene_cpu
        img = render(s, tex, cfg_of(GRAD_W, GRAD_H, fused), device=device)
        loss = (img * img * mask.to(img.device)[..., None]).sum() / (GRAD_W * GRAD_H)
        return [g.cpu() for g in torch.autograd.grad(loss, ts)]

    g_cpu = tex_grads(torch.device("cpu"), big, "off")
    rec["grad"] = {}
    for fused, kernels in routes:
        reset_counts()
        g_card = tex_grads(dev, raw, fused)
        c = counts()
        rel = [float((a - b).norm()) / max(float(b.norm()), 1e-30) for a, b in zip(g_card, g_cpu)]
        norms = [float(b.norm()) for b in g_cpu]
        rec["grad"][fused] = dict(relative_diff=rel, cpu_norms=norms, launches=c)
        ok = (all(float((a - b).norm()) <= GRAD_REL * float(b.norm()) + GRAD_ABS
                  for a, b in zip(g_card, g_cpu)) and min(norms) > 0 and launched(c, kernels))
        log(f"phase assets 8k grad ({GRAD_W}x{GRAD_H}, {int(mask.sum())} pixels whose primary "
            f"hit agrees, planet pixels among them {planet_px}, card "
            f"fused={fused} vs CPU fused=off): jupiter's and saturn's texture gradients "
            f"{json.dumps(rec['grad'][fused])} (limit {GRAD_REL} of the CPU's norm) -> "
            f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            fail(f"8k texture gradients: card and CPU disagree (fused={fused})")
    rec["grad"]["s"] = time.perf_counter() - ph0
    return rec


def gather_bench(dev):
    """Phase 23d: a gather of 16-byte rows, as the texel, cubemap and
    quaternion tables have, by ``index_select`` of whole rows (the former
    ``utils/index.take``) and along the columns of the transposed table
    (``take`` on the card), equal bit for bit: 16.6 M random
    reads of a table the demo atlas' size (8 taps of 1080p's rays) and 2 M
    of a 6-row table; ms by CUDA events over 10 calls each."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, rows, n in (("atlas", 1747504, 8 * W * H), ("six_rows", 6, W * H)):
        table = torch.rand(rows, 4, device=dev, generator=g)
        idx = torch.randint(0, rows, (n,), device=dev, generator=g)
        whole = lambda: torch.index_select(table, 0, idx)
        cols = lambda: torch.index_select(table.t(), 1, idx).t().contiguous()
        out[name] = dict(reads=n, rows_ms=cuda_ms(whole, 10), columns_ms=cuda_ms(cols, 10),
                         equal=bool(torch.equal(whole(), cols())))
    return out


def jit_phase(dev):
    """Phases 23a-c: ``render_jit``, the frame captured in CUDA graphs and
    replayed.  (a) the 96×54 gate through render_jit on both routes; (b) at
    1080p on both routes, 1 spp and "ultra": render_jit against render bit
    for bit at the start pose and at the pose of t = ASSET_T s (the second
    call of the key), the first call's seconds (warm-up and capture), peak
    and held device memory beside render's peak, the launches of a
    replayed frame counted from zero and the lane capacity of each of its
    steps, frame ms of render and render_jit in
    turns (CUDA events and host clock), and at 1 spp a profiler trace of
    one replayed frame whose kernel events must equal the counted
    launches; (c) a call that wants a gradient raises.  → {kernel:
    dict(jit_launches_per_frame, replay_device_ms_per_launch)} from the
    1-spp traces."""
    import torch

    from txr_torch.apps.profile_frame import profile_replay
    from txr_torch.apps.demo import build_scene, demo_textures, update_scene
    from txr_torch.kernels import build
    from txr_torch.kernels import launch_counts as counts
    from txr_torch.kernels import reset_launch_counts as reset_counts
    from txr_torch.kernels.scene_table import pack_scene
    from txr_torch.render import render as rr
    from txr_torch.render.render import clear_jit_cache, render, render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.scene.types import unflatten_like
    from txr_torch.utils.image import golden_check

    routes = (("auto", PROBE_ROUTE), ("off", ("nearest_hit", "shadow_sweep")))
    scene_cpu, handles = build_scene(W, H)
    build.build_all([("step_probe", ()), ("step_consume", ()), ("shadow_sweep", ()),
                     ("lane_map", ()),
                     ("nearest_hit", build.topology(pack_scene(scene_cpu, None)[1]))])
    scene = scene_cpu.to(dev)
    later = update_scene(scene_cpu, handles, 1.0 / 30.0, ASSET_T).to(dev)
    textures = with_mips(demo_textures().to(dev))

    # 23a. the gate through render_jit
    gscene, _ = build_scene(GATE_W, GATE_H)
    want = np.load(os.path.join(ROOT, "txr", "ref", "gate_oracle.npz"))["img"]
    for fused, kernels in routes:
        gcfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6,
                            fused=fused)
        with torch.no_grad():
            render_jit(gscene, textures, gcfg, device=dev)
            reset_counts()
            got = render_jit(gscene, textures, gcfg, device=dev).cpu().numpy()
            c = counts()
        ok, frac, worst = golden_check(got, want)
        log(f"phase jit gate ({GATE_W}x{GATE_H}, fused={fused}, a replayed render_jit frame): "
            f"{frac:.3%} pixels over 2e-3 (limit 1.5%), worst interior |err| {worst:.4f} "
            f"(limit 0.5), launches {c} -> {'PASS' if ok and all(c[k] for k in kernels) else 'FAIL'}")
        if not ok or not all(c[k] for k in kernels):
            fail(f"render_jit gate (fused={fused})")
    clear_jit_cache()

    # 23b. 1080p, both routes, 1 spp and ultra
    base = RenderConfig(width=W, height=H, iterations=5,
                        extra_refraction_steps=auto_refraction_steps(scene_cpu))
    replay = {}
    for fused, kernels in routes:
        for aa in ("1spp", "ultra"):
            ph0 = time.perf_counter()
            cfg = dataclasses.replace(base, fused=fused)
            cfg = cfg.with_aa_preset("ultra") if aa == "ultra" else cfg

            def run_r(s=scene):
                return render(s, textures, cfg, device=dev)

            def run_j(s=scene):
                return render_jit(s, textures, cfg, device=dev)

            row = {}
            with torch.no_grad():
                clear_jit_cache()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
                t0 = time.perf_counter()
                run_j()
                torch.cuda.synchronize()
                row["first_call_s"] = time.perf_counter() - t0
                row["jit_peak_gb"] = (torch.cuda.max_memory_allocated() - a0) / 1e9
                row["jit_held_reserved_gb"] = (torch.cuda.memory_reserved() - r0) / 1e9
                torch.cuda.reset_peak_memory_stats()
                a1 = torch.cuda.memory_allocated()
                run_r()
                torch.cuda.synchronize()
                row["render_peak_gb"] = (torch.cuda.max_memory_allocated() - a1) / 1e9
                for pose, s in (("start", scene), (f"t={ASSET_T:g}s", later)):
                    got, ref = run_j(s), run_r(s)
                    row[pose] = dict(bit_for_bit=bool(torch.equal(got, ref)),
                                     max_abs_diff=float((got - ref).abs().max()),
                                     pixels_differing=int((got != ref).any(-1).sum()))
                    del got, ref
                reset_counts()
                run_j()
                torch.cuda.synchronize()
                row["launches_per_replay"] = counts()
                (frame,) = rr._FRAMES.values()
                row["capacities_stepped"] = [u.steps_run for p in frame.programs
                                             for u in p.units.values()]
                times = dict(render_ms=[], jit_ms=[], render_wall_ms=[], jit_wall_ms=[])
                for _ in range(JIT_ROUNDS):
                    for fn, name in ((run_r, "render"), (run_j, "jit"), (run_j, "jit"),
                                     (run_r, "render")):
                        t0 = time.perf_counter()
                        times[f"{name}_ms"].append(cuda_ms(fn, 1))
                        times[f"{name}_wall_ms"].append((time.perf_counter() - t0) * 1e3)
                row.update(times)
                if aa == "1spp":
                    prof = profile_replay(run_j)
                    row["profile"] = prof
                    for k in kernels + (LANE_MAP if fused == "auto" else ()):
                        replay[k] = dict(jit_launches_per_frame=prof["counted"][k],
                                         replay_device_ms_per_launch=(
                                             prof["kernel_ms"][k] / max(prof["traced"][k], 1)))
            ok = (all(row[p]["bit_for_bit"] for p in ("start", f"t={ASSET_T:g}s"))
                  and all(row["launches_per_replay"][k] for k in kernels + LANE_MAP)
                  and ("profile" not in row
                       or all(row["profile"]["traced"][k] == row["profile"]["counted"][k]
                              for k in kernels + LANE_MAP)))
            log(f"phase jit 1080p ({W}x{H}, fused={fused}, {aa}): {json.dumps(row)}; "
                f"{time.perf_counter() - ph0:.1f} s -> {'PASS' if ok else 'FAIL'}")
            if not ok:
                fail(f"render_jit at 1080p (fused={fused}, {aa}): not bit for bit render's "
                     "image, a kernel not launched, or a trace that disagrees with the counts")
    clear_jit_cache()
    torch.cuda.empty_cache()

    # 23c. a call that wants a gradient
    pos = scene.spheres.pos.clone().requires_grad_(True)
    wants = unflatten_like(scene, {"spheres.pos": pos})
    try:
        render_jit(wants, textures, base, device=dev)
        raised = None
    except ValueError as e:
        raised = str(e)
    log(f"phase jit grad: render_jit with spheres.pos requiring grad raised: {raised!r} -> "
        f"{'PASS' if raised else 'FAIL'}")
    if not raised:
        fail("render_jit took a call that wants a gradient")

    # 23d. the gather of 16-byte rows
    gb = gather_bench(dev)
    log(f"phase jit gather: {json.dumps(gb)} -> "
        f"{'PASS' if all(r['equal'] for r in gb.values()) else 'FAIL'}")
    if not all(r["equal"] for r in gb.values()):
        fail("a gather along the transposed table's columns differs from index_select")
    return replay


def train_jit_phase(dev):
    """Phase 24: the captured train step (``diff/optimize.py: _Fit``, the
    step of ``optimize_scene``, and ``make_train_step``) at 1080p on the
    demo scene, every float leaf, loss mean((img − target)²) toward the
    demo frame from a guess with the camera and the spheres moved, on both
    routes: (a) the first call (warm-up and capture): seconds, peak device
    memory, the memory the graphs' pool holds, the launches of a replayed
    step; the first loss bit for bit the eager step's (``_eager_step``,
    the op-by-op step), each leaf's gradient within TRAIN_REL of its norm;
    (b) step ms of eager and captured steps in turns (TRAIN_ROUNDS rounds
    of eager, captured or captured, eager; CUDA events and host clock);
    (c) two replayed steps under ``set_sync_debug_mode("error")``; (d) a
    profiler trace of one replayed step (device ms, busy share) whose
    kernel events equal the counted launches; (e) OPT_STEPS-step Adam fits
    from the guess, captured and eager, losses within TRAIN_FIT_REL
    relative (each step's difference recorded); (f) ``optimize_scene``
    resumed after 2 of 4 steps, losses, parameters and checkpoint file bit
    for bit the uninterrupted run's; (g) ``make_train_step`` in a world of
    1 (nccl, in process), one step from the guess: its loss within 1e-6
    relative and its gradients within DIST_REL of their norms of the
    captured local step's (the same rays in raster order, not screen
    tiles: sums in another order).  First (h): ``utils/index.take``'s
    backward, its one-hot product and its segment sum, at 1080p's reads,
    makes no host sync and replays from a graph bit for bit; (i) the
    captured update (``graphs.Recorder.capture_update``) of NAdam, Rprop,
    ASGD (state not starting at zero), Adam, dampened SGD and
    ``keep_grads_sgd`` equals the optimiser's own 4 steps bit for bit, and
    one built with ``capturable=False`` is refused.  → {kernel:
    dict(train_jit_launches_per_step, train_replay_device_ms_per_launch)}
    from the traces."""
    import torch

    from txr_torch.apps.profile_frame import profile_replay
    import torch.distributed as tdist

    from txr_torch.apps.demo import build_scene, demo_textures
    from txr_torch.diff import optimize as opt_mod
    from txr_torch.dist.mesh import default_backend, init_multihost, make_mesh
    from txr_torch.dist.sharded import make_train_step
    from txr_torch.kernels import build
    from txr_torch.kernels import launch_counts as counts
    from txr_torch.kernels import reset_launch_counts as reset_counts
    from txr_torch.kernels.scene_table import pack_scene
    from txr_torch.render.graphs import Recorder
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps
    from txr_torch.scene.types import float_leaves, unflatten_like
    from txr_torch.utils.checkpoint import load_arrays
    from txr_torch.utils.index import take

    routes = (("auto", PROBE_ROUTE), ("off", ("nearest_hit", "shadow_sweep")))
    true_cpu, _ = build_scene(W, H)
    build.build_all([("step_probe", ()), ("step_consume", ()), ("shadow_sweep", ()),
                     ("lane_map", ()),
                     ("nearest_hit", build.topology(pack_scene(true_cpu, None)[1]))])
    true = true_cpu.to(dev)
    guess = unflatten_like(true_cpu, {
        "camera.pos": true_cpu.camera.pos + torch.tensor([0.04, -0.03, 0.05]),
        "spheres.pos": true_cpu.spheres.pos + torch.tensor([0.06, 0.04, -0.05])}).to(dev)
    textures = with_mips(demo_textures().to(dev))
    base = RenderConfig(width=W, height=H, iterations=5,
                        extra_refraction_steps=auto_refraction_steps(true_cpu))

    def grads(fit):
        return {p: torch.zeros_like(v) if v.grad is None else v.grad.detach().clone()
                for p, v in fit.params.items()}

    def worst_rel(got, want):
        """The largest ||g − w|| / ||w|| over the leaves, the leaves over
        TRAIN_REL, and {leaf: ||g − w|| / ||w||} of those over 1e-8."""
        worst, bad, by_leaf = 0.0, [], {}
        for p, w in want.items():
            d, nrm = float((got[p] - w).norm()), float(w.norm())
            rel = d / nrm if nrm else (0.0 if d == 0 else float("inf"))
            worst = max(worst, rel)
            if rel > 1e-8:
                by_leaf[p] = rel
            if d > TRAIN_REL * nrm:
                bad.append((p, d, nrm))
        return worst, bad, by_leaf

    # (h) take's backward, the one-hot product (6 rows) and the segment sum
    # (4096 rows), at 1080p's reads: no host sync, and captured and
    # replayed, bit for bit the eager result
    gen = torch.Generator(device=dev).manual_seed(0)
    takes = {}
    for rows in (6, 4096):
        table = torch.rand(rows, 4, device=dev, generator=gen)
        idx = torch.randint(0, rows, (W * H,), device=dev, generator=gen)
        cot = torch.randn(W * H, 4, device=dev, generator=gen)
        out = {}

        def take_vjp():
            with torch.enable_grad():
                t = table.detach().requires_grad_(True)
                (out["g"],) = torch.autograd.grad(take(t, idx), t, cot)

        take_vjp()
        want = out["g"].clone()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            take_vjp()
            sync_free = True
        except RuntimeError as e:
            sync_free = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rec = Recorder(dev)
        rec.warm_up(take_vjp)
        piece = rec.capture(take_vjp)
        out["g"].zero_()
        piece.replay()
        torch.cuda.synchronize()
        takes[rows] = dict(sync_free=sync_free,
                           replay_bit_for_bit=bool(torch.equal(out["g"], want)))
    ok = all(r["sync_free"] is True and r["replay_bit_for_bit"] for r in takes.values())
    log(f"phase train jit take (the backward of utils/index.take at {W * H} reads): "
        f"{json.dumps(takes)} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("take's backward synchronises or does not replay from a graph")

    # (i) the captured update of optimisers whose state starts elsewhere
    # than zero, and of a subclass, against their own steps; one built
    # with capturable=False is refused
    x0 = torch.randn(4096, device=dev, generator=gen)
    gs = torch.randn(4, 4096, device=dev, generator=gen)
    makers = dict(
        nadam=lambda ps: torch.optim.NAdam(ps, lr=1e-2, capturable=True),
        rprop=lambda ps: torch.optim.Rprop(ps, lr=1e-2, capturable=True),
        asgd=lambda ps: torch.optim.ASGD(ps, lr=1e-2, capturable=True),
        adam=lambda ps: torch.optim.Adam(ps, lr=1e-2, fused=True, capturable=True),
        sgd_dampened=lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9, dampening=0.5),
        keep_grads_sgd=keep_grads_sgd)
    updates = {}
    for name, make in makers.items():
        runs = []
        for captured in (False, True):
            x = x0.clone().requires_grad_(True)
            x.grad = torch.zeros_like(x0)       # static, as a train frame's
            opt, update = make([x]), None
            for g in gs:
                x.grad.copy_(g)
                if captured and update is None:
                    update = Recorder(dev).capture_update(opt)
                update.replay() if captured else opt.step()
                # what the step keeps: keep_grads_sgd's copy of the gradient
                runs.append([x.detach().clone(), *[t.clone() for t in getattr(opt, "grads", [])]])
        n = len(gs)
        updates[name] = (all(torch.equal(a, b) for r, q in zip(runs[:n], runs[n:])
                             for a, b in zip(r, q))
                         and not torch.equal(runs[n - 1][0], x0))
    try:
        x = x0.clone().requires_grad_(True)
        x.grad = gs[0].clone()
        Recorder(dev).capture_update(torch.optim.Adam([x], lr=1e-2, capturable=False))
        updates["capturable_false_raises"] = False
    except ValueError:
        updates["capturable_false_raises"] = True
    ok = all(updates.values())
    log(f"phase train jit update (4 steps of 4096 parameters, captured vs the optimiser's own, "
        f"bit for bit): {json.dumps(updates)} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("a captured optimiser update differs from the optimiser's own steps")

    replay = {}
    for fused, kernels in routes:
        ph0 = time.perf_counter()
        cfg = dataclasses.replace(base, fused=fused)
        row = {}
        with torch.no_grad():
            target = render_jit(true, textures, cfg, device=dev)
        clear_jit_cache()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

        def fit_of(captured):
            return opt_mod._Fit(guess, textures, cfg, target, lr=TRAIN_LR, device=dev,
                                captured=captured)

        try:
            # (a) the first call, against the eager step
            cap = fit_of(True)
            t0 = time.perf_counter()
            loss_c, _ = cap.step(0)
            torch.cuda.synchronize()
            row["first_call_s"] = time.perf_counter() - t0
            row["peak_gb"] = (torch.cuda.max_memory_allocated() - a0) / 1e9
            row["pool_gb"] = (torch.cuda.memory_reserved() - r0) / 1e9
            g_c = grads(cap)
            loss_c = loss_c.clone()
            eag = fit_of(False)
            torch.cuda.reset_peak_memory_stats()
            a1 = torch.cuda.memory_allocated()
            loss_e, _ = eag.step(0)
            torch.cuda.synchronize()
            row["eager_peak_gb"] = (torch.cuda.max_memory_allocated() - a1) / 1e9
            g_e = grads(eag)
            row["first_loss"] = float(loss_c)
            row["first_loss_bit_for_bit"] = bool(torch.equal(loss_c, loss_e))
            row["worst_grad_rel"], bad, row["grad_rel_over_1e-8"] = worst_rel(g_c, g_e)
            row["leaves"] = len(g_c)
            reset_counts()
            cap.step(0)
            torch.cuda.synchronize()
            row["launches_per_replay"] = counts()
            (unit,) = cap.frame.programs[0].units.values()
            row["capacities_stepped"] = unit.steps_run

            # (b) step ms in turns
            times = dict(eager_ms=[], jit_ms=[], eager_wall_ms=[], jit_wall_ms=[])
            for r in range(TRAIN_ROUNDS):
                for fit, name in ((eag, "eager"), (cap, "jit"))[::1 - 2 * (r % 2)]:
                    t0 = time.perf_counter()
                    times[f"{name}_ms"].append(cuda_ms(lambda: fit.step(0), 1))
                    times[f"{name}_wall_ms"].append((time.perf_counter() - t0) * 1e3)
            row.update(times)

            # (c) replays that read nothing on the host
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(2):
                    cap.step(0)
                row["sync_free"] = True
            except RuntimeError as e:
                row["sync_free"] = str(e)[:300]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()

            # (d) a traced replay
            prof = profile_replay(lambda: cap.step(0))
            row["profile"] = prof
            for k in kernels + (LANE_MAP if fused == "auto" else ()):
                replay[k] = dict(train_jit_launches_per_step=prof["counted"][k],
                                 train_replay_device_ms_per_launch=(
                                     prof["kernel_ms"][k] / max(prof["traced"][k], 1)))
            cap.close()         # its frame is the next captured fit's
            del cap, eag

            # (e) two fits from the guess
            fits = {}
            for captured in (True, False):
                fit = fit_of(captured)
                fits[captured] = [float(fit.step(i)[0]) for i in range(OPT_STEPS)]
                fit.close()
                del fit
            row["fit_losses"] = fits[True]
            row["fit_losses_eager"] = fits[False]
            row["fit_rel"] = [abs(a - b) / abs(b) for a, b in zip(fits[True], fits[False])]

            # (f) resume after 2 of 4 steps
            with tempfile.TemporaryDirectory() as tmp:
                whole, part = os.path.join(tmp, "whole.npz"), os.path.join(tmp, "part.npz")
                kw = dict(lr=TRAIN_LR, device=dev)
                s4, l4 = opt_mod.optimize_scene(guess, textures, cfg, target, steps=4,
                                                checkpoint_path=whole, checkpoint_every=4, **kw)
                opt_mod.optimize_scene(guess, textures, cfg, target, steps=2, checkpoint_path=part,
                                       checkpoint_every=2, **kw)
                s, l = opt_mod.optimize_scene(guess, textures, cfg, target, steps=4,
                                              checkpoint_path=part, checkpoint_every=2, resume=True,
                                              **kw)
                a, b = load_arrays(part)[0], load_arrays(whole)[0]
                row["resume_bit_for_bit"] = (
                    l == l4 and set(a) == set(b)
                    and all(a[k].tobytes() == b[k].tobytes() for k in b)
                    and all(torch.equal(x, y) for x, y in zip(float_leaves(s).values(),
                                                              float_leaves(s4).values())))
            clear_jit_cache()
            torch.cuda.empty_cache()

            # (g) make_train_step in a world of 1
            with tempfile.TemporaryDirectory() as tmp:
                init_multihost(init_method="file://" + os.path.join(tmp, "store"), world_size=1,
                               rank=0, backend=default_backend([dev]))
                try:
                    init, step = make_train_step(textures, cfg, make_mesh(),
                                                 lambda ps: torch.optim.SGD(ps, lr=0.0), device=dev)
                    state = init(guess)
                    reset_counts()
                    _, _, loss_1 = step(guess, state, target)
                    torch.cuda.synchronize()
                    row["world_1_launches"] = counts()
                    row["world_1_loss_rel"] = abs(float(loss_1) - float(loss_c)) / float(loss_c)
                    got = {p: v.grad.detach().clone() for p, v in state.params.items()}
                    row["world_1_worst_grad_rel"] = worst_rel(got, g_c)[0]
                    row["world_1_step_ms"] = cuda_ms(lambda: step(guess, state, target), 2)
                    row["world_1_backend"] = tdist.get_backend()
                    del state
                finally:
                    tdist.destroy_process_group()
            clear_jit_cache()
            torch.cuda.empty_cache()
        finally:
            # whatever the route reached, on its own line
            log(f"phase train jit ({W}x{H}, fused={fused}, every float leaf): "
                f"{json.dumps(row, default=str)}; {time.perf_counter() - ph0:.1f} s")

        # every kernel's events: the probe route's backward launches the
        # sweeps too (its glossy pass, recomputed in saved mode)
        ok = (row["first_loss_bit_for_bit"] and not bad and row["sync_free"] is True
              and prof["traced"] == prof["counted"]
              and all(prof["counted"][k] for k in kernels + LANE_MAP)
              and all(row["launches_per_replay"][k] for k in kernels + LANE_MAP)
              and max(row["fit_rel"]) <= TRAIN_FIT_REL and row["resume_bit_for_bit"]
              and row["world_1_loss_rel"] <= 1e-6 and row["world_1_worst_grad_rel"] <= DIST_REL
              and all(row["world_1_launches"][k] for k in kernels))
        log(f"phase train jit ({W}x{H}, fused={fused}) -> {'PASS' if ok else 'FAIL ' + str(bad)}")
        if not ok:
            fail(f"the captured train step at 1080p (fused={fused}): see the line above")
    return replay


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from txr_torch.apps import demo as demo_app
        from txr_torch.apps.demo import build_scene, demo_textures
        from txr_torch.apps.profile_frame import KERNELS as KERNEL_NAMES
        from txr_torch.diff import optimize as opt_mod
        from txr_torch.diff.optimize import optimize_scene
        from txr_torch.kernels import build
        from txr_torch.kernels import nearest_hit as nh
        from txr_torch.kernels import shadow_sweep as ss
        from txr_torch.kernels import step_consume as cons
        from txr_torch.kernels import step_probe as sp
        from txr_torch.kernels.scene_table import pack_scene, sections
        from txr_torch.render import fused as rfused
        from txr_torch.render.intersect import nearest_hit
        from txr_torch.render.raygen import primary_rays
        from txr_torch.render import render as rr
        from txr_torch.render.render import (clear_jit_cache, edge_pixels, render, render_debug,
                                             render_jit)
        from txr_torch.render.texture import with_mips
        from txr_torch.render.trace import RenderConfig, auto_refraction_steps
        from txr_torch.scene.types import (TYPE_TORUS, flatten_with_paths, float_leaves,
                                           unflatten_like)
        from txr_torch.utils.checkpoint import load_arrays
        from txr_torch.utils import flops
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
    built = build.build_all([("step_probe", ()), ("step_consume", ()), ("shadow_sweep", ()),
                             ("lane_map", ()), ("nearest_hit", demo_top)] + shard_tops)
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
    probe_lane_bytes = 24 + 4 * sp.n_rows(ncount) + 12     # a ray in, its rows out
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

    def without_fills(buf, hdr, ro_, rd_, alive, fk, ik, fr, ir, what):
        # the same launch without FLAG_FILL, as the forward path runs it
        fn, in_ = probe_over_nan(buf, hdr, ro_, rd_, pix, alive)
        ok, st, (fc, ic) = check_unfilled(fn, in_, fk, ik, alive, ncount)
        ok_twin, st_twin = compare_probe(fc, ic, fr, ir, ncount)
        err["step_probe"] = max(err["step_probe"], st_twin["max_abs_err"])
        log(f"phase probe ({what}, without fills, into rows set to NaN): {json.dumps(st)}; "
            f"its read rows, the fills elsewhere, vs the twin: {json.dumps(st_twin)}"
            + (" PASS" if ok and ok_twin else " FAIL"))
        if not (ok and ok_twin):
            fail("step_probe kernel without fills stores other rows than a reader reads, or "
                 "disagrees with its twin")

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
        without_fills(buf, hdr, ro_all, rd_all, None, fk, ik, fr, ir,
                      f"shade_flipped={flipped}, {ro_all.shape[0]} rays")
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
        without_fills(table[0], hdr_f, s1["ro"], s1["rd"], s1["alive"], fk, ik, fr, ir,
                      f"step 1 of the 1080p frame, alive mask, shade_flipped={flipped}")
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
    balls_row = balls_phase(dev)

    # 4-5. gate, both routes -----------------------------------------------------
    gscene, _ = build_scene(GATE_W, GATE_H)
    want = np.load(os.path.join(ROOT, "txr", "ref", "gate_oracle.npz"))["img"]
    for fused, kernels in (("auto", PROBE_ROUTE), ("off", ("nearest_hit", "shadow_sweep"))):
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
    if img.shape != (H, W, 3) or not finite or not all(launches[k] for k in PROBE_ROUTE):
        fail(f"1080p frame: shape {tuple(img.shape)}, finite {finite}, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(lambda: render(scene, textures, cfg, device=dev), FRAMES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase forward ({W}x{H}): {frame_ms:.2f} ms/frame, {W * H / frame_ms * 1e3:.4g} "
        f"rays/s, launches {launches}/frame, peak {peak_gb:.2f} GB")
    target = img.detach()
    del img
    # the probe on each bounce step's state: lanes, work, time, bounds; timed
    # without fills, as the forward path launches it, and with them
    hdr_n = unfilled(hdr)
    probe_frame = dict(ms=0.0, device_ms=0.0, ms_filled=0.0, device_ms_filled=0.0)
    for k, st in enumerate(states):
        fk, ik = sp.launch(buf, hdr, st["ro"], st["rd"], pix, st["alive"])
        crossing = probe_lines(scene, buf, hdr, st["ro"], st["rd"], st["alive"], fk, ik)
        timed = {}
        for tag, h in (("", hdr_n), ("_filled", hdr)):
            args = (buf, h, st["ro"], st["rd"], pix, st["alive"])
            timed["ms" + tag] = cuda_ms(lambda: sp.launch(*args), KERNEL_REPS)
            timed["device_ms" + tag] = device_ms(lambda: sp.launch(*args), "step_probe_kernel",
                                                 KERNEL_REPS)
            work = flops.step_probe_work(buf, h, st["ro"], st["rd"], st["alive"], fk, ik)
            timed["bound_ms" + tag] = flops.bound_ms(*work)
            timed["bound_by" + tag] = flops.bound_by(*work)
            timed["MB" + tag] = work[1] / 1e6
        ops = work[0]
        for key in probe_frame:
            probe_frame[key] += timed[key]
        full_ops = flops.step_flops(ncount, L) * W * H
        full_bytes = W * H * probe_lane_bytes + buf.numel() * 4
        full_ms, full_by = flops.bound_ms(full_ops, full_bytes), flops.bound_by(full_ops, full_bytes)
        hits = int((st["alive"] & (fk[0] < 1e30)).sum())
        log(f"phase forward step {k}: alive {int(st['alive'].sum())}, alive and hit {hits}, "
            f"crossing the torus sphere {crossing} (of the alive), probe without fills "
            f"{timed['ms']:.4f} ms through its wrapper by CUDA events (kernel device time "
            f"{timed['device_ms']:.4f} ms), bound {timed['bound_ms']:.4f} ms by "
            f"{timed['bound_by']} for this work ({ops / 1e9:.3f} GFLOP, {timed['MB']:.0f} MB); "
            f"with fills {timed['ms_filled']:.4f} ms (device {timed['device_ms_filled']:.4f} ms, "
            f"bound {timed['bound_ms_filled']:.4f} ms, {timed['MB_filled']:.0f} MB, the dead "
            f"lanes' fills not priced); {full_ms:.4f} ms by {full_by} at full work")
        del fk, ik
    log(f"phase forward: probe {probe_frame['ms']:.3f} ms per frame over {len(states)} bounce "
        f"steps by CUDA events without fills ({probe_frame['device_ms']:.3f} ms kernel device "
        f"time), {probe_frame['ms_filled']:.3f} ms with them "
        f"({probe_frame['device_ms_filled']:.3f} ms); the glossy passes' launches not included")
    # 6a. the probe with and without fills on every launch of a replayed frame
    fill_rows = probe_fill_phase(dev)

    # 6b. consume
    consume = consume_phase(dev)
    err["step_consume"] = consume.pop("max_abs_err")
    err["glossy_rays"] = consume.pop("rays_max_abs_err")
    del states, s1
    # the eager route's nearest_hit on each bounce step's state, as step_jnp
    # calls it (the alive mask), beside a sweep of every lane of the state
    _, sec = sections(buf, hdr)
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
        crossing = int(cull_check(sec, o_[lanes].unbind(-1), d_[lanes].unbind(-1)).sum())
        ops, nbytes = flops.nearest_hit_work(buf, hdr, o_, d_, alive)
        need_ms, need_by = flops.bound_ms(ops, nbytes), flops.bound_by(ops, nbytes)
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
        kernels = ("nearest_hit", "shadow_sweep") if fused == "off" else PROBE_ROUTE
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
    for fused, kernels in (("auto", PROBE_ROUTE), ("off", ("nearest_hit", "shadow_sweep"))):
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
    for fused, kernels in (("off", ("nearest_hit", "shadow_sweep")), ("auto", PROBE_ROUTE)):
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
        res = demo_app.main(["--width", str(W), "--height", str(H), "--frames", "5", "--aa",
                             "ultra", "--fly", "w:1, wd:2:4:0", "--out", png])
        demo_s = time.perf_counter() - t0
        c = counts()
        img = load_image(png)
        png_bytes = os.path.getsize(png)
    ok = (img.shape == (H, W, 4) and bool(torch.isfinite(res["img"]).all())
          and tuple(res["img"].shape) == (H, W, 3) and c["step_probe"] > 0)
    log(f"phase demo ({W}x{H}, 5 frames, --aa ultra, --fly): FPS per frame by render_jit "
        f"(frame 0 captures its graphs) {[round(f, 3) for f in res['fps']]}, {demo_s:.1f} s in "
        f"all, wrote a {png_bytes}-byte PNG that reads back as {img.shape}, launches {c} -> "
        f"{'PASS' if ok else 'FAIL'}")
    if not ok:
        fail("the demo app at 1080p")
    del res, img
    clear_jit_cache()

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
    for fused, kernels in (("off", ("nearest_hit", "shadow_sweep")), ("auto", PROBE_ROUTE)):
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
    from txr_torch.dist.sharded import make_train_step, render_sharded, render_sharded_jit

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
                render_sharded_jit(scene, textures, dcfg, mesh, device=dev)
                reset_counts()
                frame_1j = render_sharded_jit(scene, textures, dcfg, mesh, device=dev)
                torch.cuda.synchronize()
                c_jit = counts()
                jit_ms_1 = cuda_ms(lambda: render_sharded_jit(scene, textures, dcfg, mesh,
                                                              device=dev), DIST_REPS)
            clear_jit_cache()
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
    equal_1j = bool(torch.equal(frame_1j, frame_1))
    bad, worst = dist_grads(g_1, g_ref)
    loss_rel = abs(float(loss_1) - loss_ref) / loss_ref
    world_rows[1] = dict(backend=backend_1, frame_bit_identical=equal_1, frame_ms=frame_ms_1,
                         step_ms=step_ms_1, loss=float(loss_1), loss_rel_diff=loss_rel,
                         worst_grad_rel_diff=worst, frame_launches=c_frame, step_launches=c_step,
                         jit_frame_bit_identical=equal_1j, jit_frame_ms=jit_ms_1,
                         jit_frame_launches=c_jit)
    ok = (equal_1 and equal_1j and not bad and loss_rel <= 1e-6 and c_frame["step_probe"] > 0
          and c_step["step_probe"] > 0 and c_jit["step_probe"] > 0)
    log(f"phase dist world 1 ({W}x{H}, in process, {backend_1}): render_sharded vs render bit "
        f"for bit: {equal_1}; render_sharded_jit (replayed) vs render_sharded bit for bit: "
        f"{equal_1j}, {jit_ms_1:.2f} ms a frame, launches {c_jit}; "
        f"one make_train_step step on the probe route (every float leaf) "
        f"vs a plain render and backward of the same loss: loss {float(loss_1):.8g} vs "
        f"{loss_ref:.8g} (relative {loss_rel:.3g}, limit 1e-6), worst leaf {worst:.3g} (limit "
        f"{DIST_REL}); frame {frame_ms_1:.2f} ms, step {step_ms_1:.1f} ms (CUDA events, "
        f"{DIST_REPS} reps); launches: frame {c_frame}, step {c_step}; "
        f"{time.perf_counter() - ph0:.1f} s -> "
        + ("PASS" if ok else f"FAIL {bad}"))
    if not ok:
        fail("dist world 1: the sharded frame or step disagrees with the plain one")
    del frame_1, frame_1j, st

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
    clear_jit_cache()

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
        + (f"{res['frames']} frames in {res['seconds']:.2f} s = {res['fps']:.3f} FPS by render_jit"
           if res else "no result") + f", launches {c}; {time.perf_counter() - ph0:.1f} s -> "
        + ("PASS" if ok else "FAIL"))
    if not ok:
        fail("the live viewer")
    clear_jit_cache()

    # 22. assets 8k ----------------------------------------------------------------
    ph0 = time.perf_counter()
    assets_8k(dev)
    log(f"phase assets 8k: {time.perf_counter() - ph0:.1f} s in all")

    # 23. jit ------------------------------------------------------------------------
    ph0 = time.perf_counter()
    jit_rows = jit_phase(dev)
    log(f"phase jit: {time.perf_counter() - ph0:.1f} s in all")

    # 24. train jit ------------------------------------------------------------------
    ph0 = time.perf_counter()
    train_rows = train_jit_phase(dev)
    log(f"phase train jit: {time.perf_counter() - ph0:.1f} s in all")

    # each kernel alone, on tables packed once, at the widths of earlier
    # records: the 1080p primary rays, in raster order, every lane live (the
    # probe, the sweep);
    # their shadow rays toward both lights (the shadow sweep, with the need
    # mask of step 0's act lanes as the eager route passes it, and without)
    n, ns = ro.shape[0], so.shape[0]
    full = dict(step_probe=(flops.step_flops(ncount, L) * n, n * probe_lane_bytes),
                nearest_hit=(flops.sweep_flops(ncount) * n, n * (24 + 8)),
                shadow_sweep=(flops.shadow_flops(ncount) * ns,
                              ns * (28 + 4 + 12 * ncount["rings"])))
    full = {k: (ops, nbytes + buf.numel() * 4) for k, (ops, nbytes) in full.items()}
    # the consume at full width: the 1080p frame's state at step 0, its probe
    # rows, and every lane at its most; both probes store their fills, since
    # the twins below read every lane
    with torch.no_grad():
        c_st = frame_states(scene, textures, cfg, dev)[0]
        c_pr = rfused._probe(scene, textures, cfg, c_st["ro"], c_st["rd"], True, table,
                             c_st["alive"])
        c_glossy, ro_g, rd_g = cons.launch_rays(c_st, c_pr, table)
        c_gpr = rfused._probe(scene, textures, cfg, ro_g, rd_g, False, table, c_glossy)
    full["glossy_rays"] = tuple(n * v for v in flops.glossy_lane_most())
    full["step_consume"] = tuple(n * v for v in flops.consume_lane_most(ncount))
    fk, ik = sp.launch(buf, hdr, ro, rd, pix)
    probe_lines(scene, buf, hdr, ro, rd, None, fk, ik)
    lanes = torch.nonzero(sneed).squeeze(-1)
    cull_check(sec, so[lanes].unbind(-1), sd[lanes].unbind(-1))
    needed = dict(step_probe=flops.step_probe_work(buf, hdr_n, ro, rd, None, fk, ik),
                  glossy_rays=flops.glossy_rays_work(buf, hdr, c_st, c_pr.f, c_pr.i, c_glossy),
                  step_consume=flops.step_consume_work(buf, hdr, textures, cfg, c_st, c_pr.f,
                                                       c_pr.i, c_gpr.f, c_gpr.i),
                  nearest_hit=flops.nearest_hit_work(buf, hdr, ro, rd),
                  shadow_sweep=flops.shadow_sweep_work(
                      buf, hdr, so, sd, sdist, sneed, ss.launch(buf, hdr, so, sd, sdist, sneed)[0]))
    needed_filled = flops.step_probe_work(buf, hdr, ro, rd, None, fk, ik)
    del fk, ik
    # the probe timed without fills, as the forward path launches it (with
    # them beside, ``ms_filled``)
    runs = dict(step_probe=(lambda: sp.launch(buf, hdr_n, ro, rd, pix),
                            lambda: sp.step_probe_ref(buf, hdr, ro, rd, pix)),
                glossy_rays=(lambda: cons.launch_rays(c_st, c_pr, table),
                             lambda: rfused.glossy_rays_ref(scene, c_st, c_pr)),
                step_consume=(
                    lambda: cons.launch(textures, cfg, c_st, c_pr, c_gpr, table),
                    lambda: rfused.step_consume_ref(scene, textures, cfg, c_st, c_pr, c_gpr)),
                nearest_hit=(lambda: nh.launch(buf, hdr, ro, rd),
                             lambda: nh.nearest_hit_ref(buf, hdr, ro, rd)),
                shadow_sweep=(lambda: ss.launch(buf, hdr, so, sd, sdist, sneed),
                              lambda: ss.shadow_sweep_ref(buf, hdr, so, sd, sdist, sneed)))
    # the consume's kernels have no TPU kernel: XLA fuses the JAX package's
    # consume, whose glossy rays it forms at fused.py:373
    sources = dict(step_probe="txr/kernels/pallas_step.py:652",
                   glossy_rays="txr/render/fused.py:373",
                   step_consume="txr/render/fused.py:323",
                   nearest_hit="txr/kernels/pallas_intersect.py:375",
                   shadow_sweep="txr/kernels/pallas_intersect.py:489")
    main_launches = dict(step_probe=launches["step_probe"],
                         glossy_rays=launches["glossy_rays"],
                         step_consume=launches["step_consume"],
                         nearest_hit=train["off"]["launches"]["nearest_hit"],
                         shadow_sweep=train["off"]["launches"]["shadow_sweep"])
    rows = []
    for name, (kernel, twin) in runs.items():
        ms = cuda_ms(kernel, KERNEL_REPS)
        extra = dict(device_ms=device_ms(kernel, KERNEL_NAMES[name][1], KERNEL_REPS))
        twin()
        plain_ms = cuda_ms(twin, 2)
        bound_ms, bound_by = flops.bound_ms(*needed[name]), flops.bound_by(*needed[name])
        full_ms, full_by = flops.bound_ms(*full[name]), flops.bound_by(*full[name])
        rays = ns if name == "shadow_sweep" else n
        extra.update(jit_rows[name])
        extra.update(train_rows[name])
        if name == "step_probe":
            filled = lambda: sp.launch(buf, hdr, ro, rd, pix)
            extra.update(ms_filled=cuda_ms(filled, KERNEL_REPS),
                         device_ms_filled=device_ms(filled, "step_probe_kernel", KERNEL_REPS),
                         bound_ms_filled=flops.bound_ms(*needed_filled),
                         frame_ms=probe_frame["ms"], frame_device_ms=probe_frame["device_ms"],
                         frame_ms_filled=probe_frame["ms_filled"],
                         frame_device_ms_filled=probe_frame["device_ms_filled"],
                         frames_every_launch=fill_rows,
                         aa_1080p_edge_pass_launches=edge_launches["step_probe"])
        elif name == "glossy_rays":
            extra.update(frame_ms=consume["rays_ms"], frame_device_ms=consume["rays_device_ms"],
                         frame_bound_ms=consume["rays_bound_ms"],
                         jit_frame_launches=consume["jit_launches"]["glossy_rays"],
                         lanes_alive=int(c_st["alive"].sum()), lanes_glossy=int(c_glossy.sum()))
        elif name == "step_consume":
            extra.update(frame_ms=consume["ms"], frame_device_ms=consume["device_ms"],
                         frame_bound_ms=consume["bound_ms"],
                         jit_frame_launches=consume["jit_launches"]["step_consume"],
                         lanes_alive=int(c_st["alive"].sum()))
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
            f"({needed[name][0] / 1e9:.3f} GFLOP, {needed[name][1] / 1e6:.0f} MB), "
            f"{full_ms:.4f} ms by {full_by} at full work ({full[name][0] / 1e9:.2f} GFLOP); "
            + json.dumps(extra))
        source = "step_consume" if name == "glossy_rays" else name
        rows.append(dict(name=name, route="cuda", source=f"txr_torch/kernels/csrc/{source}.cu",
                         replaces=sources[name], launches=main_launches[name],
                         max_abs_err=err[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, bound_full_ms=full_ms,
                         bound_full_by=full_by, **extra))

    # the lane map's kernels, per 1080p render_jit frame: the sums over its
    # compacted steps (no TPU kernel: the JAX package compacts in XLA)
    for name, lmr in lane_map_phase(scene, textures, cfg, dev).items():
        bound_ms, bound_by = flops.bound_ms(*lmr["needed"]), flops.bound_by(*lmr["needed"])
        full_ms, full_by = flops.bound_ms(*lmr["full"]), flops.bound_by(*lmr["full"])
        extra = dict(device_ms=lmr["device_ms"], steps=lmr["steps"], **jit_rows[name],
                     **train_rows[name])
        log(f"kernel {name}: {lmr['ms']:.4f} ms a 1080p render_jit frame over its "
            f"{len(lmr['steps'])} compacted steps, through its wrapper by CUDA events (twins "
            f"{lmr['plain_ms']:.3f} ms), bound {bound_ms:.4f} ms by {bound_by} for the work these "
            f"inputs need ({lmr['needed'][1] / 1e6:.0f} MB), {full_ms:.4f} ms with every row "
            f"live; byte for byte the twins'; " + json.dumps(extra))
        rows.append(dict(name=name, route="cuda", source="txr_torch/kernels/csrc/lane_map.cu",
                         replaces="none (txr/render/compact.py, in XLA)",
                         launches=jit_rows[name]["jit_launches_per_frame"], max_abs_err=0.0,
                         ms=lmr["ms"], plain_ms=lmr["plain_ms"], bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, bound_full_ms=full_ms,
                         bound_full_by=full_by, **extra))
    rows.append(balls_row)

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
