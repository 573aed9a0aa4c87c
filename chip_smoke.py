#!/usr/bin/env python3
"""On-card smoke test of the txr_torch port: builds its kernel, holds the
kernel against its plain twin, drives the demo scene's forward render and
times it.  Needs one CUDA card; run from the repository root:

    python3 chip_smoke.py

Phases, one line each:
  1. build    compile the step-probe kernel from the sources in the checkout
  2. probe    kernel vs its plain PyTorch twin on the card: the demo's 1080p
              primary rays plus 8192 random rays, both probe variants
  3. gate     96×54 demo render through the kernel vs the f64 oracle image
              (txr/ref/gate_oracle.npz), golden criterion
  4. forward  the 1920×1080 demo frame: finite, probe launches counted from
              zero around one frame, frame time by CUDA events, one
              full-width probe launch timed against its twin
Then a JSON line of per-kernel numbers, the card's name and power limit,
and the last line {"ok": true, "device": {...}}.  Any failure exits
non-zero and prints no result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
GATE_W, GATE_H = 96, 54
N_RANDOM = 8192
FRAMES = 5
PROBE_REPS = 20

# The probe comparison's thresholds (as tpu_smoke.py:101-108): f32 root
# placement at silhouettes may legitimately flip a lane between kernel and
# twin, so agreement is a share of lanes, not every lane.
AGREE = 0.999
T_REL = 5e-3
ROW_ABS, ROW_REL = 1e-3, 1e-3

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


def probe_ops_per_ray(c, one_side=True):
    sweep = sum(c[k] * (TEST_OPS[k] + ACCEPT_OPS) for k in TEST_OPS)
    shadow = sum(c[k] * (TEST_OPS[k] + OCCLUDE_OPS)
                 for k in ("spheres", "surfaces", "boxes", "toruses"))
    shadow += c["rings"] * (TEST_OPS["rings"] + OCCLUDE_OPS + RING_UV_OPS)
    if not one_side:
        shadow += c["planes"] * (TEST_OPS["planes"] + OCCLUDE_OPS)
    L = c["lights_point"] + c["lights_direct"]
    return sweep + L * shadow + LANE_OPS


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
          and stats["t_ok"] >= AGREE and worst_share >= AGREE)
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from txr_torch.apps.demo import build_scene, demo_textures
        from txr_torch.kernels import step_probe as sp
        from txr_torch.render.raygen import primary_rays
        from txr_torch.render.render import render
        from txr_torch.render.texture import with_mips
        from txr_torch.render.trace import RenderConfig, auto_refraction_steps
        from txr_torch.utils.image import golden_check
    except ImportError as e:
        fail(f"the txr_torch package is not beside this script ({e})")

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    path, nvcc_log = sp.build()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(ln.strip() for ln in nvcc_log.splitlines()
                       if "registers" in ln or "spill" in ln)
    log(f"phase build: {build_s:.1f} s -> {os.path.relpath(path, ROOT)} [{ptxas}]")

    scene, _ = build_scene(W, H)
    scene = scene.to(dev)
    textures = with_mips(demo_textures().to(dev))
    counts = scene.counts
    pix = 1.0 / H

    # 2. kernel vs twin ----------------------------------------------------------
    ro, rd = primary_rays(scene.camera, W, H)
    rng = np.random.default_rng(0)
    ro2 = rng.uniform([-12.0, -3.0, -6.0], [12.0, 6.0, 10.0], (N_RANDOM, 3))
    rd2 = rng.normal(size=(N_RANDOM, 3))
    rd2 /= np.linalg.norm(rd2, axis=-1, keepdims=True)
    ro_all = torch.cat([ro, torch.from_numpy(ro2.astype(np.float32)).to(dev)]).contiguous()
    rd_all = torch.cat([rd, torch.from_numpy(rd2.astype(np.float32)).to(dev)]).contiguous()
    max_err = 0.0
    for flipped in (True, False):
        fk, ik = sp.step_probe(scene, textures.atlas, ro_all, rd_all, pix_angle=pix,
                               shade_flipped=flipped, device=dev)
        torch.cuda.synchronize()
        buf, hdr = sp.pack_scene(scene, textures.atlas, shade_flipped=flipped)
        fr, ir = sp.step_probe_ref(buf, hdr, ro_all, rd_all, pix)
        ok, st = compare_probe(fk, ik, fr, ir, counts)
        max_err = max(max_err, st["max_abs_err"])
        log(f"phase probe (shade_flipped={flipped}, {ro_all.shape[0]} rays): "
            + json.dumps(st) + (" PASS" if ok else " FAIL"))
        if not ok:
            fail("step_probe kernel disagrees with its twin")
        del fk, ik, fr, ir

    # 3. gate --------------------------------------------------------------------
    gscene, _ = build_scene(GATE_W, GATE_H)
    gcfg = RenderConfig(width=GATE_W, height=GATE_H, iterations=5, extra_refraction_steps=6)
    before = sp.step_probe.launches
    got = render(gscene, textures, gcfg, device=dev).cpu().numpy()
    want = np.load(os.path.join(ROOT, "txr", "ref", "gate_oracle.npz"))["img"]
    ok, frac, worst = golden_check(got, want)
    log(f"phase gate ({GATE_W}x{GATE_H}): {frac:.3%} pixels over 2e-3 (limit 1.5%), "
        f"worst interior |err| {worst:.4f} (limit 0.5), probe launches "
        f"{sp.step_probe.launches - before} -> {'PASS' if ok else 'FAIL'}")
    if not ok or sp.step_probe.launches == before:
        fail("gate render does not match the oracle or did not launch the kernel")

    # 4. 1080p forward -----------------------------------------------------------
    cfg = RenderConfig(width=W, height=H, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    sp.step_probe.launches = 0
    img = render(scene, textures, cfg, device=dev)
    torch.cuda.synchronize()
    launches = sp.step_probe.launches
    finite = bool(torch.isfinite(img).all())
    if img.shape != (H, W, 3) or not finite or launches == 0:
        fail(f"1080p frame: shape {tuple(img.shape)}, finite {finite}, launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(lambda: render(scene, textures, cfg, device=dev), FRAMES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the kernel alone, on tables packed once: the wrapper's packing is a
    # few dozen small host-side ops that would time the host, not the card
    n = ro.shape[0]
    buf, hdr = sp.pack_scene(scene, textures.atlas)
    probe = lambda: sp.launch(buf, hdr, ro, rd, pix)
    probe()
    probe_ms = cuda_ms(probe, PROBE_REPS)
    twin = lambda: sp.step_probe_ref(buf, hdr, ro, rd, pix)
    twin()
    plain_ms = cuda_ms(twin, 2)
    nf = sp.n_rows(counts)
    flops = probe_ops_per_ray(counts) * n
    nbytes = n * (24 + 4 * nf + 12) + buf.numel() * 4
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES_S else "bytes"
    log(f"phase forward ({W}x{H}): {frame_ms:.2f} ms/frame, {n / frame_ms * 1e3:.4g} rays/s, "
        f"{launches} probe launches/frame, peak {peak_gb:.2f} GB; probe kernel "
        f"{probe_ms:.3f} ms/launch at {n} rays (twin {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms by {bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.0f} MB)")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": [{
        "name": "step_probe", "route": "cuda",
        "source": "txr_torch/kernels/csrc/step_probe.cu",
        "replaces": "txr/kernels/pallas_step.py:652",
        "launches": launches, "max_abs_err": max_err, "ms": probe_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
