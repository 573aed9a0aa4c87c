#!/usr/bin/env python3
"""The port's benchmark (the counterpart of bench.py): the cells of
BENCHMARK.json, the demo scene at 1080p on one H100.

    python3 bench_torch.py [--cell demo-1080p-fwd|demo-1080p-train]

With no ``--cell`` both cells run, one after the other, in this process.
Each prints one JSON line per phase; the last line of a cell holds its
end-to-end metric and its per-layer metrics:

  demo-1080p-fwd    ``render_jit`` on the probe route: 30 frames of the
                    demo's animation (t = 0, 1/30, ..., 29/30 s, posed by
                    ``apps.demo.update_scene`` as the live viewer poses
                    them) back to back → ``forward_rays_per_s``
  demo-1080p-train  bench.py's forward+backward cell (bench.py:297-316) as
                    the port runs it: the captured train step of
                    ``optimize_scene`` (``diff.optimize._Fit``), probe
                    route, the gradient of mean(img²) over every float leaf
                    at the demo's pose, Adam with its rate held at 0 so that
                    every step does the same work: 10 steps back to back →
                    ``fwd_bwd_rays_per_s``

The phases of a cell, in order:

  gate        the 96×54 demo frame through render_jit against the f64
              oracle (txr/ref/gate_oracle.npz) by bench.py's criterion;
              the train cell also needs the captured step's first loss at
              96×54 bit for bit the op-by-op step's.  A failed gate prints
              an error line and exits 1, before any metric.
  first call  warm-up and capture, timed apart (``first_call_s``); the
              graph pool it holds; then, untimed, the frame's other poses
              (the train cell: its second step, which captures the update)
  sync        two frames or steps under set_sync_debug_mode("error"): no
              host read
  window      ``--repeats`` windows of ``--frames`` frames or ``--steps``
              steps back to back, each timed by CUDA events and the host
              clock after a synchronize; the metric is every window's rays
              over the windows' summed time (events), each window's time
              and their spread (max − min) / mean beside it, and each
              unit's (an event after every unit: the median, a high
              quantile, the largest); no capture and no host read inside
              (the frame's graphs and launch counters are checked around
              it)
  check       what the windows computed against the reference made by the
              JAX package and its f64 oracle (txr_torch/ref/
              bench_reference.npz, scripts/gen_bench_reference.py): the
              forward cell's frames at the reference's poses, the train
              cell's loss, gradient and image after each window, its Adam
              moments against their closed form and its parameters
              unchanged; each reading beside those of controls that must
              fail (the pixels in half and bfloat16 precision; the
              gradient of half the rays; an update frozen in the windows)
  profile     one replay under torch.profiler (retried until its kernel
              events equal the counted launches): busy share, device ms,
              each kernel's launches and ms, the 10 device operations of
              most time and the 5 longest idle gaps of the device with the
              host operation that ran then
  bounds      the same frame or step run again with its pieces eager
              (``profile_frame.uncaptured``: the replay's launches, each
              through its wrapper) and every kernel call priced
              (``utils/flops.py: priced_launches``): the priced calls must
              equal the replay's launches; each kernel's least time for
              that work and its roofline share
  result      the metric and the per-layer metrics

Runs on ``cuda``; ``--device cpu`` (the tests) runs the same phases on the
CPU at a small size, with no device metric (profile and sync "not
measured").  Any failure exits non-zero; nothing falls back.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CELLS = ("demo-1080p-fwd", "demo-1080p-train")
GATE_W, GATE_H = 96, 54
FPS = 30.0                      # the animation's frame times: t = k / FPS
REFERENCE = os.path.join(ROOT, "txr_torch", "ref", "bench_reference.npz")
# The check's limits, each between the sound readings and the controls'
# (PERF.md §2 has both).  A sampled pixel is off when its worst channel is
# more than PIXEL_TOL from the f64 oracle, and a frame fails with more than
# PIXEL_FRAC of its sampled pixels off: silhouette pixels may fall on
# either side in float32.  A leaf's gradient is off when it is more than
# GRAD_TOL of its norm from the float64 reference, and a step fails with
# more than GRAD_FRAC of the leaves (those of at least LEAF_FLOOR of the
# largest leaf's norm) off: a leaf that rays grazing a silhouette carry
# (a sphere's position, the camera) moves with float32's rounding.  The
# loss and the Adam moments are held by relative error.
PIXEL_TOL, PIXEL_FRAC = 1e-5, 0.05
GRAD_TOL, GRAD_FRAC, LEAF_FLOOR = 1e-4, 0.7, 1e-3
LOSS_REL, MOMENT_REL = 1e-3, 1e-4


def emit(rec):
    print(json.dumps(rec), flush=True)


def fail(cell, phase, msg):
    emit(dict(cell=cell, phase=phase, error=msg))
    sys.exit(1)


def card(dev):
    """The device the numbers come from: kind, count and, on a card, its
    name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=torch.cuda.device_count(), smi=smi.stdout.strip().splitlines()[dev.index])


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def demo(dev, width, height):
    """(scene on dev, its animation handles, textures, the cells' cfg)."""
    from txr_torch.apps.demo import build_scene, demo_textures
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig, auto_refraction_steps

    scene, handles = build_scene(width, height)
    cfg = RenderConfig(width=width, height=height, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    return scene.to(dev), handles, with_mips(demo_textures().to(dev)), cfg


def fit_of(scene, textures, cfg, dev, captured=True):
    """The train cell's fit: mean(img²) (a zero target), every float leaf,
    Adam at rate 0."""
    from txr_torch.diff.optimize import _Fit

    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    return _Fit(scene, textures, cfg, target, lr=0.0, device=dev, captured=captured)


def gate(cell, dev, oracle, train):
    """Phase gate; exits 1 on a failure."""
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.utils.image import golden_check

    scene, _, textures, cfg = demo(dev, GATE_W, GATE_H)
    want = np.load(oracle)["img"]
    with torch.no_grad():
        got = render_jit(scene, textures, cfg, device=dev)
    ok, frac, worst = golden_check(got.cpu().numpy(), want)
    rec = dict(cell=cell, phase="gate", size=f"{GATE_W}x{GATE_H}",
               refraction_steps=cfg.extra_refraction_steps, frac_over_tol=frac,
               worst_interior=worst, limits=dict(tol=2e-3, frac=0.015, interior=0.5))
    if ok and train:
        losses = [fit_of(scene, textures, cfg, dev, captured).step(0)[0]
                  for captured in (True, False)]
        rec.update(first_loss=float(losses[0]), first_loss_eager=float(losses[1]))
        ok = bool(torch.equal(*losses))
    clear_jit_cache()
    if not ok:
        fail(cell, "gate", f"correctness gate failed: {json.dumps(rec)}")
    emit(dict(rec, ok=True))


def reference(cfg, cell):
    """bench_reference.npz at cfg's size → dict(pixels [P, 2], frames,
    oracle [1 + F, P, 3] (row 0 the un-animated pose, then each frame),
    loss, grad, loss_top, grad_top); a size it lacks fails."""
    z = np.load(REFERENCE)
    pre = f"{cfg.width}x{cfg.height}/"
    if pre + "pixels" not in z.files:
        fail(cell, "check", f"{REFERENCE} holds no reference at {cfg.width}x{cfg.height}")
    ref = {k: z[pre + k] for k in ("pixels", "frames", "oracle")}
    for part in ("", "_top"):
        ref["loss" + part] = float(z[pre + "loss" + part])
        ref["grad" + part] = {k[len(pre + "grad" + part) + 1:]: z[k] for k in z.files
                              if k.startswith(pre + "grad" + part + "/")}
    return ref


def pixel_reading(got, want):
    """Share of the sampled pixels whose worst channel is off the oracle by
    more than PIXEL_TOL, and the largest error."""
    d = np.abs(np.asarray(got, np.float64) - want).max(axis=-1)
    return float((d > PIXEL_TOL).mean()), float(d.max())


def rounded(x, dtype):
    return torch.as_tensor(x).to(dtype).float().numpy()


def grad_reading(got, ref):
    """(share of the leaves off, the worst leaf's relative error, that
    leaf, the leaves off) against the reference {path: gradient}, over
    the leaves whose norm is at least LEAF_FLOOR of the largest's."""
    norms = {k: float(np.linalg.norm(v)) for k, v in ref.items()}
    top = max(norms.values())
    rel = {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - v)) / norms[k]
           for k, v in ref.items() if norms[k] >= LEAF_FLOOR * top}
    worst = max(rel, key=rel.get)
    off = sorted(k for k, r in rel.items() if r > GRAD_TOL)
    return len(off) / len(rel), rel[worst], worst, off


def graph_state(fit=None):
    """What a capture would change: the cached frames, and a fit's frame
    and update piece."""
    from txr_torch.render import render as rr

    state = [(k, id(f), f.captured) for k, f in rr._FRAMES.items()]
    if fit is not None:
        state.append((id(fit.frame), fit.frame.captured, id(getattr(fit.update, "piece", None))))
    return state


def sync_free(dev, run, n):
    """n units under set_sync_debug_mode("error") → True, or the error."""
    if dev.type != "cuda":
        return "not measured (cpu)"
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(n):
            run(k)
        return True
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sync(dev)


def windows(dev, run, n, repeats, after):
    """``repeats`` windows of run(0), ..., run(n − 1) back to back → (ms by
    CUDA events, ms by the host clock) per window and the ms of each unit
    (events between units; the CPU: the host clock for all three);
    ``after()`` is called once each window is timed."""
    cuda = dev.type == "cuda"
    ev_ms, wall_ms, unit_ms = [], [], []
    for _ in range(repeats):
        sync(dev)
        marks = []
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[0].record()
        t = [time.perf_counter()]
        for k in range(n):
            run(k)
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            t.append(time.perf_counter())
        sync(dev)
        wall_ms.append((time.perf_counter() - t[0]) * 1e3)
        if cuda:
            ev_ms.append(marks[0].elapsed_time(marks[-1]))
            unit_ms += [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            ev_ms.append(wall_ms[-1])
            unit_ms += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        after()
    return ev_ms, wall_ms, unit_ms


def unit_stats(ms):
    """The units' ms: count, median, the highest quantile with at least
    10 units beyond it (at least the median), and the largest."""
    q = max(0.5, 1 - 10 / len(ms))
    return dict(count=len(ms), p50=float(np.quantile(ms, 0.5)), q=q,
                p_high=float(np.quantile(ms, q)), max=max(ms))


def check_frames(cell, frames, ref):
    """Phase check of the forward cell: frames = [(window, k, pixels)]."""
    oracle = {int(k): ref["oracle"][1 + i] for i, k in enumerate(ref["frames"])}
    rows = []
    for w, k, px in frames:
        sound = pixel_reading(px, oracle[k])
        rows.append(dict(window=w, frame=k, off=sound[0], worst=sound[1],
                         off_fp16=pixel_reading(rounded(px, torch.float16), oracle[k])[0],
                         off_bf16=pixel_reading(rounded(px, torch.bfloat16), oracle[k])[0]))
    rec = dict(cell=cell, phase="check", pixels=len(ref["pixels"]), frames=len(rows),
               limits=dict(pixel_tol=PIXEL_TOL, pixel_frac=PIXEL_FRAC),
               off_max=max(r["off"] for r in rows),
               off_fp16_min=min(r["off_fp16"] for r in rows),
               off_bf16_min=min(r["off_bf16"] for r in rows), per_frame=rows)
    emit(rec)
    if rec["off_max"] > PIXEL_FRAC:
        fail(cell, "check", "a frame of the window disagrees with the f64 oracle")
    return rec


def check_fit(cell, fit, seen, params0, steps, window_steps, ref):
    """Phase check of the train cell: seen = [(loss, {path: gradient},
    pixels)] after each window; the fit's Adam moments after ``steps``
    steps, ``window_steps`` of them in the windows; params0 its start."""
    rows = []
    for w, (loss, grads, px) in enumerate(seen):
        off, rel, leaf, names = grad_reading(grads, ref["grad"])
        rows.append(dict(window=w, loss=loss, loss_rel=abs(loss - ref["loss"]) / ref["loss"],
                         leaves_off=off, worst_rel=rel, worst_leaf=leaf, off_leaves=names,
                         leaves_off_bf16=grad_reading({k: rounded(v, torch.bfloat16)
                                                       for k, v in grads.items()},
                                                      ref["grad"])[0],
                         off=pixel_reading(px, ref["oracle"][0])[0],
                         off_bf16=pixel_reading(rounded(px, torch.bfloat16), ref["oracle"][0])[0]))
    # Adam at rate 0 with one gradient g at every step: after n steps the
    # moments are (1 − β1ⁿ)·g and (1 − β2ⁿ)·g², and the parameters unchanged
    group = fit.opt.param_groups[0]
    b1, b2 = (float(b) for b in group["betas"])
    g = seen[-1][1]

    def moments_rel(n):
        worst = 0.0
        for p, v in fit.params.items():
            st = fit.opt.state[v]
            for got, want in ((st["exp_avg"], (1 - b1 ** n) * g[p]),
                              (st["exp_avg_sq"], (1 - b2 ** n) * g[p] ** 2)):
                err = float(np.linalg.norm(got.double().cpu().numpy() - want))
                worst = max(worst, err / max(float(np.linalg.norm(want)), 1e-30))
        return worst

    unchanged = all(torch.equal(v, params0[p]) for p, v in fit.params.items())
    rec = dict(cell=cell, phase="check", windows=len(rows), steps=steps,
               limits=dict(loss_rel=LOSS_REL, grad_tol=GRAD_TOL, grad_frac=GRAD_FRAC,
                           leaf_floor=LEAF_FLOOR, moment_rel=MOMENT_REL, pixel_tol=PIXEL_TOL,
                           pixel_frac=PIXEL_FRAC),
               ref_loss=ref["loss"], loss_rel_max=max(r["loss_rel"] for r in rows),
               leaves_off_max=max(r["leaves_off"] for r in rows),
               off_max=max(r["off"] for r in rows),
               moment_rel=moments_rel(steps), params_unchanged=unchanged,
               controls=dict(
                   loss_rel_top=abs(ref["loss_top"] - ref["loss"]) / ref["loss"],
                   leaves_off_top=grad_reading(ref["grad_top"], ref["grad"])[0],
                   leaves_off_bf16_min=min(r["leaves_off_bf16"] for r in rows),
                   moment_rel_frozen_in_windows=moments_rel(steps - window_steps),
                   off_bf16_min=min(r["off_bf16"] for r in rows)),
               per_window=rows)
    emit(rec)
    bad = [k for k, lim in (("loss_rel_max", LOSS_REL), ("leaves_off_max", GRAD_FRAC),
                            ("off_max", PIXEL_FRAC), ("moment_rel", MOMENT_REL))
           if not rec[k] <= lim]
    if bad or not unchanged:
        fail(cell, "check", f"the timed steps disagree with the reference: "
                            f"{bad + ([] if unchanged else ['params_unchanged'])}")
    return rec


def priced(cell, calls, prof):
    """{kernel: launches, device ms, the least ms of the priced calls'
    work and the roofline share} of the kernels the profiled replay ran;
    fails where the priced calls are not the replay's launches (no device
    times on the CPU)."""
    from txr_torch.kernels import launch_counts
    from txr_torch.utils.flops import bound_by

    out = {}
    for k in launch_counts():
        mine = [c for c in calls if c["kernel"] == k]
        launches = None if prof is None else prof["counted"][k]
        if not mine and not launches:
            continue
        if prof is not None and len(mine) != launches:
            fail(cell, "bounds", f"{k}: {len(mine)} priced calls, {launches} launches in the "
                                 "replay")
        ops, nbytes = sum(c["ops"] for c in mine), sum(c["bytes"] for c in mine)
        bound = sum(c["bound_ms"] for c in mine)
        row = dict(priced_calls=len(mine), live_lanes=sum(c["live"] for c in mine), ops=ops,
                   bytes=nbytes, bound_ms=bound, bound_by=bound_by(ops, nbytes))
        if prof is not None:
            ms = prof["kernel_ms"][k]
            row.update(launches=launches, device_ms=ms,
                       device_ms_per_launch=ms / launches if launches else None,
                       roofline_share=bound / ms if ms else None)
        out[k] = row
    return out


def run_cell(cell, args, dev):
    """The phases of one cell after its gate → its result line."""
    from txr_torch.apps.demo import update_scene
    from txr_torch.apps.profile_frame import profile_replay, uncaptured
    from txr_torch.kernels import launch_counts, reset_launch_counts
    from txr_torch.render.render import clear_jit_cache, render_jit
    from txr_torch.utils.flops import frame_flops_per_ray, live_fractions, priced_launches

    train = cell == "demo-1080p-train"
    cuda = dev.type == "cuda"
    scene, handles, textures, cfg = demo(dev, args.width, args.height)
    ref = reference(cfg, cell)
    rows, cols = (torch.as_tensor(ref["pixels"][:, i], device=dev) for i in (0, 1))
    n_rays = cfg.width * cfg.height
    t0 = time.perf_counter()

    if train:
        fit = fit_of(scene, textures, cfg, dev)
        params0 = {p: v.clone() for p, v in fit.params.items()}
        n, unit, taken, seen = args.steps, "step", [0], []

        def run(k):
            fit.step(k)
            taken[0] += 1

        def after():
            flat = fit.frame.flat.clone().double().cpu()
            grads = dict(zip(fit.params, flat[1:].split([v.numel() for v in
                                                         fit.params.values()])))
            seen.append((float(flat[0]), {p: grads[p].view(v.shape).numpy()
                                          for p, v in fit.params.items()},
                         fit.frame.programs[-1].out[rows, cols].cpu().numpy()))

        replay = lambda: fit.step(0)
    else:
        fit = None
        n, unit = args.frames, "frame"
        poses = [k / FPS for k in range(n)]
        checked = [int(k) for k in ref["frames"] if k < n]
        if not checked:
            fail(cell, "check", f"none of the reference's frames {ref['frames'].tolist()} is "
                                f"in a window of {n}")
        kept, seen = [None], []

        def run(k):
            with torch.no_grad():
                img = render_jit(update_scene(scene, handles, 0.0, poses[k]), textures, cfg,
                                 device=dev)
            if kept[0] is not None and k in checked:
                kept[0].append((k, img))

        def after():
            seen.extend((len(seen) // len(checked), k, img[rows, cols].cpu().numpy())
                        for k, img in kept[0])
            kept[0] = []

        pose0 = update_scene(scene, handles, 0.0, 0.0)
        replay = lambda: render_jit(pose0, textures, cfg, device=dev)

    # first call: warm-up and capture
    if cuda:
        torch.cuda.empty_cache()
        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
    t1 = time.perf_counter()
    run(0)
    sync(dev)
    first_call_s = time.perf_counter() - t1
    pool_gb = (torch.cuda.memory_reserved(dev) - reserved0) / 1e9 if cuda else None
    t1 = time.perf_counter()
    for k in range(1 if train else n):
        run(k)
    sync(dev)
    emit(dict(cell=cell, phase="first_call", first_call_s=first_call_s,
              pool_gb=pool_gb, untimed_s=time.perf_counter() - t1,
              untimed=f"{'one step (captures the update)' if train else f'{n} frames'}"))

    free = sync_free(dev, run, 2)
    emit(dict(cell=cell, phase="sync", units=2, sync_free=free))
    if cuda and free is not True:
        fail(cell, "sync", f"a host read in a {unit}: {free}")

    state = graph_state(fit)
    reset_launch_counts()
    if not train:
        kept[0] = []
    ev_ms, wall_ms, unit_ms = windows(dev, run, n, args.repeats, after)
    launches = launch_counts()
    captured_inside = graph_state(fit) != state
    total_ms = sum(ev_ms)
    mean = total_ms / len(ev_ms)
    win = dict(cell=cell, phase="window", units=n, unit=unit, repeats=args.repeats,
               window_ms=ev_ms, window_wall_ms=wall_ms, total_ms=total_ms,
               unit_ms=unit_stats(unit_ms),
               spread=(max(ev_ms) - min(ev_ms)) / mean,
               launches_per_unit={k: v / (n * args.repeats) for k, v in launches.items()},
               capture_inside=captured_inside)
    emit(win)
    if captured_inside:
        fail(cell, "window", "a graph was captured inside the timed window")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None

    if train:
        check_fit(cell, fit, seen, params0, taken[0], n * args.repeats, ref)
    else:
        check_frames(cell, seen, ref)

    # one replay profiled; then the same frame or step with its pieces eager
    # (the replay's launches), every kernel call priced
    with torch.no_grad():
        prof = profile_replay(replay) if cuda else None
    if prof is not None:
        emit(dict(cell=cell, phase="profile", **prof))
        if prof["traced"] != prof["counted"]:
            fail(cell, "profile", "the traced kernel events differ from the counted launches")
    else:
        emit(dict(cell=cell, phase="profile", not_measured="no device trace on the CPU"))
    if fit is not None:
        fit.close()
    del fit
    clear_jit_cache()
    with uncaptured():
        if train:
            eager = fit_of(scene, textures, cfg, dev)
            eager.step(0)
            with priced_launches() as calls:
                eager.step(1)
            del eager
        else:
            with torch.no_grad():
                replay()
                with priced_launches() as calls:
                    replay()
    clear_jit_cache()
    kernels = priced(cell, calls, prof)
    emit(dict(cell=cell, phase="bounds", kernels=kernels))
    shares = [r["roofline_share"] for r in kernels.values() if r.get("roofline_share")]
    if any(s >= 1.0 for s in shares):
        fail(cell, "bounds", "a kernel reads at or over its least time: the work model is wrong")

    metric = "fwd_bwd_rays_per_s" if train else "forward_rays_per_s"
    units = n * args.repeats
    value = n_rays * units / (total_ms / 1e3)
    result = {"cell": cell, "phase": "result", "metric": metric, "value": value,
              "unit": "rays/s", metric: value, f"{unit}_ms": total_ms / units, "correct": True,
              "size": f"{cfg.width}x{cfg.height}", "units": units, "repeats": args.repeats,
              "window_ms": ev_ms, "spread": win["spread"], f"{unit}_ms_stats": win["unit_ms"],
              "first_call_s": first_call_s, "peak_gb": peak_gb, "pool_gb": pool_gb}
    if prof is not None:
        result.update(busy_share=prof["busy_share"], device_ms=prof["device_ms"],
                      wall_ms=prof["wall_ms"])
    result["kernels"] = {k: {f: r.get(f) for f in ("launches", "device_ms_per_launch",
                                                   "bound_ms", "roofline_share")}
                         for k, r in kernels.items()}
    if not train:
        lf = live_fractions(pose0, textures, cfg, device=dev)
        per_ray = frame_flops_per_ray(scene, cfg, lf)
        result.update(live_fractions=lf, flops_per_ray=per_ray,
                      achieved_tflops=per_ray * value / 1e12)
    result["cell_s"] = time.perf_counter() - t0
    result["device"] = card(dev)
    if cuda:
        torch.cuda.empty_cache()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=CELLS, default=None, help="one cell (default: both)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (the tests)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=30, help="frames in a window (forward cell)")
    ap.add_argument("--steps", type=int, default=10, help="steps in a window (train cell)")
    ap.add_argument("--repeats", type=int, default=5, help="timed windows")
    ap.add_argument("--oracle", default=os.path.join(ROOT, "txr", "ref", "gate_oracle.npz"),
                    help=argparse.SUPPRESS)     # the tests give an altered one
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from txr_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from txr_torch.kernels import build
        from txr_torch.kernels.scene_table import pack_scene
        from txr_torch.apps.demo import build_scene

        build.build_all([("step_probe", ()), ("shadow_sweep", ()), ("lane_map", ()),
                         ("nearest_hit", build.topology(pack_scene(build_scene(64, 36)[0],
                                                                   None)[1]))])
    for cell in ([args.cell] if args.cell else CELLS):
        gate(cell, dev, args.oracle, cell == "demo-1080p-train")
        emit(run_cell(cell, args, dev))


if __name__ == "__main__":
    main()
