"""Where one demo frame's time goes on the card: device time by kernel.

Renders the demo scene once to warm up, then once under torch.profiler,
and prints the frame's wall time, the summed device time of the kernels,
copies and fills in the trace, the device's busy share (device time over
wall time; one stream, so device work does not overlap), each txr kernel's
launches and device time, and the kernels that take the most device time.
With ``--backward`` the profiled unit is one training step instead: the
forward render and the gradient of mean(img²) with respect to every float
scene leaf.  With ``--jit`` it is one frame of ``render_jit``: the warm-up
call captures the frame's CUDA graphs, and the profiled call replays them
(the launch counts are the replay's, from the captured counts); with
``--jit --backward``, one replayed train step of ``optimize_scene`` on the
same loss (every float leaf, Adam at lr 0, so both calls take the same
step): forward, loss, backward, gradient norm and update.
``--fused`` picks the route (RenderConfig.fused).  Needs a CUDA card:

    python -m txr_torch.apps.profile_frame [--width 1920] [--height 1080]
        [--backward] [--jit] [--fused auto|on|off] [--trace frame_trace.json]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import torch

from txr_torch import resolve_device
from txr_torch.apps.demo import build_scene, demo_textures
from txr_torch.diff.optimize import _Fit
from txr_torch.kernels import nearest_hit as nh
from txr_torch.kernels import shadow_sweep as ss
from txr_torch.kernels import step_probe as sp
from txr_torch.render.render import render, render_jit
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, auto_refraction_steps
from txr_torch.scene.types import float_leaves, unflatten_like

# launch counter and device kernel name of each txr kernel
KERNELS = dict(step_probe=(sp.step_probe, "step_probe_kernel"),
               nearest_hit=(nh.launch, "nearest_hit_kernel"),
               shadow_sweep=(ss.launch, "shadow_sweep_kernel"))

# trace event categories of work on the device (kineto's chrome trace)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace_path):
    """[(name, ms)] of the device events in a chrome trace, in time order.
    Operator rows of key_averages() also carry the device time of the
    kernels they launch, so the trace's device events are read instead."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return [(e["name"], e["dur"] / 1e3) for e in sorted(dev, key=lambda e: e["ts"])]


def by_name(events):
    """[(ms, count, name)] summed by kernel name, largest first."""
    ms = collections.defaultdict(float)
    count = collections.Counter()
    for name, d in events:
        ms[name] += d
        count[name] += 1
    return sorted(((ms[k], count[k], k) for k in ms), reverse=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--backward", action="store_true",
                    help="profile a forward + backward training step")
    ap.add_argument("--jit", action="store_true",
                    help="profile a replayed frame of render_jit (with --backward: a replayed "
                         "train step)")
    ap.add_argument("--fused", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--trace", default=None, help="keep the chrome trace here")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    scene, _ = build_scene(args.width, args.height)
    scene = scene.to(dev)
    textures = with_mips(demo_textures().to(dev))
    cfg = RenderConfig(width=args.width, height=args.height, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene), fused=args.fused)

    if args.jit and args.backward:
        fit = _Fit(scene, textures, cfg, torch.zeros((args.height, args.width, 3), device=dev),
                   lr=0.0, device=dev)

    def unit():
        if args.jit and args.backward:
            return fit.step(0)
        if args.jit:
            with torch.no_grad():
                return render_jit(scene, textures, cfg, device=dev)
        if not args.backward:
            return render(scene, textures, cfg, device=dev)
        leaves = {k: v.detach().requires_grad_(True) for k, v in float_leaves(scene).items()}
        img = render(unflatten_like(scene, leaves), textures, cfg, device=dev)
        return torch.autograd.grad((img * img).mean(), list(leaves.values()), allow_unused=True)

    unit()
    torch.cuda.synchronize()

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for counter, _ in KERNELS.values():
        counter.launches = 0
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: counter.launches for k, (counter, _) in KERNELS.items()}

    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "frame_trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
    rows = by_name(events)
    device_ms = sum(d for _, d in events)
    kernels = {k: dict(launches=launches[k], ms=sum(d for name, d in events if kname in name))
               for k, (_, kname) in KERNELS.items()}
    summary = dict(
        width=args.width, height=args.height, backward=args.backward, jit=args.jit,
        fused=args.fused,
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        kernels=kernels, device_events=len(events), device=torch.cuda.get_device_name(dev))
    print(json.dumps(summary))
    for ms, count, key in rows[:args.top]:
        print(f"{ms:9.3f} ms {count:6d}x  {key[:110]}")


if __name__ == "__main__":
    main()
