"""Where one demo frame's time goes on the card: device time by kernel.

Renders the demo scene once to warm up, then once under torch.profiler,
and prints the frame's wall time, the summed device time of the kernels,
copies and fills in the trace, the device's busy share (device time over
wall time; one stream, so device work does not overlap), the probe
kernel's share and the kernels that take the most device time.  Needs a
CUDA card:

    python -m txr_torch.apps.profile_frame [--width 1920] [--height 1080]
        [--trace frame_trace.json]
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
from txr_torch.kernels import step_probe as sp
from txr_torch.render.render import render
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, auto_refraction_steps

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
    ap.add_argument("--trace", default=None, help="keep the chrome trace here")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    scene, _ = build_scene(args.width, args.height)
    scene = scene.to(dev)
    textures = with_mips(demo_textures().to(dev))
    cfg = RenderConfig(width=args.width, height=args.height, iterations=5,
                       extra_refraction_steps=auto_refraction_steps(scene))
    render(scene, textures, cfg, device=dev)
    torch.cuda.synchronize()

    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sp.step_probe.launches = 0
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        render(scene, textures, cfg, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = sp.step_probe.launches

    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "frame_trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
    rows = by_name(events)
    device_ms = sum(d for _, d in events)
    probe = [d for name, d in events if "step_probe_kernel" in name]
    summary = dict(
        width=args.width, height=args.height, wall_ms=wall_ms, device_ms=device_ms,
        busy_share=device_ms / wall_ms, probe_ms=sum(probe), probe_launches=launches,
        probe_launch_ms=probe, device_events=len(events),
        device=torch.cuda.get_device_name(dev))
    print(json.dumps(summary))
    for ms, count, key in rows[:args.top]:
        print(f"{ms:9.3f} ms {count:6d}x  {key[:110]}")


if __name__ == "__main__":
    main()
