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

``profile_replay`` (a replay's device time, its kernels, the device
operations of most time and the device's longest idle gaps) and
``uncaptured`` (a frame's pieces run eagerly on the card, each kernel call
through its Python wrapper) serve chip_smoke.py and the lane map's card
tests (tests/test_torch_lane_map.py).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import tempfile
import time

import torch

from txr_torch import resolve_device
from txr_torch.apps.demo import build_scene, demo_textures
from txr_torch.diff.optimize import _Fit
from txr_torch.kernels import lane_map as lm
from txr_torch.kernels import nearest_hit as nh
from txr_torch.kernels import shadow_sweep as ss
from txr_torch.kernels import launch_counts, reset_launch_counts
from txr_torch.kernels import step_consume as sc
from txr_torch.kernels import step_probe as sp
from txr_torch.render import graphs
from txr_torch.render.render import render, render_jit
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, auto_refraction_steps
from txr_torch.scene.types import float_leaves, unflatten_like

# launch counter of each txr kernel and the device kernels (``is_kernel``
# names) that one counted call launches, one of each
KERNELS = dict(step_probe=(sp.step_probe, ("step_probe_kernel",)),
               glossy_rays=(sc.launch_rays, ("step_consume_rays_kernel",)),
               step_consume=(sc.launch, ("step_consume_kernel",)),
               nearest_hit=(nh.launch, ("nearest_hit_kernel",)),
               shadow_sweep=(ss.launch, ("shadow_sweep_kernel",)),
               lane_compact=(lm.launch_compact, ("lane_count_kernel", "lane_compact_kernel")),
               lane_scatter=(lm.launch_scatter, ("lane_scatter_kernel",)))

# trace event categories of work on the device and of the host's work
# (kineto's chrome trace)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP_OPS, TOP_GAPS = 10, 5
# host-clock seconds traced on either side of the profiled calls: the tracer
# keeps only the device records inside its window, and the card's
# timestamps stray from the host's by up to a few ms
TRACE_SLACK_S = 0.05


def is_kernel(event, kname):
    """Whether the trace's device event ``event`` (a demangled signature,
    such as ``(anonymous namespace)::step_probe_kernel(txr::Meta, ...)``)
    is a launch of the kernel named ``kname``: that exact name, not a
    longer one that holds it."""
    return re.search(rf"(?:^|[\s:]){re.escape(kname)}[(<]", event) is not None


def kernel_events(dev_events, knames):
    """(calls, ms) of a txr kernel whose one call launches the device
    kernels ``knames``, in the device events ``dev_events``: the calls of
    which every kernel is in the trace, and the device ms of them all."""
    calls = min(sum(1 for n, _, _ in dev_events if is_kernel(n, k)) for k in knames)
    ms = sum(d for n, _, d in dev_events if any(is_kernel(n, k) for k in knames)) / 1e3
    return calls, ms


def trace_events(path):
    """(device events, host events) of a chrome trace: [(name, start µs,
    duration µs)] each, in time order."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    pick = lambda cats: sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                                if e.get("cat") in cats), key=lambda e: e[1])
    return pick(DEVICE_CATS), pick(HOST_CATS)


def device_events(trace_path):
    """[(name, ms)] of the device events in a chrome trace, in time order.
    Operator rows of key_averages() also carry the device time of the
    kernels they launch, so the trace's device events are read instead."""
    return [(name, dur / 1e3) for name, _, dur in trace_events(trace_path)[0]]


def top_ops(dev_events, n=TOP_OPS):
    """The n device operations of most total time: name, ms, count."""
    total, count = collections.defaultdict(float), collections.Counter()
    for name, _, dur in dev_events:
        total[name] += dur / 1e3
        count[name] += 1
    top = sorted(total, key=total.get, reverse=True)[:n]
    return [dict(name=k[:160], ms=total[k], count=count[k]) for k in top]


def idle_gaps(dev_events, host_events):
    """The TOP_GAPS longest stretches with no device event, from the first
    host event on, each with the host operation that overlaps it most
    (the shorter one on a tie; None: Python between operations)."""
    start = min(dev_events[0][1], host_events[0][1]) if host_events else dev_events[0][1]
    gaps, end = [], start
    for _, ts, dur in dev_events:
        if ts > end:
            gaps.append((ts - end, end, ts))
        end = max(end, ts + dur)
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:TOP_GAPS]:
        best = None
        for name, ts, dur in host_events:
            ov = min(b, ts + dur) - max(a, ts)
            if ov > 0 and (best is None or (ov, -dur) > best[0]):
                best = ((ov, -dur), name)
        out.append(dict(ms=length / 1e3, at_ms=(a - start) / 1e3,
                        host_op=None if best is None else best[1][:160]))
    return out


@contextlib.contextmanager
def profiled():
    """torch.profiler on the host and the card, TRACE_SLACK_S wider than
    the block on either side; the block's device work has ended when it
    closes → the profiler."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        time.sleep(TRACE_SLACK_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_SLACK_S)


def profile_replay(fn, tries=3):
    """One call of ``fn`` (a replay: its graphs are captured) under
    torch.profiler, after a warm call → dict(wall_ms, device_ms, busy_share,
    device_events, counted, traced, kernel_ms, top_ops, idle_gaps):
    ``counted`` the launches the wrappers count from zero around it,
    ``traced`` each txr kernel's calls in the trace (``kernel_events``),
    ``kernel_ms`` the device ms of all their kernels.  Up to ``tries`` traces, until one holds
    every counted launch (the tracer may drop device records)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        reset_launch_counts()
        with profiled() as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counted = launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            dev_events, host_events = trace_events(path)
        seen = {k: kernel_events(dev_events, knames) for k, (_, knames) in KERNELS.items()}
        traced = {k: calls for k, (calls, _) in seen.items()}
        kernel_ms = {k: ms for k, (_, ms) in seen.items()}
        device = sum(d for _, _, d in dev_events) / 1e3
        out = dict(wall_ms=wall, device_ms=device, busy_share=device / wall,
                   device_events=len(dev_events), counted=counted, traced=traced,
                   kernel_ms=kernel_ms, top_ops=top_ops(dev_events),
                   idle_gaps=idle_gaps(dev_events, host_events) if dev_events else [])
        if traced == counted:
            return out
    return out


@contextlib.contextmanager
def uncaptured():
    """While open, a frame built on the card keeps its pieces to run
    eagerly, as on the CPU: the same pieces, lane capacities and kernel
    launches as its replay, each launch through its Python wrapper (where
    ``utils/flops.py: priced_launches`` prices it).  Build the frame
    inside (``clear_jit_cache`` first: a cached frame stays captured)."""
    capture = graphs.Recorder.capture
    graphs.Recorder.capture = lambda self, fn: graphs._Eager(fn)
    try:
        yield
    finally:
        graphs.Recorder.capture = capture


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

    for counter, _ in KERNELS.values():
        counter.launches = 0
    with profiled() as prof:
        t0 = time.perf_counter()
        unit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: counter.launches for k, (counter, _) in KERNELS.items()}

    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "frame_trace.json")
        prof.export_chrome_trace(path)
        events, _ = trace_events(path)
    device_ms = sum(d for _, _, d in events) / 1e3
    kernels = {k: dict(launches=launches[k], ms=kernel_events(events, knames)[1])
               for k, (_, knames) in KERNELS.items()}
    summary = dict(
        width=args.width, height=args.height, backward=args.backward, jit=args.jit,
        fused=args.fused,
        wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
        kernels=kernels, device_events=len(events), device=torch.cuda.get_device_name(dev))
    print(json.dumps(summary))
    for op in top_ops(events, args.top):
        print(f"{op['ms']:9.3f} ms {op['count']:6d}x  {op['name'][:110]}")


if __name__ == "__main__":
    main()
