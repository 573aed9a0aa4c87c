"""Reading a torch.profiler trace of part of the window.

The parsing is a copy of the program's ``apps/profile_frame.py``
(``trace_events``, ``top_ops``, ``idle_gaps``, ``is_kernel``), kept here
so that the yardstick does not move with the program.  It differs in one
thing: the traced units are marked by a ``record_function`` span
(``MARK``), and only device time inside that span counts, so the device's
busy and idle seconds are those of the marked units.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile

MARK = "rtbench.traced_units"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def is_kernel(event, kname):
    """Whether the device event ``event`` (a demangled signature) is a
    launch of the kernel named ``kname``: that exact name, not a longer
    one that holds it."""
    return re.search(rf"(?:^|[\s:]){re.escape(kname)}[(<]", event) is not None


def trace_events(path):
    """(device events, host events) of a chrome trace: [(name, start µs,
    duration µs)] each, in time order."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    pick = lambda cats: sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                                if e.get("cat") in cats), key=lambda e: e[1])
    return pick(DEVICE_CATS), pick(HOST_CATS)


def clip(events, a, b):
    """The events' parts inside [a, b]."""
    out = []
    for name, ts, dur in events:
        s, e = max(ts, a), min(ts + dur, b)
        if e > s:
            out.append((name, s, e - s))
    return out


def busy_us(dev_events):
    """Microseconds in which some device event runs (their union)."""
    total, end = 0.0, None
    for _, ts, dur in dev_events:
        if end is None or ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def top_ops(dev_events, n=TOP):
    """The n device operations of most total time → [[name, seconds]]."""
    total = collections.defaultdict(float)
    for name, _, dur in dev_events:
        total[name] += dur / 1e6
    return [[k[:160], total[k]] for k in sorted(total, key=total.get, reverse=True)[:n]]


def idle_gaps(dev_events, host_events, a, b, n=TOP):
    """The n longest stretches of [a, b] with no device event, each named
    by the host operation that overlaps it most (the shorter one on a
    tie; "python" where none does) → [[name, seconds]]."""
    gaps, end = [], a
    for _, ts, dur in dev_events:
        if ts > end:
            gaps.append((ts - end, end, ts))
        end = max(end, ts + dur)
    if b > end:
        gaps.append((b - end, end, b))
    out = []
    for length, s, e in sorted(gaps, reverse=True)[:n]:
        best = None
        for name, ts, dur in host_events:
            if name == MARK:
                continue
            ov = min(e, ts + dur) - max(s, ts)
            if ov > 0 and (best is None or (ov, -dur) > best[0]):
                best = ((ov, -dur), name)
        out.append(["python" if best is None else best[1][:160], length / 1e6])
    return out


def read(prof, kernels):
    """The marked units of a finished profiler → dict(window_s, busy_s,
    kernel_s {name: device seconds of that kernel}, device_ops, idle_gaps),
    or None when the trace holds no mark or no device event."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev, host = trace_events(path)
    marks = [(ts, ts + dur) for name, ts, dur in host if name == MARK]
    if not marks or not dev:
        return None
    a, b = marks[0][0], marks[-1][1]
    inside = clip(dev, a, b)
    if not inside:
        return None
    return dict(window_s=(b - a) / 1e6, busy_s=busy_us(inside) / 1e6,
                kernel_s={k: sum(d for name, _, d in inside if is_kernel(name, k)) / 1e6
                          for k in kernels},
                device_ops=top_ops(inside), idle_gaps=idle_gaps(inside, host, a, b))
