"""Tracing and timing (txr/utils/profiling.py).

* ``FrameTimer``: frame rate and rays/s reported once per interval, every
  sample fenced by ``torch.cuda.synchronize`` on the device of the frame's
  tensors, so queued launches cannot make a frame look faster than it is;
* ``profile_trace``: a ``torch.profiler`` run written as a Chrome trace;
* ``timed``: a wall-clock timer for a block of code.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._pytree import tree_leaves


def fence(results):
    """Wait for every CUDA device that holds one of ``results``' tensors."""
    for dev in {x.device for x in tree_leaves(results)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class FrameTimer:
    """Fenced frame timing with a once-per-interval report, like the
    reference's FPS counter (main.cpp:169-174) but waiting on the card."""

    def __init__(self, rays_per_frame=0, interval=1.0, log=print):
        self.rays = rays_per_frame
        self.interval = interval
        self.log = log
        self._count = 0
        self._t0 = None
        self.history = []

    def frame(self, *results):
        """Mark the end of a frame whose outputs are ``results``."""
        fence(results)
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        self._count += 1
        dt = now - self._t0
        if dt >= self.interval:
            fps = self._count / dt
            self.history.append(fps)
            msg = f"FPS: {fps:.1f}"
            if self.rays:
                msg += f"  ({self.rays * fps:,.0f} rays/s)"
            self.log(msg)
            self._t0 = now
            self._count = 0


@contextlib.contextmanager
def profile_trace(logdir="txr_profile"):
    """Profile the block (host and, where there is one, CUDA activity) and
    write ``logdir/trace.json``, viewable in chrome://tracing or Perfetto.
    Yields the trace's path."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def timed(name, sink=None, log=print):
    """Wall-clock time of the block, into ``sink[name]`` (seconds) or
    logged in ms.  Fence the block's work yourself (e.g. ``float(loss)``)."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = dt
    else:
        log(f"{name}: {dt * 1e3:.2f} ms")
