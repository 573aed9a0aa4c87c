"""Tracing (txr/utils/profiling.py): the port's own spans and counters, and
a ``torch.profiler`` helper.

* ``fence``: wait for the devices that hold a result's tensors;
* ``profile_trace``: a ``torch.profiler`` run written as a Chrome trace,
  with the tracer on;
* the tracer: spans and counters at the frame's layer boundaries, kept in
  memory, off until ``tracing(True)``.

The tracer.  A unit of work is one ``render_jit`` call (root span
``txr.frame``) or one captured train step (``txr.train_step``,
``diff.optimize._Fit.step``); it closes its record when it returns.
Spans and counters made before a unit opens (the pose, a fit's first
load) belong to the next unit that opens.  A span records its name, its
start and end (``time.perf_counter_ns``), the index of its parent in the
record's ``spans`` (None: none) and the unit's id; a counter is a list of
the values added to it, in order.  While a ``torch.profiler`` runs, each
span but the root also opens ``torch.profiler.record_function`` of its
name, so it shows as a ``user_annotation`` on the profiler's clock above
the device work it launched; the root stays in memory, as it would cover
every idle gap of the frame.  Off, a call site costs one flag test
(``span`` returns one shared null context, ``count`` returns) and the
tracer records, allocates and syncs nothing.  One thread: the tracer's
state is the process's.

Spans (``PERF.md`` §3 names the metric that reads each):

* ``txr.pose``: ``apps.demo.update_scene``, its pinned staging included;
* ``txr.frame``: the root, ``render_jit`` from entry to return;
* ``txr.key``: ``render._cached_frame``: textures, ``with_mips``, the
  leaves, the key and the cache lookup (a new key's frame built);
* ``txr.load``: ``_JitFrame._load``, the leaves' and textures' copies;
* ``txr.capture``: ``_JitFrame._capture``, warm-up and graph capture at a
  key's first call (``txr.head``, ``txr.tail`` of the warm-up inside);
* ``txr.head``, ``txr.tail``: a program's or a chunk's head or tail
  replay, with the chunk's copies in or out (``graphs.TraceProgram``,
  ``graphs.TraceUnit``);
* ``txr.step``: one bounce step: its capacity chosen, its replay, the
  count's copy and the event;
* ``txr.wait_live``: the host blocked on the live count of step k − 2;
  ``txr.wait_last``: the last step's count read after the tail, when the
  loop ran ``cfg.max_steps`` steps (only with the tracer on).  Every wait
  on the card in a frame is a ``txr.wait*`` span;
* ``txr.out``: ``_JitFrame.__call__``'s copy of the last program's out.

Counters, added per bounce step (``graphs.TraceUnit.run``): ``lanes``,
the live lanes entering it; ``rows``, its capacity, the rows it gathers,
steps and scatters; ``steps``, 1; and ``captures``, 1 per capture.
``100 · Σ lanes / Σ rows`` is the share of stepped rows that were live.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves


def fence(results):
    """Wait for every CUDA device that holds one of ``results``' tensors."""
    for dev in {x.device for x in tree_leaves(results)
                if isinstance(x, torch.Tensor) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profile_trace(logdir="txr_profile"):
    """Profile the block (host and, where there is one, CUDA activity) with
    the tracer on, its spans among the host's events, and write
    ``logdir/trace.json``, viewable in chrome://tracing or Perfetto.
    Yields the trace's path."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    was = tracing(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield path
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        tracing(was)
    prof.export_chrome_trace(path)


# -- the tracer -------------------------------------------------------------

class Span(NamedTuple):
    name: str
    start: int          # time.perf_counter_ns()
    end: int
    parent: int | None  # index into the record's spans
    unit: int           # the record's id


_ON = False
_NULL = contextlib.nullcontext()
_records = []       # closed records, oldest first
_open = None        # the record spans go to: the open unit's, or the next one's
_stack = []         # the open spans: their indices in _open's spans
_ids = itertools.count()


def tracing(on=True):
    """Turn the tracer on or off → whether it was on."""
    global _ON
    was, _ON = _ON, bool(on)
    return was


def enabled():
    """Whether the tracer is on."""
    return _ON


def records():
    """The closed records, oldest first: dicts of ``id``, ``unit`` (the
    root span's name), ``spans`` (``Span``s in order of start), ``counters``
    ({name: [values]}) and ``profiled`` (whether a ``torch.profiler`` ran
    during the unit)."""
    return list(_records)


def reset():
    """Drop every record, the open one too."""
    global _open
    _records.clear()
    _stack.clear()
    _open = None


def _record():
    global _open
    if _open is None:
        _open = dict(id=next(_ids), unit=None, spans=[], counters={}, profiled=False)
    return _open


class _Span:
    __slots__ = ("name", "root", "i", "fn", "start", "parent")

    def __init__(self, name, root):
        self.name, self.root = name, root

    def __enter__(self):
        rec = _open or _record()
        # a unit inside a unit is a span of the outer one
        self.root = self.root and rec["unit"] is None
        profiled = _autograd_profiler._is_profiler_enabled
        if profiled:
            rec["profiled"] = True
        if self.root:
            rec["unit"] = self.name
        self.fn = None
        if profiled and not self.root:
            self.fn = torch.profiler.record_function(self.name)
        spans = rec["spans"]
        self.i = len(spans)
        spans.append(None)
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.i)
        self.start = time.perf_counter_ns()
        if self.fn is not None:
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        global _open
        if self.fn is not None:
            self.fn.__exit__(*exc)
        end = time.perf_counter_ns()
        rec = _open
        rec["spans"][self.i] = Span(self.name, self.start, end, self.parent, rec["id"])
        _stack.pop()
        if self.root:
            if _autograd_profiler._is_profiler_enabled:
                rec["profiled"] = True
            _records.append(rec)
            _open = None
        return False


def span(name):
    """A span of the open unit (context manager); with the tracer off, the
    shared null context."""
    return _Span(name, False) if _ON else _NULL


def unit(name):
    """The root span of a unit of work: its record closes at its end."""
    return _Span(name, True) if _ON else _NULL


def count(name, n):
    """Add ``n`` to the open unit's counter ``name`` (nothing when off)."""
    if _ON:
        _record()["counters"].setdefault(name, []).append(n)
