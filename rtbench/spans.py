"""The program's own spans and counters, for the metrics that read them
(``rtbench/metrics/{host_self_ms,host_wait_ms,lane_use}.view.py``,
``capture_graph_s.py``).

Importing this module turns the program's tracer on
(``txr_torch.utils.profiling.tracing``).  ``run.py`` loads the metric
readers, which import it, in ``--trace 1`` runs alone and before set-up:
so the tracer records the capture and the whole window of a traced run,
and stays off in every untraced run, which gives the end-to-end metrics.
A program without the tracer leaves ``TRACER`` None, and every reader
then returns None.

A record is one unit of the program's work (a ``render_jit`` call, a
captured train step): its spans (name, start and end in ns of
``time.perf_counter_ns``, parent, unit id) and counters ({name: [value
added, in order]}); ``profiled`` says whether a ``torch.profiler`` ran
during it.
"""

from __future__ import annotations

import importlib


def _tracer():
    try:
        profiling = importlib.import_module("txr_torch.utils.profiling")
    except ImportError:
        return None
    if not all(hasattr(profiling, k) for k in ("tracing", "records")):
        return None
    profiling.tracing(True)
    return profiling


TRACER = _tracer()


def records():
    """Every closed record of the run so far, oldest first (None: the
    program has no tracer)."""
    return None if TRACER is None else TRACER.records()


def window_frames():
    """The records of the window's frames that no profiler traced (those
    after the last frame it traced, as ``host_ms.view`` reads the window's
    frames after the traced ones) → a list, or None where there is no
    tracer or no profiled frame."""
    recs = records()
    if recs is None:
        return None
    frames = [r for r in recs if r["unit"] == "txr.frame"]
    traced = [i for i, r in enumerate(frames) if r["profiled"]]
    return frames[traced[-1] + 1:] if traced else None


def ms(rec, pick):
    """Milliseconds of the record's spans whose name ``pick`` accepts."""
    return sum(s.end - s.start for s in rec["spans"] if pick(s.name)) / 1e6


def is_wait(name):
    return name.startswith("txr.wait")


def total(recs, counter):
    """The sum of a counter over the records."""
    return sum(sum(r["counters"].get(counter, ())) for r in recs)
