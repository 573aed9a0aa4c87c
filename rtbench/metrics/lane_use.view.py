"""lane_use.view: the share, in per cent, of the rows the bounce steps ran
that held a live lane: 100 · Σ ``lanes`` ÷ Σ ``rows``, the program's
counters of each step (its live lanes entering, its capacity), over every
program of a frame (the base pass and, with edge AA, the edge pass, whose
fill lanes count as live) and the window's frames that no profiler traced
(``rtbench/spans.py``)."""
from rtbench import spans


def read(ctx):
    frames = spans.window_frames() if ctx["kind"] == "view" else None
    if not frames:
        return None
    rows = spans.total(frames, "rows")
    return 100.0 * spans.total(frames, "lanes") / rows if rows else None
