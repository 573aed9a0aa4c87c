"""pose_replayed.view: the share, in per cent, of the poses that ran as one
graph replay: 100 · Σ ``pose_replays`` ÷ Σ ``poses``, the program's
counters of ``apps.demo.update_scene`` (1 a call; 1 a replay of its
captured pose), over the window's frames that no profiler traced
(``rtbench/spans.py``).  None where the program counts no pose."""
from rtbench import spans


def read(ctx):
    frames = spans.window_frames() if ctx["kind"] == "view" else None
    if not frames:
        return None
    poses = spans.total(frames, "poses")
    return 100.0 * spans.total(frames, "pose_replays") / poses if poses else None
