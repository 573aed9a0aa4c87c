"""host_self_ms.view: the host's own milliseconds a frame in the program:
the pose (``txr.pose``) and ``render_jit`` (its root span ``txr.frame``)
less every wait on the card inside them (``txr.wait*`` spans), the mean
over the window's frames that no profiler traced.  The program's own
host-clock spans (``rtbench/spans.py``)."""
from rtbench import spans


def read(ctx):
    frames = spans.window_frames() if ctx["kind"] == "view" else None
    if not frames:
        return None
    own = lambda n: n in ("txr.pose", "txr.frame")
    return sum(spans.ms(f, own) - spans.ms(f, spans.is_wait) for f in frames) / len(frames)
