"""host_wait_ms.view: the milliseconds a frame in which the program's host
waits on the card (its ``txr.wait*`` spans: the bounce loop's wait for the
live count of step k − 2), the mean over the window's frames that no
profiler traced (``rtbench/spans.py``)."""
from rtbench import spans


def read(ctx):
    frames = spans.window_frames() if ctx["kind"] == "view" else None
    if not frames:
        return None
    return sum(spans.ms(f, spans.is_wait) for f in frames) / len(frames)
