"""host_ms.view: the host's milliseconds a frame in the viewer loop (the
pose's update_scene, render_jit's enqueue, the uint8 conversion and the
copy's start), by the harness's host-clock span around them, the mean over
the window's frames that the profiler did not trace."""


def read(ctx):
    ms = ctx["host_ms"] if ctx["kind"] == "view" else []
    return sum(ms) / len(ms) if ms else None
