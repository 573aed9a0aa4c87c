"""device_ms.view: device milliseconds a frame of the viewer loop: the union
of the profiler's device events inside the traced span over the frames
traced."""
KERNELS = ()


def read(ctx):
    p = ctx["profile"]
    if ctx["kind"] != "view" or p is None or not ctx["units"]:
        return None
    return p["busy_s"] * 1e3 / ctx["units"]
