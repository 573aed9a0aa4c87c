"""device_ms.fit: device milliseconds a fit step: the union of the
profiler's device events inside the traced span over the steps traced."""
KERNELS = ()


def read(ctx):
    p = ctx["profile"]
    if ctx["kind"] != "fit" or p is None or not ctx["units"]:
        return None
    return p["busy_s"] * 1e3 / ctx["units"]
