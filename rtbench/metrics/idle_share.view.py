"""idle_share.view: the share, in per cent, of a frameview's wall time in which no operation
runs on the device: 100 · (1 − device time a unit over the traced units ÷
wall time a unit over the same window's untraced units).  The profiler
slows the host's side of a unit, so the traced units' own wall time would
read the device idler than it is."""


def read(ctx):
    p = ctx["profile"]
    if ctx["kind"] != "view" or p is None or not ctx["units"] or not ctx["wall_ms"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] * 1e3 / ctx["units"] / ctx["wall_ms"])
