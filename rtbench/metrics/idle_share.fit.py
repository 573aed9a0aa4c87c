"""idle_share.fit: the share, in per cent, of the traced steps' span in
which no operation ran on the device: 100 · (1 − busy / span).  A step is
device-bound, and tracing its 59,000 kernels lengthens its device time
past the untraced steps' wall time, so unlike the viewer's the share is
taken over the traced span itself."""


def read(ctx):
    p = ctx["profile"]
    if ctx["kind"] != "fit" or p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
