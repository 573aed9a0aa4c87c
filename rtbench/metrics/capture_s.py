"""capture_s: the seconds of the first calls, which warm up and capture
every CUDA graph the cell replays (the viewer's first frame; the fit's
first two steps: the frame's graphs, then the update's), by the host
clock."""


def read(ctx):
    return ctx["capture_s"]
