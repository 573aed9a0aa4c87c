"""mfu.view: the whole frame's share, in per cent, of the card's peak: the
least time of the frame's priced kernel work (probe, glossy rays, consume;
rtbench/work) over the wall time a frame of the window's untraced frames.
A kernel taken off the path leaves its roofline silent; this share still
bounds the frame."""
KERNELS = ()
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"]
    if ctx["kind"] != "view" or p is None or not least or not ctx["units"]:
        return None
    return 100.0 * sum(least.values()) / ctx["wall_ms"] if ctx["wall_ms"] else None
