"""mfu.fit: the whole fit step's share, in per cent, of the card's peak:
the least time of the step's priced kernel work (its forward's probe,
glossy rays and consume; rtbench/work) over the wall time a step of the
window's untraced steps.  The backward and the update are not priced, so
the share is a lower bound; a kernel taken off the path leaves its
roofline silent, and this share still bounds the step."""
KERNELS = ()
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"]
    if ctx["kind"] != "fit" or p is None or not least or not ctx["wall_ms"]:
        return None
    return 100.0 * sum(least.values()) / ctx["wall_ms"]
