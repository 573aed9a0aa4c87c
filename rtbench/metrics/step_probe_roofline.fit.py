"""step_probe_roofline.fit: the step-probe kernel's share, in per cent, of
its roofline in the fit's captured step: the least time of the step's
probe work (its forward is the posed frame's: every bounce step's probe and
glossy probe, priced by rtbench/work from the reference's lane counts of
the fit's pose) over the kernel's device time a step in the traced steps
(device events named step_probe_kernel).  The backward launches no probe:
its probe-route steps read the forward's saved rows."""
KERNELS = ("step_probe_kernel",)
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"].get("step_probe")
    if ctx["kind"] != "fit" or p is None or not least or not ctx["units"]:
        return None
    ms = p["kernel_s"]["step_probe_kernel"] * 1e3 / ctx["units"]
    return 100.0 * least / ms if ms > 0 else None
