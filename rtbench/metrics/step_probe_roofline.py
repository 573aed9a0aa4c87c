"""step_probe_roofline: the step-probe kernel's share, in per cent, of its
roofline: the least time of a frame's probe work (every bounce step's probe
and glossy probe, priced by rtbench/work from the reference's lane counts
of the run's checked frames) over the kernel's device time a frame in the
traced frames (device events named step_probe_kernel)."""
KERNELS = ("step_probe_kernel",)
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"].get("step_probe")
    if ctx["kind"] != "view" or p is None or not least or not ctx["units"]:
        return None
    ms = p["kernel_s"]["step_probe_kernel"] * 1e3 / ctx["units"]
    return 100.0 * least / ms if ms > 0 else None
