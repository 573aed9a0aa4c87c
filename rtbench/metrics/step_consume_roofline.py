"""step_consume_roofline: csrc/step_consume.cu's share, in per cent, of its
roofline: the least time of a frame's consume work (the glossy-rays and
the consume entry points of every bounce step, priced by rtbench/work from
the reference's lane counts of the run's checked frames) over their device
time a frame in the traced frames (device events named
step_consume_rays_kernel and step_consume_kernel)."""
KERNELS = ("step_consume_rays_kernel", "step_consume_kernel")
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"]
    if ctx["kind"] != "view" or p is None or "step_consume" not in least or not ctx["units"]:
        return None
    ms = sum(p["kernel_s"][k] for k in KERNELS) * 1e3 / ctx["units"]
    want = least["step_consume"] + least.get("glossy_rays", 0.0)
    return 100.0 * want / ms if ms > 0 else None
