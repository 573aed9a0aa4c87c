"""step_consume_roofline.fit: csrc/step_consume.cu's share, in per cent, of
its roofline in the fit's captured step: the least time of the step's
consume work (the glossy-rays and the consume entry points of every
forward bounce step, priced by rtbench/work from the reference's lane
counts of the fit's pose) over their device time a step in the traced
steps (device events named step_consume_rays_kernel and
step_consume_kernel)."""
KERNELS = ("step_consume_rays_kernel", "step_consume_kernel")
PRICED = True


def read(ctx):
    p, least = ctx["profile"], ctx["least_ms"]
    if ctx["kind"] != "fit" or p is None or "step_consume" not in least or not ctx["units"]:
        return None
    ms = sum(p["kernel_s"][k] for k in KERNELS) * 1e3 / ctx["units"]
    want = least["step_consume"] + least.get("glossy_rays", 0.0)
    return 100.0 * want / ms if ms > 0 else None
