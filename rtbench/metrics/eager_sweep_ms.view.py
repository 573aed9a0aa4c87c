"""eager_sweep_ms.view: device milliseconds a frame of the eager route's two
sweep kernels together, the device events named nearest_hit_kernel and
shadow_sweep_kernel (a template instantiation counts: ``name<``), over the
traced frames.  Beside ``device_ms.view`` it splits the eager frame between
the sweeps and the ATen body around them.  None where the traced frames
launch neither kernel (the probe route)."""
KERNELS = ("nearest_hit_kernel", "shadow_sweep_kernel")


def read(ctx):
    p = ctx["profile"]
    if ctx["kind"] != "view" or p is None or not ctx["units"]:
        return None
    s = sum(p["kernel_s"][k] for k in KERNELS)
    return s * 1e3 / ctx["units"] if s > 0 else None
