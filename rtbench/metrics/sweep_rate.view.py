"""sweep_rate.view: billions of (ray, slot) tests a second that the step
probe's nearest-hit sweeps make: Σ ``pairs`` a frame (the program's counter
of each bounce step: its live lanes entering times the scene's slots) over
the window's frames that no profiler traced (``rtbench/spans.py``), over
the device seconds a frame of the kernel named step_probe_kernel in the
traced frames.  The pairs leave out the glossy probe's sweeps and the
shadow probes, whose time the kernel's seconds hold: a lower bound on the
kernel's test rate.  None where the program counts no pairs."""
from rtbench import spans

KERNELS = ("step_probe_kernel",)


def read(ctx):
    p = ctx["profile"]
    frames = spans.window_frames() if ctx["kind"] == "view" else None
    if p is None or not frames or not ctx["units"]:
        return None
    pairs = spans.total(frames, "pairs") / len(frames)
    s = p["kernel_s"]["step_probe_kernel"] / ctx["units"]
    return pairs / s / 1e9 if pairs and s > 0 else None
