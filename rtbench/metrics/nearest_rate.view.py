"""nearest_rate.view: billions of (ray, slot) tests a second that the eager
route's nearest-hit sweeps make: Σ ``pairs`` a frame (the program's counter
of each bounce step: its live lanes entering times the scene's slots) over
the window's frames that the profiler ran through (the traced frames and
those before them: a traced eager run's profiler stops after the window has
closed, so no untraced frame follows them), over the device seconds a frame
of the kernel named nearest_hit_kernel in the traced frames.
``sweep_rate.view``'s arithmetic on the eager kernel: the pairs leave out
the glossy pass's sweeps, whose time the kernel's seconds hold, so it is a
lower bound on the kernel's test rate.  None where the program counts no
pairs or the traced frames launch no such kernel."""
from rtbench import spans

KERNELS = ("nearest_hit_kernel",)


def read(ctx):
    p, recs = ctx["profile"], spans.records()
    if ctx["kind"] != "view" or p is None or recs is None or not ctx["units"]:
        return None
    frames = [r for r in recs if r["unit"] == "txr.frame" and r["profiled"]]
    pairs = spans.total(frames, "pairs") / len(frames) if frames else 0
    s = p["kernel_s"]["nearest_hit_kernel"] / ctx["units"]
    return pairs / s / 1e9 if pairs and s > 0 else None
