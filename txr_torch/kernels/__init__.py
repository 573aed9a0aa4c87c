"""The three CUDA kernels (``step_probe``, ``nearest_hit``,
``shadow_sweep``), their plain twins, their build and the packed scene
table they read."""


def _counters():
    from txr_torch.kernels import nearest_hit, shadow_sweep, step_probe

    return dict(step_probe=step_probe.step_probe, nearest_hit=nearest_hit.launch,
                shadow_sweep=shadow_sweep.launch)


def launch_counts():
    """{kernel: launches counted by its wrapper} in this process."""
    return {k: c.launches for k, c in _counters().items()}


def reset_launch_counts():
    for c in _counters().values():
        c.launches = 0
