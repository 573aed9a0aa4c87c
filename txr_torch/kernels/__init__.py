"""The CUDA kernels (``step_probe``, ``glossy_rays`` and ``step_consume``,
``nearest_hit``, ``shadow_sweep``, ``lane_compact`` and ``lane_scatter``),
their plain twins (the consume's are ``render/fused.py``'s), their build
and the packed scene table they read."""

import functools


@functools.cache
def _counters():
    """{kernel: its wrapper}, built once (a graph replay adds to them)."""
    from txr_torch.kernels import lane_map, nearest_hit, shadow_sweep, step_consume, step_probe

    return dict(step_probe=step_probe.step_probe, glossy_rays=step_consume.launch_rays,
                step_consume=step_consume.launch, nearest_hit=nearest_hit.launch,
                shadow_sweep=shadow_sweep.launch, lane_compact=lane_map.launch_compact,
                lane_scatter=lane_map.launch_scatter)


def launch_counts():
    """{kernel: launches counted by its wrapper} in this process."""
    return {k: c.launches for k, c in _counters().items()}


def reset_launch_counts():
    for c in _counters().values():
        c.launches = 0


def add_launch_counts(counts):
    """Add {kernel: n} to the wrappers' counts (a replayed CUDA graph's
    launches, ``render/graphs.py``)."""
    for k, c in _counters().items():
        c.launches += counts.get(k, 0)
