"""The shadow any-hit sweep: its CUDA kernel and its plain twin.

Replaces ``txr/kernels/pallas_intersect.py:shadow_sweep_pallas``.  For each
shadow ray, any occluder of the packed scene table closer than ``dist``:
solid [N] f32 0/1 over spheres (tested solid), two-sided planes, boxes,
surfaces and toruses; and for each ring its hit bit and hit (u, v), as
ring_hit [N, nr] bool and ring_uv [N, nr, 2] (zeros off a hit), so the
caller can weigh a textured ring by its texture alpha.  ``need`` (bool or
uint8 [N], None for every ray) marks the rays whose answer the caller
reads; the others get the answer of a ray that hits nothing, and the kernel
does not trace them.

``shadow_sweep`` launches the kernel on CUDA tensors (``launch``) and runs
the twin ``shadow_sweep_ref`` on CPU tensors.  Occlusion is piecewise
constant, so both are detached.
"""

from __future__ import annotations

import ctypes

import torch

from txr_torch.kernels import build
from txr_torch.kernels.scene_table import (
    FLAG_ONE_SIDE,
    check_mask,
    check_rays,
    check_table,
    counts_of,
    occlusion_ref,
    sections,
)


def _split(solid, ring):
    """Kernel rows → (solid [N], ring_hit [N, nr] bool, ring_uv [N, nr, 2]);
    ring_* are None without rings."""
    if not ring.shape[0]:
        return solid, None, None
    return solid, ring[0::3].T > 0.5, torch.stack([ring[1::3].T, ring[2::3].T], dim=-1)


def shadow_sweep_ref(buf, hdr, ro, rd, dist, need=None):
    """Plain PyTorch twin of the kernel; see ``shadow_sweep``.  Every ray is
    traced; the fills of the rays not needed are applied with
    ``torch.where``."""
    cnt, sec = sections(buf, hdr)
    solid, rings = occlusion_ref(cnt, sec, ro.unbind(-1), rd.unbind(-1), dist,
                                 bool(hdr[9] & FLAG_ONE_SIDE))
    ring = torch.stack(rings) if rings else solid.new_zeros((0, solid.shape[0]))
    if need is not None:
        need = need.to(torch.bool)
        solid, ring = torch.where(need, solid, 0.0), torch.where(need, ring, 0.0)
    return _split(solid, ring)


def shadow_sweep(buf, hdr, ro, rd, dist, need=None):
    """(solid, ring_hit, ring_uv) on the rays' device: the kernel for CUDA
    tensors, the twin for CPU tensors."""
    if ro.device.type == "cpu":
        check_rays("shadow_sweep", ro.device, ro, rd, dist)
        check_mask("shadow_sweep", ro.device, need, ro.shape[0])
        return shadow_sweep_ref(buf, hdr, ro, rd, dist, need)
    return launch(buf, hdr, ro, rd, dist, need)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def launch(buf, hdr, ro, rd, dist, need=None):
    """Launch the kernel on a packed table and CUDA rays ro, rd [N, 3],
    dist [N] → (solid, ring_hit, ring_uv), on the current stream; ``need``
    as in ``shadow_sweep``.  Counts its launches in ``launch.launches``."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"shadow_sweep: no kernel for device {dev}")
    check_rays("shadow_sweep", dev, ro, rd, dist)
    check_table("shadow_sweep", buf, hdr, dev)
    N = ro.shape[0]
    mask = check_mask("shadow_sweep", dev, need, N)
    solid = torch.empty((N,), dtype=torch.float32, device=dev)
    ring = torch.empty((3 * counts_of(hdr)["rings"], N), dtype=torch.float32, device=dev)
    if N:
        build.run("shadow_sweep", "txr_shadow_sweep", _ARGS, dev, hdr, buf.data_ptr(),
                  ro.data_ptr(), rd.data_ptr(), dist.data_ptr(),
                  None if mask is None else mask.data_ptr(), solid.data_ptr(),
                  ring.data_ptr(), N)
        launch.launches += 1
    return _split(solid, ring)


launch.launches = 0
