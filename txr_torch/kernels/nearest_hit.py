"""The nearest-hit sweep: its CUDA kernel and its plain twin.

Replaces ``txr/kernels/pallas_intersect.py:nearest_hit_pallas``.  For each
ray, calcInter over every primitive of the packed scene table
(``scene_table.pack_scene``) in reference order with strict ``<``:
(tmin [N] f32, ≥ BIG on a miss; slot [N] int32, 0 on a miss).  ``alive``
(bool or uint8 [N], None for every ray) marks the rays whose answer the
caller reads; the others get the answer of a miss, and the kernel does not
trace them.

``nearest_hit_sweep`` launches the kernel on CUDA tensors (``launch``) and
runs the twin ``nearest_hit_ref`` on CPU tensors.  Both are detached
sweeps: ``render/intersect.py:nearest_hit`` differentiates the winner.
The kernel's library is built once per scene topology (``build.topology``)
at the first launch on a table of that topology.
"""

from __future__ import annotations

import ctypes

import torch

from txr_torch.kernels import build
from txr_torch.kernels.primitives import INF_T
from txr_torch.kernels.scene_table import (
    FLAG_ONE_SIDE,
    check_mask,
    check_rays,
    check_table,
    sections,
    sweep_ref,
)


def nearest_hit_ref(buf, hdr, ro, rd, alive=None):
    """Plain PyTorch twin of the kernel: → (tmin [N] f32, slot [N] int32).
    Every ray is traced; the fills of the rays not alive are applied with
    ``torch.where``."""
    cnt, sec = sections(buf, hdr)
    tmin, slot = sweep_ref(cnt, sec, ro.unbind(-1), rd.unbind(-1), bool(hdr[9] & FLAG_ONE_SIDE))
    if alive is not None:
        alive = alive.to(torch.bool)
        tmin, slot = torch.where(alive, tmin, INF_T), torch.where(alive, slot, 0)
    return tmin, slot.to(torch.int32)


def nearest_hit_sweep(buf, hdr, ro, rd, alive=None):
    """(tmin, slot) on the rays' device: the kernel for CUDA tensors, the
    twin for CPU tensors."""
    if ro.device.type == "cpu":
        check_rays("nearest_hit", ro.device, ro, rd)
        check_mask("nearest_hit", ro.device, alive, ro.shape[0])
        return nearest_hit_ref(buf, hdr, ro, rd, alive)
    return launch(buf, hdr, ro, rd, alive)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def launch(buf, hdr, ro, rd, alive=None):
    """Launch the kernel of this table's topology on CUDA rays [N, 3] →
    (tmin [N] f32, slot [N] int32), on the current stream; ``alive`` as in
    ``nearest_hit_sweep``.  No host synchronisation.  Counts its launches
    in ``launch.launches``."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"nearest_hit: no kernel for device {dev}")
    check_rays("nearest_hit", dev, ro, rd)
    check_table("nearest_hit", buf, hdr, dev)
    N = ro.shape[0]
    mask = check_mask("nearest_hit", dev, alive, N)
    t = torch.empty((N,), dtype=torch.float32, device=dev)
    slot = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return t, slot
    build.run("nearest_hit", "txr_nearest_hit", _ARGS, dev, hdr, buf.data_ptr(),
              ro.data_ptr(), rd.data_ptr(), None if mask is None else mask.data_ptr(),
              t.data_ptr(), slot.data_ptr(), N, defines=build.topology(hdr))
    launch.launches += 1
    return t, slot


launch.launches = 0
