"""The lane map of a compacted bounce step: its two CUDA kernels and their
plain twins.

Replaces no TPU kernel (``csrc/lane_map.cu`` says why it exists).  A
bounce step of ``render/graphs.py: TraceUnit`` at a capacity C below its R
rays runs on the live lanes gathered into C rows:

* ``compact(st, C)``: the state ``st`` ({``STATE_KEYS``: [R] or [R, 3]})
  → (``lane`` int64 [C]: the live lanes in ascending order, then R as a
  fill; ``sub``: the state's rows at those lanes, a fill's row R − 1's
  with ``alive`` off; ``live`` int64 []: 0);
* ``scatter(new, lane, rows, live)``: the step's new state ``new`` [C]
  written over ``rows`` (the state of R + 1 rows) at ``lane``, and the
  lanes alive in ``new`` at non-fill lanes added to ``live``.  A fill's row
  is not written (the twin writes it to the spare row R, which nothing
  reads).

The caller never has more than C live lanes: its count is read one step
late, and a dead lane never lives again.  Live lanes past C would be
dropped, in both.

``compact`` and ``scatter`` launch the kernels on CUDA tensors
(``launch_compact``, ``launch_scatter``, which count their calls in
``.launches``) and run the twins ``compact_ref`` and ``scatter_ref`` on CPU
tensors.  Every field moves as bits, so kernel and twin agree byte for
byte.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from txr_torch.kernels import build
from txr_torch.kernels.step_consume import STATE_KEYS, _check_state

def compact_ref(st, C):
    """Plain PyTorch twin of ``launch_compact``; see the module."""
    alive = st["alive"]
    R = alive.shape[0]
    pos = torch.cumsum(alive, 0) - 1
    lane = torch.full((C + 1,), R, dtype=torch.int64, device=alive.device)
    lane.index_put_((torch.where(alive & (pos < C), pos, C),), torch.arange(R, device=alive.device))
    lane = lane[:C]
    src = torch.clamp(lane, max=R - 1)
    sub = {k: st[k].index_select(0, src) for k in STATE_KEYS}
    sub["alive"] = sub["alive"] & (lane != R)
    return lane, sub, torch.zeros((), dtype=torch.int64, device=alive.device)


def scatter_ref(new, lane, rows, live):
    """Plain PyTorch twin of ``launch_scatter``; see the module."""
    R = rows["alive"].shape[0] - 1
    for k in STATE_KEYS:
        rows[k].index_put_((lane,), new[k])
    live.add_((new["alive"] & (lane != R)).sum())


def _check_compact(st, C):
    """Raise unless ``compact`` can take these arguments → (device, R)."""
    dev, R = _check_state("lane_compact", st)
    if not 1 <= R < 2 ** 31 or not 1 <= C:
        raise ValueError(f"lane_compact: needs 1 <= R < 2^31 lanes and C >= 1 rows, got R = {R}, "
                         f"C = {C}")
    return dev, R


def _check_scatter(new, lane, rows, live):
    """Raise unless ``scatter`` can take these arguments → (device, R, C)."""
    dev, C = _check_state("lane_scatter", new)
    rdev, R1 = _check_state("lane_scatter", rows)
    if rdev != dev or not 2 <= R1 <= 2 ** 31:
        raise ValueError(f"lane_scatter: rows must be the state of R + 1 rows (1 <= R < 2^31) on "
                         f"{dev}, got {R1} rows on {rdev}")
    if (lane.device != dev or lane.dtype != torch.int64 or tuple(lane.shape) != (C,)
            or not lane.is_contiguous()):
        raise ValueError(f"lane_scatter: lane must be a contiguous int64 [{C}] tensor on {dev}, "
                         f"got {tuple(lane.shape)} {lane.dtype} on {lane.device}")
    if live.device != dev or live.dtype != torch.int64 or live.numel() != 1:
        raise ValueError(f"lane_scatter: live must be one int64 on {dev}, got "
                         f"{tuple(live.shape)} {live.dtype} on {live.device}")
    return dev, R1 - 1, C


def compact(st, C):
    """(lane, sub, live) of the state ``st`` at capacity C; see the module."""
    dev, _ = _check_compact(st, C)
    if dev.type == "cpu":
        return compact_ref(st, C)
    return launch_compact(st, C)


def scatter(new, lane, rows, live):
    """Write ``new`` over ``rows`` at ``lane`` and count; see the module."""
    dev, _, _ = _check_scatter(new, lane, rows, live)
    if dev.type == "cpu":
        return scatter_ref(new, lane, rows, live)
    return launch_scatter(new, lane, rows, live)


def _on_card(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got them on {dev} (the plain "
                         "twin is lane_map's *_ref)")


@functools.cache
def tile():
    """The lanes of the compact kernel's tile (``csrc/lane_map.cu``'s
    ``kTile``), read from the library: its scratch holds one count a
    tile."""
    return build.load("lane_map", "txr_lane_tile", [])()


def _fields(st):
    """The state's field pointers in ``STATE_KEYS`` order, as a host array
    the launcher reads."""
    return (ctypes.c_void_p * len(STATE_KEYS))(*(st[k].data_ptr() for k in STATE_KEYS))


def launch_compact(st, C):
    """``compact`` on CUDA tensors, on the current stream: two launches,
    counted as one call in ``launch_compact.launches``."""
    dev, R = _check_compact(st, C)
    _on_card("lane_compact", dev)
    lane = torch.empty((C,), dtype=torch.int64, device=dev)
    sub = {k: torch.empty((C,) + tuple(st[k].shape[1:]), dtype=st[k].dtype, device=dev)
           for k in STATE_KEYS}
    live = torch.empty((), dtype=torch.int64, device=dev)
    counts = torch.empty((-(-R // tile()),), dtype=torch.int32, device=dev)
    src, dst = _fields(st), _fields(sub)
    build.run("lane_map", "txr_lane_compact", _COMPACT_ARGS, dev, None, ctypes.addressof(src),
              ctypes.addressof(dst), lane.data_ptr(), counts.data_ptr(), live.data_ptr(), R, C)
    launch_compact.launches += 1
    return lane, sub, live


def launch_scatter(new, lane, rows, live):
    """``scatter`` on CUDA tensors, on the current stream: one launch,
    counted in ``launch_scatter.launches``."""
    dev, R, C = _check_scatter(new, lane, rows, live)
    _on_card("lane_scatter", dev)
    src, dst = _fields(new), _fields(rows)
    build.run("lane_map", "txr_lane_scatter", _SCATTER_ARGS, dev, None, ctypes.addressof(src),
              lane.data_ptr(), ctypes.addressof(dst), live.data_ptr(), R, C)
    launch_scatter.launches += 1


launch_compact.launches = 0
launch_scatter.launches = 0

_P, _L = ctypes.c_void_p, ctypes.c_longlong
# src, dst, lane, counts, live, R, C, stream
_COMPACT_ARGS = [_P] * 5 + [_L, _L, _P]
# src, lane, rows, live, R, C, stream
_SCATTER_ARGS = [_P] * 4 + [_L, _L, _P]
