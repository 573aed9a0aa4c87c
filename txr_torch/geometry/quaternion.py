"""Quaternion math, (x, y, z, w) in the last axis (txr/geometry/quaternion.py).

``rotate(q, v)`` computes ``q * v * conj(q)`` (rt.frag:305-311).  Primitives
store world→object rotations: ``rotate(q, world)`` enters the object frame
and ``rotate(conj(q), local)`` leaves it.  All functions broadcast over
leading batch axes.
"""

from __future__ import annotations

import torch

from txr_torch import resolve_device


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def identity(dtype=torch.float32, device=None):
    """The identity rotation (x, y, z, w) = (0, 0, 0, 1), on the card unless
    ``device`` says otherwise."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=resolve_device(device))


def conj(q):
    """Quaternion conjugate (rt.frag:285-288), made on q's device without a
    host-to-device copy (a CUDA graph can capture it)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inv(q):
    """Quaternion inverse: conj(q) / |q|² (rt.frag:290-293)."""
    return conj(q) / (q * q).sum(-1, keepdim=True)


def mul(q1, q2):
    """Hamilton product, component layout per rt.frag:295-303."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def rotate(q, v):
    """(w² − |qv|²)v + 2(qv·v)qv + 2w(qv × v).  Non-unit quats scale by
    |q|², like the reference (it uses the conjugate, not the inverse)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    return (
        v * (qw * qw - (qv * qv).sum(-1, keepdim=True))
        + 2.0 * qv * (qv * v).sum(-1, keepdim=True)
        + 2.0 * qw * torch.linalg.cross(*torch.broadcast_tensors(qv, v))
    )


def from_axis_angle(axis, angle):
    """Quaternion from an (unnormalised) axis and an angle — glm::angleAxis."""
    axis = _f32(axis)
    axis = axis / torch.sqrt((axis * axis).sum(-1, keepdim=True))
    half = _f32(angle) / 2.0
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def from_euler(pitch_yaw_roll):
    """Quaternion from intrinsic XYZ euler angles — glm::quat(glm::vec3)."""
    p = _f32(pitch_yaw_roll) / 2.0
    cx, cy, cz = torch.cos(p).unbind(-1)
    sx, sy, sz = torch.sin(p).unbind(-1)
    return torch.stack(
        [
            sx * cy * cz - cx * sy * sz,
            cx * sy * cz + sx * cy * sz,
            cx * cy * sz - sx * sy * cz,
            cx * cy * cz + sx * sy * sz,
        ],
        dim=-1,
    )


def normalize(q):
    """q / |q| along the last axis."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
