"""Primary ray generation (txr/render/raygen.py, rt.frag:313-317).

dir = normalize(rotate(cam_quat, ((x,y) − (w,h)/2)/h, 1)) with gl_FragCoord
sample positions; images are returned row 0 = top, so row r maps to
gl y = (H−1−r)+0.5.
"""

from __future__ import annotations

import torch

from txr_torch.geometry import quaternion as quat


def pixel_grid(width, height, ss=1, device=None):
    """Sub-pixel sample coordinates (x, y), each [H*ss, W*ss]."""
    xs = (torch.arange(width * ss, dtype=torch.float32, device=device) + 0.5) / ss
    ys = height - (torch.arange(height * ss, dtype=torch.float32, device=device) + 0.5) / ss
    x = xs[None, :].expand(height * ss, width * ss)
    y = ys[:, None].expand(height * ss, width * ss)
    return x, y


def ray_dirs(camera_quat, x, y, width, height):
    """Camera-space dir ((x,y)−(w,h)/2)/h with z=1, rotated and normalised."""
    h = float(height)
    dx = (x - width / 2.0) / h
    dy = (y - height / 2.0) / h
    d = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    d = quat.rotate(camera_quat, d)
    return d / torch.sqrt((d * d).sum(-1, keepdim=True))


def primary_rays(camera, width, height, ss=1):
    """→ (ro [N,3], rd [N,3]) over the sample grid, on the camera's device."""
    x, y = pixel_grid(width, height, ss, device=camera.pos.device)
    rd = ray_dirs(camera.quat, x, y, width, height).reshape(-1, 3)
    ro = camera.pos.expand(rd.shape).contiguous()
    return ro, rd.contiguous()
