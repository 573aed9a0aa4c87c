"""reflect and refract (txr/render/shading.py:16-29)."""

from __future__ import annotations

import torch


def reflect(i, n):
    """GLSL reflect: i − 2·dot(n,i)·n."""
    return i - 2.0 * (n * i).sum(-1, keepdim=True) * n


def refract(i, n, eta):
    """GLSL refract; the zero vector on total internal reflection."""
    cosi = (n * i).sum(-1, keepdim=True)
    e = eta[..., None]
    k = 1.0 - e ** 2 * (1.0 - cosi * cosi)
    ok = k >= 0.0
    k_sqrt = torch.sqrt(torch.where(ok, k, 1.0))
    out = e * i - (e * cosi + torch.where(ok, k_sqrt, 0.0)) * n
    return torch.where(ok, out, 0.0)
