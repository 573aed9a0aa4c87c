"""The configuration's textures, made from the run's seed on the device.

Each texture is RGBA float32 [H, W, 4] in [0, 1] (the cubemap [6, S, S,
4]), of the kind and size the configuration names: banded planets, a ring
of radial bands with alpha gaps, a crate of planks, a starfield.  These are
the procedural demo's kinds (txr_torch/apps/demo.py) with their phases,
noise and stars drawn from ``torch.Generator(device).manual_seed(seed)``
in a few calls each, so the same seed gives the same texels.  The harness
hands these tensors to the program and to the reference alike.
"""

from __future__ import annotations

import math

import torch


def _banded(g, dev, spec):
    h, w = spec["size"]
    y = torch.linspace(0.0, 1.0, h, device=dev)[:, None]
    phase = torch.rand(2, generator=g, device=dev) * (2 * math.pi)
    b = float(spec["bands"])
    mix = 0.5 + 0.5 * torch.sin(b * 2 * math.pi * y + phase[0])
    mix = mix + 0.15 * torch.sin(3.1 * b * 2 * math.pi * y + phase[1])
    mix = mix.clamp(0.0, 1.0)[..., None]
    base = torch.tensor(spec["base"], device=dev)
    alt = torch.tensor(spec["alt"], device=dev)
    rgb = (base * (1 - mix) + alt * mix).expand(h, w, 3)
    rgb = rgb + 0.01 * torch.randn((h, w, 3), generator=g, device=dev)
    return torch.cat([rgb, torch.ones((h, w, 1), device=dev)], -1).clamp(0.0, 1.0)


def _ring(g, dev, spec):
    h, w = spec["size"]
    u = torch.linspace(0.0, 1.0, w, device=dev)[None, :]
    phase = torch.rand(1, generator=g, device=dev) * (2 * math.pi)
    color = 0.55 + 0.25 * torch.sin(40 * math.pi * u + phase)
    color = color + 0.02 * torch.randn((1, w), generator=g, device=dev)
    alpha = (0.8 + 0.4 * torch.sin(23 * math.pi * u + 1.3 + phase)).clamp(0.0, 1.0) * (u > 0.02)
    rgb = (color[..., None] * torch.tensor([1.0, 0.9, 0.75], device=dev)).expand(h, w, 3)
    return torch.cat([rgb, alpha[..., None].expand(h, w, 1)], -1).clamp(0.0, 1.0)


def _crate(g, dev, spec):
    h, w = spec["size"]
    yy, xx = torch.meshgrid(torch.linspace(0.0, 1.0, h, device=dev),
                            torch.linspace(0.0, 1.0, w, device=dev), indexing="ij")
    border = (torch.minimum(torch.minimum(xx, 1 - xx), torch.minimum(yy, 1 - yy)) < 0.08)
    border = border.to(torch.float32)[..., None]
    planks = 0.5 + 0.2 * torch.sin(6 * math.pi * yy)
    rgb = torch.stack([0.55 + 0.2 * planks, 0.35 + 0.15 * planks, 0.15 + 0.05 * planks], -1)
    rgb = rgb + 0.02 * torch.randn((h, w, 3), generator=g, device=dev)
    rgb = rgb * (1 - border) + border * torch.tensor([0.35, 0.22, 0.1], device=dev)
    return torch.cat([rgb, torch.ones((h, w, 1), device=dev)], -1).clamp(0.0, 1.0)


def _starfield(g, dev, spec):
    h, w = spec["size"]
    rgb = torch.rand((6, h, w, 3), generator=g, device=dev) * 0.015
    n = int(6 * h * w * spec["density"])
    at = torch.randint(0, 6 * h * w, (n,), generator=g, device=dev)
    star = torch.rand((n, 4), generator=g, device=dev)
    mag = 0.3 + 0.7 * star[:, :1]
    tint = 0.7 + 0.3 * star[:, 1:]
    rgb = rgb.reshape(-1, 3).index_put((at,), mag * tint).reshape(6, h, w, 3)
    return torch.cat([rgb, torch.ones((6, h, w, 1), device=dev)], -1)


MAKERS = dict(banded=_banded, ring=_ring, crate=_crate, starfield=_starfield)


def make(cfg, seed, dev):
    """{texture name: float32 RGBA tensor on ``dev``} of the configuration,
    drawn from ``seed``; names in the configuration's order, each from a
    generator of its own so a texture does not depend on the others (none
    without a ``textures`` section)."""
    out = {}
    for k, (name, spec) in enumerate(cfg.get("textures", {}).get("kinds", {}).items()):
        g = torch.Generator(device=dev)
        g.manual_seed((int(seed) * 1_000_003 + k) % (1 << 63))
        out[name] = MAKERS[spec["kind"]](g, dev, spec).contiguous()
    return out
