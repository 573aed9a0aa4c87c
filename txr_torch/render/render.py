"""Top-level render entry: rays → trace → supersample average → image
(txr/render/render.py)."""

from __future__ import annotations

from txr_torch import resolve_device
from txr_torch.render.raygen import primary_rays
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, trace

# Screen tiles of 8 rows × 64 columns: rays of one tile sit together, so the
# lanes a step still works on cluster into compact screen rectangles.
TILE_H, TILE_W = 8, 64


def _tile_order(x, hs, ws):
    t = x.reshape(hs // TILE_H, TILE_H, ws // TILE_W, TILE_W, x.shape[-1])
    return t.permute(0, 2, 1, 3, 4).reshape(hs * ws, x.shape[-1])


def _untile_order(x, hs, ws):
    t = x.reshape(hs // TILE_H, ws // TILE_W, TILE_H, TILE_W, x.shape[-1])
    return t.permute(0, 2, 1, 3, 4).reshape(hs * ws, x.shape[-1])


def render(scene, textures, cfg: RenderConfig, device=None):
    """→ image [H, W, 3] float32 on ``device``, row 0 = top.  Runs on CUDA
    unless the caller passes ``device="cpu"``."""
    if cfg.aa_mode == "edge" and cfg.supersample > 1:
        raise NotImplementedError(
            "edge-adaptive AA is not ported yet; use aa_mode='ssaa'")
    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = with_mips(textures.to(dev))
    ss = cfg.supersample
    ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, ss)
    hs, ws = cfg.height * ss, cfg.width * ss
    tiled = hs % TILE_H == 0 and ws % TILE_W == 0
    if tiled:
        ro = _tile_order(ro, hs, ws)
        rd = _tile_order(rd, hs, ws)
    color = trace(scene, textures, cfg, ro, rd, device=dev)
    if tiled:
        color = _untile_order(color, hs, ws)
    if ss > 1:
        return color.reshape(cfg.height, ss, cfg.width, ss, 3).mean(dim=(1, 3))
    return color.reshape(cfg.height, cfg.width, 3)
