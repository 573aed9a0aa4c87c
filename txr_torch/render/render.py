"""Top-level render entry: rays → trace → supersample average → image
(txr/render/render.py), with the edge-adaptive AA pass and the per-bounce
debug channels."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from txr_torch import resolve_device
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render import trace as tr
from txr_torch.render.intersect import nearest_hit
from txr_torch.render.raygen import primary_rays, ray_dirs
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import RenderConfig, trace
from txr_torch.utils.debug import program

# Screen tiles of 8 rows × 64 columns: rays of one tile sit together, so the
# lanes a step still works on cluster into compact screen rectangles.
TILE_H, TILE_W = 8, 64

# Rec. 709 luma weights of the edge detect (SMAALumaEdgeDetectionPS)
LUMA = (0.2126, 0.7152, 0.0722)


def _tile_order(x, hs, ws):
    t = x.reshape(hs // TILE_H, TILE_H, ws // TILE_W, TILE_W, x.shape[-1])
    return t.permute(0, 2, 1, 3, 4).reshape(hs * ws, x.shape[-1])


def _untile_order(x, hs, ws):
    t = x.reshape(hs // TILE_H, ws // TILE_W, TILE_H, TILE_W, x.shape[-1])
    return t.permute(0, 2, 1, 3, 4).reshape(hs * ws, x.shape[-1])


def _chunked_trace(scene, textures, cfg: RenderConfig, ro, rd, device):
    """trace() over ``cfg.ray_chunk`` rays at a time, so the device holds
    one chunk's per-ray intermediates at once.  Rays are independent, so
    the colours equal one trace of the whole batch."""
    if cfg.ray_chunk and ro.shape[0] > cfg.ray_chunk:
        return torch.cat([trace(scene, textures, cfg, o, d, device=device)
                          for o, d in zip(torch.split(ro, cfg.ray_chunk),
                                          torch.split(rd, cfg.ray_chunk))])
    return trace(scene, textures, cfg, ro, rd, device=device)


@program
def render(scene, textures, cfg: RenderConfig, device=None):
    """→ image [H, W, 3] float32 on ``device``, row 0 = top.  Runs on CUDA
    unless the caller passes ``device="cpu"``."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    # mip pyramids and atlas built once per frame, shared by the edge pass
    textures = with_mips(textures.to(dev))
    if cfg.aa_mode == "edge" and cfg.supersample > 1:
        base = render(scene, textures, dataclasses.replace(cfg, supersample=1), device=dev)
        return _edge_aa(scene, textures, cfg, base, dev)
    ss = cfg.supersample
    ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, ss)
    hs, ws = cfg.height * ss, cfg.width * ss
    tiled = hs % TILE_H == 0 and ws % TILE_W == 0
    if tiled:
        ro = _tile_order(ro, hs, ws)
        rd = _tile_order(rd, hs, ws)
    color = _chunked_trace(scene, textures, cfg, ro, rd, dev)
    if tiled:
        color = _untile_order(color, hs, ws)
    if ss > 1:
        return color.reshape(cfg.height, ss, cfg.width, ss, 3).mean(dim=(1, 3))
    return color.reshape(cfg.height, cfg.width, 3)


def edge_pixels(base, cfg: RenderConfig):
    """The pixels edge AA re-renders: flat row-major indices [n] of the
    first ``min(H·W, edge_budget_mult·(H+W))`` pixels whose luma differs
    from a four-neighbour's by more than ``edge_threshold`` (both sides of
    a discontinuity), as ``jnp.nonzero(size=K)`` picks them in
    txr/render/render.py:_edge_aa.  The base frame is detached: the choice
    is piecewise constant in the scene."""
    H, W = cfg.height, cfg.width
    b = base.detach()
    lum = b[..., 0] * LUMA[0] + b[..., 1] * LUMA[1] + b[..., 2] * LUMA[2]
    dv = (lum[1:] - lum[:-1]).abs()
    dh = (lum[:, 1:] - lum[:, :-1]).abs()
    delta = torch.maximum(torch.maximum(F.pad(dv, (0, 0, 1, 0)), F.pad(dv, (0, 0, 0, 1))),
                          torch.maximum(F.pad(dh, (1, 0)), F.pad(dh, (0, 1))))
    K = min(H * W, cfg.edge_budget_mult * (H + W))
    return torch.nonzero((delta > cfg.edge_threshold).reshape(-1)).squeeze(-1)[:K]


def _edge_aa(scene, textures, cfg: RenderConfig, base, device):
    """Edge-adaptive AA (txr/render/render.py:89-146): re-render only the
    luma-edge pixels at k² spp and write them over the 1-spp frame.

    Each chosen pixel traces its k×k sub-grid, computed as ``pixel_grid(ss=k)``
    computes it, so a re-rendered pixel equals its uniform-SSAA value.  Only
    the real edge count is traced.  The write does not accumulate, so the
    base frame's gradient at those pixels is zero."""
    k, H, W = cfg.supersample, cfg.height, cfg.width
    pix = edge_pixels(base, cfg)
    n = pix.numel()
    if n == 0:
        return base
    r, c = pix // W, pix % W
    jj = torch.arange(k * k, device=device)
    x = ((c[:, None] * k + jj % k).to(torch.float32) + 0.5) / k
    y = H - ((r[:, None] * k + jj // k).to(torch.float32) + 0.5) / k
    rd = ray_dirs(scene.camera.quat, x, y, W, H).reshape(-1, 3).contiguous()
    ro = scene.camera.pos.expand(rd.shape).contiguous()
    aa = _chunked_trace(scene, textures, cfg, ro, rd, device).reshape(n, k * k, 3).mean(dim=1)
    return base.reshape(-1, 3).index_put((pix,), aa).reshape(H, W, 3)


# t holds +inf on misses by design
@program(checked=lambda out: (out["normal"], out["mask"]))
def render_debug(scene, textures, cfg: RenderConfig, bounce: int = 0, device=None):
    """Per-bounce debug channels (txr/render/render.py:149-195; the
    reference's DBG flag, rt.frag:151-153).  ``bounce`` 0 reports the
    primary hit; k > 0 runs k steps of the real bounce loop (``cfg.fused``'s
    step body, without early exit) and reports the rays entering step k.

    → dict of [H, W, ...] tensors on ``device``: ``t`` (+inf on a miss or a
    dead ray), ``type`` and ``index`` (int32, −1 there), ``normal`` (zeros
    there), ``mask`` (the throughput entering step k) and ``alive``."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = with_mips(textures.to(dev))
    tr._check_route(cfg)
    table = pack_scene(scene, textures.atlas)
    ro0, rd0 = primary_rays(scene.camera, cfg.width, cfg.height, 1)
    st = tr.initial_state(ro0, rd0)
    for _ in range(bounce):
        if cfg.fused == "off":
            st = tr.step_jnp(scene, textures, cfg, st, table=table)
        else:
            st = tr._fused_step(scene, textures, cfg, st, table)
    ro, rd = st["ro"], st["rd"]
    t, ty, idx = nearest_hit(scene, ro, rd, cfg.plane_oneside, table)
    hi = tr.hit_info(scene, textures, ro, rd, t, ty, idx)
    hit = torch.isfinite(t) & st["alive"]
    sh = (cfg.height, cfg.width)
    return dict(
        t=torch.where(hit, t, torch.inf).reshape(sh),
        type=torch.where(hit, ty, -1).to(torch.int32).reshape(sh),
        index=torch.where(hit, idx, -1).to(torch.int32).reshape(sh),
        normal=torch.where(hit[..., None], hi["normal"], 0.0).reshape(sh + (3,)),
        mask=st["mask"].reshape(sh + (3,)),
        alive=st["alive"].reshape(sh),
    )
