"""Top-level render entry: rays → trace → supersample average → image
(txr/render/render.py), with the edge-adaptive AA pass, the per-bounce
debug channels, and ``render_jit``: the same frame captured in CUDA graphs
once per key and replayed (``render/graphs.py``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from txr_torch import resolve_device
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render import trace as tr
from txr_torch.render.graphs import Recorder, TraceProgram
from txr_torch.render.intersect import lane_lists, nearest_hit
from txr_torch.render.raygen import primary_rays, ray_dirs
from txr_torch.render.texture import with_mips
from txr_torch.render.texture import TextureSet
from txr_torch.render.trace import RenderConfig, trace
from txr_torch.scene.types import flatten_with_paths, unflatten_like
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
    return image(color, cfg)


def image(color, cfg: RenderConfig):
    """Sample colours [H·ss·W·ss, 3] in row-major sample order → the image
    [H, W, 3], each pixel the mean of its ss×ss samples."""
    ss = cfg.supersample
    if ss > 1:
        return color.reshape(cfg.height, ss, cfg.width, ss, 3).mean(dim=(1, 3))
    return color.reshape(cfg.height, cfg.width, 3)


def _edge_mask(base, cfg: RenderConfig):
    """[H·W] bool, row-major: the pixels whose luma differs from a
    four-neighbour's by more than ``edge_threshold`` (both sides of a
    discontinuity).  The base frame is detached: the choice is piecewise
    constant in the scene."""
    b = base.detach()
    lum = b[..., 0] * LUMA[0] + b[..., 1] * LUMA[1] + b[..., 2] * LUMA[2]
    dv = (lum[1:] - lum[:-1]).abs()
    dh = (lum[:, 1:] - lum[:, :-1]).abs()
    delta = torch.maximum(torch.maximum(F.pad(dv, (0, 0, 1, 0)), F.pad(dv, (0, 0, 0, 1))),
                          torch.maximum(F.pad(dh, (1, 0)), F.pad(dh, (0, 1))))
    return (delta > cfg.edge_threshold).reshape(-1)


def _edge_budget(cfg: RenderConfig):
    return min(cfg.height * cfg.width, cfg.edge_budget_mult * (cfg.height + cfg.width))


def edge_pixels(base, cfg: RenderConfig):
    """The pixels edge AA re-renders: flat row-major indices [n] of the
    first ``min(H·W, edge_budget_mult·(H+W))`` edge pixels (``_edge_mask``),
    as ``jnp.nonzero(size=K)`` picks them in txr/render/render.py:_edge_aa."""
    return torch.nonzero(_edge_mask(base, cfg)).squeeze(-1)[:_edge_budget(cfg)]


def _edge_pixels_fixed(base, cfg: RenderConfig):
    """``edge_pixels`` padded to the budget K with the fill H·W → [K], as
    ``jnp.nonzero(size=K, fill_value=H·W)``: a running count places each
    edge pixel, and the ones past K and every other pixel go to a dropped
    last slot.  Fixed shapes, no host read."""
    mask = _edge_mask(base, cfg)
    n, K = mask.shape[0], _edge_budget(cfg)
    pos = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (pos < K), pos, K)
    out = torch.full((K + 1,), n, dtype=torch.int64, device=mask.device)
    return out.index_put_((slot,), torch.arange(n, device=mask.device))[:K]


def _subpixel_rays(camera, pix, cfg: RenderConfig):
    """The k×k sub-samples of pixels ``pix`` [n], computed as
    ``pixel_grid(ss=k)`` computes them, so a re-rendered pixel equals its
    uniform-SSAA value → (ro, rd) [n·k², 3]."""
    k, H, W = cfg.supersample, cfg.height, cfg.width
    r, c = pix // W, pix % W
    jj = torch.arange(k * k, device=pix.device)
    x = ((c[:, None] * k + jj % k).to(torch.float32) + 0.5) / k
    y = H - ((r[:, None] * k + jj // k).to(torch.float32) + 0.5) / k
    rd = ray_dirs(camera.quat, x, y, W, H).reshape(-1, 3).contiguous()
    return camera.pos.expand(rd.shape).contiguous(), rd


def _pixel_mean(color, kk):
    """The mean of each pixel's kk consecutive sub-sample colours
    [n·kk, 3] → [n, 3], summed in sub-sample order one add at a time, so a
    pixel's value does not depend on how many pixels are averaged."""
    c = color.reshape(-1, kk, 3)
    acc = c[:, 0]
    for j in range(1, kk):
        acc = acc + c[:, j]
    return acc / kk


def _write_pixels(base, pix, aa):
    """``base`` [H, W, 3] with pixels ``pix`` [n] (flat, row-major) set to
    ``aa`` [n, 3]; indices H·W (``_edge_pixels_fixed``'s fills) are
    dropped."""
    H, W = base.shape[:2]
    flat = torch.cat([base.reshape(-1, 3), base.new_zeros((1, 3))])
    return flat.index_put_((pix,), aa)[:H * W].reshape(H, W, 3)


def _edge_aa(scene, textures, cfg: RenderConfig, base, device):
    """Edge-adaptive AA (txr/render/render.py:89-146): re-render only the
    luma-edge pixels at k² spp and write them over the 1-spp frame.

    With lane lists (``intersect.lane_lists``: on the card) only the real
    edge count is traced; otherwise the whole budget of K pixels, fills
    included, as ``render_jit`` traces it.  The write does not accumulate,
    so the base frame's gradient at those pixels is zero."""
    H, W = cfg.height, cfg.width
    pix = edge_pixels(base, cfg) if lane_lists(base.device) else _edge_pixels_fixed(base, cfg)
    if pix.numel() == 0:
        return base
    ro, rd = _subpixel_rays(scene.camera, torch.clamp(pix, max=H * W - 1), cfg)
    aa = _pixel_mean(_chunked_trace(scene, textures, cfg, ro, rd, device), cfg.supersample ** 2)
    return _write_pixels(base, pix, aa)


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


# ---------------------------------------------------------------------------
# render_jit: the frame captured in CUDA graphs (txr/render/render.py:197-204)
# ---------------------------------------------------------------------------

_FRAMES = {}        # key → _JitFrame


def _texture_tensors(textures):
    """The tensors of a TextureSet (after ``with_mips``) that a frame reads."""
    a = textures.atlas
    out = [] if a is None else [a.texels, a.offset, a.h0, a.w0, a.levels]
    return out + [t for t in (textures.cube, textures.ring_alpha) if t is not None]


def _copied(textures):
    a = textures.atlas
    return TextureSet(
        atlas=None if a is None else dataclasses.replace(
            a, texels=a.texels.clone(), offset=a.offset.clone(), h0=a.h0.clone(),
            w0=a.w0.clone(), levels=a.levels.clone()),
        cube=None if textures.cube is None else textures.cube.clone(),
        ring_alpha=None if textures.ring_alpha is None else textures.ring_alpha.clone())


def _texture_layout(textures):
    a = textures.atlas
    shape = lambda t: None if t is None else (tuple(t.shape), t.dtype)
    atlas = None if a is None else (a.dims, a.n_sphere, a.box_slot, a.ring_slot,
                                    shape(a.texels), shape(a.offset))
    return atlas, shape(textures.cube), shape(textures.ring_alpha)


class _JitFrame:
    """One key of ``render_jit``: static scene leaves, the static textures
    and the programs (``graphs.TraceProgram``) that read them, captured at
    the first call.  ``owned``: the textures are this frame's own storage,
    into which a call with other texture storage is copied; otherwise they
    are the caller's, read in place."""

    def __init__(self, scene, textures, build, device, owned):
        self.rec = Recorder(device)
        self.owned = owned
        self.leaves = {p: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for p, v in flatten_with_paths(scene).items()}
        self.scene = unflatten_like(scene, self.leaves)
        # only what the body reads: the raw textures are not kept
        self.textures = TextureSet(atlas=textures.atlas, cube=textures.cube,
                                   ring_alpha=textures.ring_alpha)
        self.tex = _texture_tensors(self.textures)
        self.table = None
        self.programs = build(self)
        self.captured = False

    def reads(self, textures):
        """Whether the textures are this frame's texture storage."""
        return all(a.data_ptr() == b.data_ptr()
                   for a, b in zip(self.tex, _texture_tensors(textures)))

    def _load(self, scene, textures):
        dev = self.rec.device
        groups = {}
        for p, v in flatten_with_paths(scene).items():
            dst = self.leaves[p]
            pair = groups.setdefault(dst.dtype, ([], []))
            pair[0].append(dst)
            pair[1].append(v.to(dev))
        for dsts, srcs in groups.values():
            torch._foreach_copy_(dsts, srcs)
        for dst, src in zip(self.tex, _texture_tensors(textures)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)

    def __call__(self, scene, textures):
        self._load(scene, textures)
        if not self.captured:
            with _disable_current_modes():
                self.rec.warm_up(lambda: [p.run(warm_up=True) for p in self.programs])
                for p in self.programs:
                    p.capture()
            self.captured = True
        for p in self.programs:
            p.run()
        return self.programs[-1].out.clone()


def jit_frame(scene, textures, cfg: RenderConfig, device, key, build):
    """The frame of ``key`` (captured at its first call by ``build(frame)``
    → its programs) run on ``scene`` and ``textures`` → a copy of the last
    program's ``out``.  Refuses a call that wants a gradient."""
    dev = resolve_device(device)
    tr._check_route(cfg)
    given = textures.to(dev)
    textures = with_mips(given)
    leaves = flatten_with_paths(scene)
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (*leaves.values(), *_texture_tensors(textures))):
        raise ValueError("render_jit replays a frame without a gradient: a scene or texture "
                         "leaf requires grad; render() is the differentiable route")
    key = (key, cfg, dev, tuple((p, tuple(v.shape), v.dtype) for p, v in leaves.items()),
           _texture_layout(textures))
    frame = _FRAMES.get(key)
    if frame is not None and not frame.owned and not frame.reads(textures):
        # the captured storage is the caller's: capture again on storage of
        # the frame's own, never writing into the caller's textures
        del _FRAMES[key]
        frame = _JitFrame(scene, _copied(textures), build, dev, owned=True)
    elif frame is None:
        # textures built by with_mips in this call are nobody else's
        frame = _JitFrame(scene, textures, build, dev, owned=textures is not given)
    _FRAMES[key] = frame
    return frame(scene, textures)


def clear_jit_cache():
    """Drop every captured frame, and the device memory its graphs hold."""
    _FRAMES.clear()


def _frame_program(frame, cfg: RenderConfig):
    """``render``'s frame without edge AA as one TraceProgram: the head
    packs the scene table and makes the primary rays in screen-tile order,
    the tail puts the colours back in raster order and averages the
    supersamples."""
    ss = cfg.supersample
    hs, ws = cfg.height * ss, cfg.width * ss
    tiled = hs % TILE_H == 0 and ws % TILE_W == 0

    def rays(p):
        frame.table = pack_scene(frame.scene, frame.textures.atlas)
        ro, rd = primary_rays(frame.scene.camera, cfg.width, cfg.height, ss)
        p.ro, p.rd = (_tile_order(ro, hs, ws), _tile_order(rd, hs, ws)) if tiled else (ro, rd)

    def finish(p):
        p.out = image(_untile_order(p.color, hs, ws) if tiled else p.color, cfg)

    return TraceProgram(frame, cfg, hs * ws, rays, finish, frame.rec)


def _edge_program(frame, cfg: RenderConfig, base):
    """The edge-AA pass over ``base``'s image as one TraceProgram: the head
    picks the budget's K pixels (``_edge_pixels_fixed``) and makes their
    K·k² sub-sample rays, fills included; the tail averages each pixel's
    samples and writes the real pixels over the base image, dropping the
    fills."""
    H, W, k = cfg.height, cfg.width, cfg.supersample

    def rays(p):
        p.pix = _edge_pixels_fixed(base.out, cfg)
        p.ro, p.rd = _subpixel_rays(frame.scene.camera, torch.clamp(p.pix, max=H * W - 1), cfg)

    def finish(p):
        p.out = _write_pixels(base.out, p.pix, _pixel_mean(p.color, k * k))

    return TraceProgram(frame, cfg, _edge_budget(cfg) * k * k, rays, finish, frame.rec)


@program
def render_jit(scene, textures, cfg: RenderConfig, device=None):
    """``render`` as CUDA graphs: the frame is captured once per key and
    replayed, as ``jax.jit`` compiles the JAX package's ``render_jit``
    (topology and flags bake in, parameters stream in per call).  The key
    is ``cfg``, the scene topology (every leaf's shape and type) and the
    atlas layout; at each call the scene's leaves are copied into the
    graphs' static buffers, and the textures are read in place when they
    are the captured storage, else copied into it.  → [H, W, 3] on
    ``device`` (CUDA unless the caller passes "cpu"), equal to ``render``'s
    image bit for bit.

    The body has fixed shapes and reads nothing on the host: the texel,
    ring-alpha and glossy passes run on every lane of a step with masks
    (``intersect.fixed_shapes``), the count of live lanes is read one step
    late (``graphs.TraceUnit``): it ends the loop, and picks the capacity
    (a power of two) of the buffer the live lanes of a step are gathered
    into; edge AA traces its whole budget of K pixels, fills included.  The
    first call of a key runs every piece once eagerly on a side stream,
    then captures them; ``ray_chunk`` gives one set of graphs per chunk
    size.  On the CPU the same pieces run eagerly, every lane each step.
    No gradient: a call with grad mode on and a leaf that requires grad
    raises, and a failed capture raises; neither falls back to
    ``render``."""
    if cfg.aa_mode == "edge" and cfg.supersample > 1:
        def build(frame):
            base = _frame_program(frame, dataclasses.replace(cfg, supersample=1))
            return [base, _edge_program(frame, cfg, base)]
    else:
        def build(frame):
            return [_frame_program(frame, cfg)]
    return jit_frame(scene, textures, cfg, device, "render", build)
