"""Top-level render entry: rays → trace → supersample average → image
(txr/render/render.py), with the edge-adaptive AA pass, the per-bounce
debug channels, and ``render_jit``: the same frame captured in CUDA graphs
once per key and replayed (``render/graphs.py``)."""

from __future__ import annotations

import dataclasses
import gc

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes

from txr_torch import resolve_device
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render import trace as tr
from txr_torch.render.graphs import Recorder, TraceProgram, _Eager
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

    @torch.no_grad()
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

    def _capture(self, run, pieces=()):
        """The first call: ``run(warm_up=True)`` (every piece once,
        eagerly: on a side stream on the card), then every program's
        pieces and ``pieces`` captured → the latter as pieces.  In that
        order: a piece's graph reads the tensors an earlier capture set
        (a program's ``out``), not the warm-up's, which are freed."""
        with _disable_current_modes():
            self.rec.warm_up(lambda: run(warm_up=True))
            for p in self.programs:
                p.capture()
            pieces = [self.rec.capture(fn) for fn in pieces]
        self.captured = True
        return pieces

    def _run(self, warm_up=False):
        for p in self.programs:
            p.run(warm_up)

    def __call__(self, scene, textures):
        self._load(scene, textures)
        if not self.captured:
            self._capture(self._run)
        self._run()
        return self.programs[-1].out.clone()


def _cached_frame(scene, textures, cfg, device, key, make, check=None, take=False):
    """The frame of ``key`` (``make(scene, textures, device, owned)`` at
    its first call) → (frame, the textures after ``with_mips``);
    ``check(leaves, textures)`` first, when given.  ``take``: the frame
    leaves the cache, the caller's alone (a train frame; ``keep_train_frame``
    puts it back)."""
    dev = resolve_device(device)
    tr._check_route(cfg)
    given = textures.to(dev)
    textures = with_mips(given)
    leaves = flatten_with_paths(scene)
    if check is not None:
        check(leaves, textures)
    key = (key, cfg, dev, tuple((p, tuple(v.shape), v.dtype) for p, v in leaves.items()),
           _texture_layout(textures))
    frame = _FRAMES.pop(key, None)
    if frame is not None and not frame.owned and not frame.reads(textures):
        # the captured storage is the caller's: capture again on storage of
        # the frame's own, never writing into the caller's textures
        frame = make(scene, _copied(textures), dev, True)
    elif frame is None:
        # textures built by with_mips in this call are nobody else's
        frame = make(scene, textures, dev, textures is not given)
    frame.key = key
    if not take:
        _FRAMES[key] = frame
    return frame, textures


def jit_frame(scene, textures, cfg: RenderConfig, device, key, build):
    """The frame of ``key`` (captured at its first call by ``build(frame)``
    → its programs) run on ``scene`` and ``textures`` → a copy of the last
    program's ``out``.  Refuses a call that wants a gradient."""
    def check(leaves, textures):
        if torch.is_grad_enabled() and any(
                v.requires_grad for v in (*leaves.values(), *_texture_tensors(textures))):
            raise ValueError("render_jit replays a frame without a gradient: a scene or "
                             "texture leaf requires grad; render() is the differentiable route")

    frame, textures = _cached_frame(scene, textures, cfg, device, key,
                                    lambda s, t, d, o: _JitFrame(s, t, build, d, o), check)
    return frame(scene, textures)


def clear_jit_cache():
    """Drop every captured frame and the kept train frame, and the device
    memory their graphs hold (a fit or train state still running keeps its
    own)."""
    _FRAMES.clear()
    if torch.cuda.is_initialized():
        gc.collect()    # a frame's programs point back at it


def keep_train_frame(frame):
    """Keep a finished run's train frame for the next run of its key, in
    place of the train frame kept before: one at most, as a 1080p train
    frame's graphs hold some 10 GB."""
    for k in [k for k, f in _FRAMES.items() if isinstance(f, _TrainFrame)]:
        del _FRAMES[k]
    _FRAMES[frame.key] = frame


class _TrainFrame(_JitFrame):
    """One key of ``train_frame``: the captured train step's forward, loss,
    backward and gradient norm, the counterpart of the JAX package's jitted
    step.  Besides a ``_JitFrame``'s static scene and textures (its
    programs built with their VJP pieces) it holds the trainable leaves
    ``params`` ({path: tensor}, static, updated in place by the caller's
    optimiser), their ``transform``s ({path: fn}, applied as they enter
    the scene), the ``target`` and ``flat`` = [loss, every parameter's
    gradient]: ``grads[path]`` views it and is the parameter's ``.grad``.
    ``step()`` replays: the transform, every program's forward (with its
    tape), the loss and its cotangent, every program's backward in
    reverse, the transform's VJP and the gradient norm ``gnorm``."""

    def __init__(self, scene, textures, build, device, owned, paths, transform, loss,
                 target_shape):
        super().__init__(scene, textures, build, device, owned)
        self.params = {p: torch.empty_like(self.leaves[p]) for p in paths}
        sizes = [v.numel() for v in self.params.values()]
        self.flat = torch.zeros(1 + sum(sizes), device=device)
        self.grads = {p: g.view(v.shape) for (p, v), g in
                      zip(self.params.items(), self.flat[1:].split(sizes))}
        for p, v in self.params.items():
            v.grad = self.grads[p]
        self.transform = {p: fn for p, fn in transform.items() if p in self.params}
        # the scene leaves' gradients: a parameter's own, unless transformed
        self.gleaf = {p: torch.zeros_like(g) if p in self.transform else g
                      for p, g in self.grads.items()}
        self.target = torch.empty(target_shape, device=device)
        self.gnorm = torch.zeros((), device=device)
        self.loss = loss
        self.pieces = [_Eager(fn) for fn in (self._params_in, self._loss, self._params_out)]

    def trained(self):
        """{path: static scene leaf} of the trainable leaves."""
        return {p: self.leaves[p] for p in self.params}

    def leaf_grads(self, grads, add=False):
        """The gradients of ``trained()``'s leaves, in order (None: none),
        into the accumulators ``gleaf``: copied (they started from them,
        ``trace.vjp``'s seeds) or added."""
        pairs = [(self.gleaf[p], g) for p, g in zip(self.params, grads) if g is not None]
        if pairs:
            (torch._foreach_add_ if add else torch._foreach_copy_)(*map(list, zip(*pairs)))

    @torch.no_grad()
    def load(self, scene, textures, params, target):
        """The scene's leaves, the textures, the parameters ({path: tensor})
        and the target into the static buffers; a scene of another topology
        than the frame's raises."""
        if [(p, v.shape, v.dtype) for p, v in flatten_with_paths(scene).items()] != [
                (p, v.shape, v.dtype) for p, v in self.leaves.items()]:
            raise ValueError("the train step's graphs were captured for a scene of another "
                             "topology (leaf paths, shapes and types)")
        self._load(scene, textures)
        dev = self.rec.device
        torch._foreach_copy_(list(self.params.values()),
                             [params[p].to(dev) for p in self.params])
        self.target.copy_(target)

    def _params_in(self):
        plain = [p for p in self.params if p not in self.transform]
        torch._foreach_copy_([self.leaves[p] for p in plain], [self.params[p] for p in plain])
        for p, fn in self.transform.items():
            self.leaves[p].copy_(fn(self.params[p]))

    def _loss(self):
        self.flat.zero_()
        for g in [self.gleaf[p] for p in self.transform] + [p.g_out for p in self.programs[:-1]]:
            g.zero_()
        last = self.programs[-1]
        with torch.enable_grad():
            out = last.out.detach().requires_grad_(True)
            loss = self.loss(self, out)
            (g,) = torch.autograd.grad(loss, out)
        last.g_out.copy_(g)
        self.flat[0].copy_(loss.detach())

    def _params_out(self):
        for p, fn in self.transform.items():
            (g,) = tr.vjp(fn, [self.params[p]], [self.gleaf[p]])
            if g is not None:       # zeroed by _loss
                self.grads[p].copy_(g)
        self.gnorm.copy_(torch.linalg.vector_norm(self.flat[1:]))

    def _run(self, warm_up=False):
        params_in, loss, params_out = self.pieces
        params_in.replay()
        tapes = [p.run(warm_up) for p in self.programs]
        loss.replay()
        if not warm_up:
            for p, tape in zip(reversed(self.programs), reversed(tapes)):
                p.backward(tape)
        params_out.replay()

    def step(self):
        """One forward, loss, backward and gradient norm, every piece
        replayed (captured at the first call): the loss in ``flat[0]``, the
        gradients in ``grads``.  No host read but the live counts."""
        if not self.captured:
            self.pieces = self._capture(
                self._run, (self._params_in, self._loss, self._params_out))
        self._run()


def train_frame(scene, textures, cfg: RenderConfig, device, key, build, paths, transform,
                loss, target_shape):
    """A ``_TrainFrame`` of ``key``, the caller's alone: the one kept by
    ``keep_train_frame`` when its key matches, else a new one → (frame,
    textures after ``with_mips``); the caller loads it (``frame.load``).
    The key adds to ``key`` (the caller's: its kind and loss) ``cfg``, the
    scene topology, the atlas layout, the trainable ``paths`` and their
    ``transform``s; the optimiser is the caller's, its update captured per
    optimiser (``graphs.Recorder.capture_update``).  ``build(frame)`` → the
    programs (with ``out_shape``), ``loss(frame, out)`` → the scalar loss of
    the last program's ``out`` against ``frame.target``."""
    transform = {p: fn for p, fn in transform.items() if p in paths}

    def make(s, t, d, o):
        if d.type == "cuda":
            gc.collect()    # the frames of finished runs first: each holds its graphs' pool
        return _TrainFrame(s, t, build, d, o, paths, transform, loss, target_shape)

    return _cached_frame(scene, textures, cfg, device,
                         ("train", key, paths, tuple(sorted(transform.items()))), make,
                         take=True)


def _frame_program(frame, cfg: RenderConfig, train=False):
    """``render``'s frame without edge AA as one TraceProgram: the head
    packs the scene table and makes the primary rays in screen-tile order,
    the tail puts the colours back in raster order and averages the
    supersamples."""
    ss = cfg.supersample
    hs, ws = cfg.height * ss, cfg.width * ss
    tiled = hs % TILE_H == 0 and ws % TILE_W == 0

    def prepare(p):
        frame.table = pack_scene(frame.scene, frame.textures.atlas)

    def rays(p, scene):
        ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, ss)
        return (_tile_order(ro, hs, ws), _tile_order(rd, hs, ws)) if tiled else (ro, rd)

    def finish(p, color, _):
        return image(_untile_order(color, hs, ws) if tiled else color, cfg)

    return TraceProgram(frame, cfg, hs * ws, rays, finish, frame.rec, prepare=prepare,
                        out_shape=(cfg.height, cfg.width, 3) if train else None)


def _edge_program(frame, cfg: RenderConfig, base, train=False):
    """The edge-AA pass over ``base``'s image as one TraceProgram: the head
    picks the budget's K pixels (``_edge_pixels_fixed``) and makes their
    K·k² sub-sample rays, fills included; the tail averages each pixel's
    samples and writes the real pixels over the base image, dropping the
    fills."""
    H, W, k = cfg.height, cfg.width, cfg.supersample

    def prepare(p):
        p.pix = _edge_pixels_fixed(base.out, cfg)

    def rays(p, scene):
        return _subpixel_rays(scene.camera, torch.clamp(p.pix, max=H * W - 1), cfg)

    def finish(p, color, base_out):
        return _write_pixels(base_out, p.pix, _pixel_mean(color, k * k))

    return TraceProgram(frame, cfg, _edge_budget(cfg) * k * k, rays, finish, frame.rec,
                        prepare=prepare, prev=base, out_shape=(H, W, 3) if train else None)


def frame_programs(cfg: RenderConfig, train=False):
    """``build(frame)`` of ``render``'s frame: one program, or with edge AA
    the 1-spp frame and its edge pass; with ``train``, each with its VJP
    pieces (a train frame's)."""
    if cfg.aa_mode == "edge" and cfg.supersample > 1:
        def build(frame):
            base = _frame_program(frame, dataclasses.replace(cfg, supersample=1), train)
            return [base, _edge_program(frame, cfg, base, train)]
    else:
        def build(frame):
            return [_frame_program(frame, cfg, train)]
    return build


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
    return jit_frame(scene, textures, cfg, device, "render", frame_programs(cfg))
