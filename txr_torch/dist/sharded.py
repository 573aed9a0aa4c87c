"""Sharded rendering and training over a world of ranks
(txr/dist/sharded.py).

Forward: the flat ray batch is split over the world's ranks, every rank
traces its contiguous block against the whole scene, and one
``all_gather`` assembles the colours on every rank.  Backward: the scene
parameters are replicated while the rays are split, so each rank's
backward gives partial parameter gradients; one ``all_reduce`` of the loss
and every gradient, in one flat buffer, completes them, and every rank
takes the same optimiser step.

``render_sharded_jit`` replays each rank's trace from CUDA graphs
(``render/graphs.py``) and gathers after it; ``make_train_step`` replays
each rank's forward and backward, all_reduces, and replays the update.

Every collective comes after the local ``trace`` (and after the local
backward): ranks leave the bounce loop at different steps
(``render/trace.py``'s early exit on ``alive.any()``), so a collective
inside it would deadlock, the fault that txr/dist/sharded.py:142-166
guards against in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from txr_torch import resolve_device
from txr_torch.diff.optimize import _selected
from txr_torch.dist.mesh import all_gather_rows, all_reduce_sum
from txr_torch.kernels.scene_table import pack_scene
from txr_torch.render.graphs import TraceProgram
from txr_torch.render.raygen import primary_rays
from txr_torch.render.render import image, jit_frame, train_frame
from txr_torch.render.texture import with_mips
from txr_torch.render.trace import trace
from txr_torch.scene.types import flatten_with_paths, unflatten_like


def _pad_to(x, multiple):
    """``x`` [n, ...] padded with copies of its last row to a multiple of
    ``multiple`` rows → (padded, number of rows added)."""
    pad = (-x.shape[0]) % multiple
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return x, pad


def _block(x, mesh):
    """This rank's contiguous block of the (padded) leading axis."""
    c = x.shape[0] // mesh.size
    return x[mesh.rank * c:(mesh.rank + 1) * c]


def render_sharded(scene, textures, cfg, mesh, device=None):
    """Render with the rays split over ``mesh``'s ranks → [H, W, 3] on every
    rank, on ``device`` (CUDA unless the caller passes "cpu").

    No edge AA, as the JAX sharded path: with ``supersample > 1`` the
    pixels are the uniform mean of their sub-samples (the render's
    ``aa_mode="ssaa"``)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    textures = with_mips(textures.to(dev))
    ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, cfg.supersample)
    n_rays = ro.shape[0]
    ro, _ = _pad_to(ro, mesh.size)
    rd, _ = _pad_to(rd, mesh.size)
    color = trace(scene, textures, cfg, _block(ro, mesh), _block(rd, mesh), device=dev)
    return image(all_gather_rows(color)[:n_rays], cfg)


def _rank_rays(cfg, mesh):
    """(n rays, block) and ``rays(p, scene)`` → this rank's block of the
    frame's primary rays, padded with the last ray to a multiple of the
    world's size; a TraceProgram's head."""
    ss = cfg.supersample
    n = cfg.width * ss * cfg.height * ss

    def rays(p, scene):
        ro, rd = primary_rays(scene.camera, cfg.width, cfg.height, ss)
        return _block(_pad_to(ro, mesh.size)[0], mesh), _block(_pad_to(rd, mesh.size)[0], mesh)

    return n, -(-n // mesh.size), rays


def _pack(frame):
    return lambda p: setattr(frame, "table", pack_scene(frame.scene, frame.textures.atlas))


def render_sharded_jit(scene, textures, cfg, mesh, device=None):
    """``render_sharded`` with each rank's trace of its block captured in
    CUDA graphs once per key and replayed (``render.render_jit``'s frames;
    the key adds the mesh's size and this rank) → [H, W, 3] on every rank,
    equal to ``render_sharded``'s image bit for bit.  The ``all_gather``
    stays outside the graphs, after the trace, as in ``render_sharded``."""
    n_rays, block, rays = _rank_rays(cfg, mesh)

    def build(frame):
        return [TraceProgram(frame, cfg, block, rays, lambda p, color, _: color.clone(),
                             frame.rec, prepare=_pack(frame))]

    color = jit_frame(scene, textures, cfg, device, ("sharded", mesh.size, mesh.rank), build)
    return image(all_gather_rows(color)[:n_rays], cfg)


@dataclasses.dataclass
class TrainState:
    """What ``make_train_step``'s ``init`` returns: the trainable leaves
    (``params``, {dotted path: tensor}: the static buffers of the step's
    train frame, each ``.grad`` a static gradient buffer), the optimiser
    over them, the train frame and the optimiser's captured update.  The
    frame is this state's alone; its graphs' memory goes with the state."""

    params: dict
    optimizer: torch.optim.Optimizer
    frame: object = None
    update: object = None


def make_train_step(textures, cfg, mesh, optimizer, param_paths=None, device=None):
    """A sharded train step: target image → loss, gradients summed over the
    world, one optimiser update on the replicated parameters
    (txr/dist/sharded.py:83-176) → (init, step).

    ``optimizer``: a function of the list of parameters returning a
    ``torch.optim.Optimizer``.  ``param_paths``: the dotted leaf paths that
    move (prefixes count); default every float leaf.
    ``init(scene)`` → a ``TrainState``;
    ``step(scene, state, target [H, W, 3])`` → (scene after the update,
    state, loss): the loss is mean((img − target)²) over the pixels, as
    the JAX step's.  The step reads its parameters from ``scene``, so a
    caller may pass any scene of the same topology.

    The step runs as CUDA graphs, captured at its first call
    (``render.train_frame``, the counterpart of the JAX step's ``jax.jit``):
    the local forward, loss Σ valid·(c − tgt)² and backward of this rank's
    block of rays, replayed; then, outside the graphs, one ``all_reduce``
    of the loss and every gradient in one flat buffer (never inside the
    bounce loop: ranks leave it at different steps); then the optimiser's
    update, captured at the state's first step
    (``graphs.Recorder.capture_update``: an optimiser that cannot be
    captured raises).  On the CPU the same pieces run eagerly."""
    dev = resolve_device(device)
    tex = with_mips(textures.to(dev))       # replicated, built once
    n, block, rays = _rank_rays(cfg, mesh)
    valid = ((torch.arange(block, device=dev) + mesh.rank * block) < n).to(torch.float32)

    def build(frame):
        return [TraceProgram(frame, cfg, block, rays, lambda p, color, _: color.clone(),
                             frame.rec, prepare=_pack(frame), out_shape=(block, 3))]

    def loss(frame, c):
        return (valid[:, None] * (c - frame.target) ** 2).sum()

    def split(scene):
        flat = flatten_with_paths(scene.to(dev))
        params = {p: v for p, v in flat.items()
                  if v.is_floating_point() and _selected(p, param_paths)}
        if not params:
            raise ValueError(f"make_train_step: no float leaf matches {param_paths}")
        return params

    def init(scene):
        scene = scene.to(dev)
        frame, _ = train_frame(scene, tex, cfg, dev, ("sharded", mesh.size, mesh.rank), build,
                               tuple(split(scene)), {}, loss, (block, 3))
        return TrainState(frame.params, optimizer(list(frame.params.values())), frame)

    def step(scene, state, target):
        scene = scene.to(dev)
        frame = state.frame
        tgt = torch.as_tensor(target, dtype=torch.float32).to(dev).reshape(-1, 3)
        frame.load(scene, tex, split(scene), _block(_pad_to(tgt, mesh.size)[0], mesh))
        # the local loss and its partial gradients: no collective in here
        frame.step()
        # one all_reduce of the loss and every gradient, in one flat buffer
        frame.flat.copy_(all_reduce_sum(frame.flat) / (3.0 * n))
        if state.update is None:
            state.update = frame.rec.capture_update(state.optimizer)
        state.update.replay()
        new = {p: v.detach().clone() for p, v in state.params.items()}
        return unflatten_like(scene, new), state, frame.flat[0].clone()

    return init, step
