"""Sharded rendering and training over a world of ranks
(txr/dist/sharded.py).

Forward: the flat ray batch is split over the world's ranks, every rank
traces its contiguous block against the whole scene, and one
``all_gather`` assembles the colours on every rank.  Backward: the scene
parameters are replicated while the rays are split, so each rank's
backward gives partial parameter gradients; one ``all_reduce`` of the loss
and every gradient, in one flat buffer, completes them, and every rank
takes the same optimiser step.

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
from txr_torch.render.raygen import primary_rays
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
    color = all_gather_rows(color)[:n_rays]
    ss = cfg.supersample
    if ss > 1:
        return color.reshape(cfg.height, ss, cfg.width, ss, 3).mean(dim=(1, 3))
    return color.reshape(cfg.height, cfg.width, 3)


@dataclasses.dataclass
class TrainState:
    """What ``make_train_step``'s ``init`` returns: the trainable leaves
    (``params``, {dotted path: tensor}) and the optimiser over them."""

    params: dict
    optimizer: torch.optim.Optimizer


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
    caller may pass any scene of the same topology."""
    dev = resolve_device(device)
    tex = with_mips(textures.to(dev))       # replicated, built once

    def split(scene):
        flat = flatten_with_paths(scene.to(dev))
        params = {p: v for p, v in flat.items()
                  if v.is_floating_point() and _selected(p, param_paths)}
        if not params:
            raise ValueError(f"make_train_step: no float leaf matches {param_paths}")
        return flat, params

    def init(scene):
        _, params = split(scene)
        params = {p: v.detach().clone().requires_grad_(True) for p, v in params.items()}
        return TrainState(params, optimizer(list(params.values())))

    def step(scene, state, target):
        flat, given = split(scene)
        with torch.no_grad():
            for p, v in state.params.items():
                v.copy_(given[p])
        sc = unflatten_like(scene, {**flat, **state.params})
        ro, rd = primary_rays(sc.camera, cfg.width, cfg.height, cfg.supersample)
        tgt = torch.as_tensor(target, dtype=torch.float32).to(dev).reshape(-1, 3)
        n = ro.shape[0]
        ro, _ = _pad_to(ro, mesh.size)
        rd, _ = _pad_to(rd, mesh.size)
        tgt, _ = _pad_to(tgt, mesh.size)
        valid = (torch.arange(ro.shape[0], device=dev) < n).to(ro.dtype)
        ro, rd, tgt, valid = (_block(x, mesh) for x in (ro, rd, tgt, valid))
        # the local loss and its partial gradients: no collective in here
        c = trace(sc, tex, cfg, ro, rd, device=dev)
        local = (valid[:, None] * (c - tgt) ** 2).sum()
        leaves = list(state.params.values())
        grads = torch.autograd.grad(local, leaves, allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g for v, g in zip(leaves, grads)]
        # one all_reduce of the loss and every gradient, in one flat buffer
        buf = torch.cat([local.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        buf = all_reduce_sum(buf) / (3.0 * n)
        loss, off = buf[0], 1
        for v in leaves:
            v.grad = buf[off:off + v.numel()].reshape(v.shape)
            off += v.numel()
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        new = {p: v.detach().clone() for p, v in state.params.items()}
        return unflatten_like(scene.to(dev), new), state, loss

    return init, step
