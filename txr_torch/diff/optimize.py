"""Inverse rendering: fit scene parameters to a target image by gradient
descent on the render (txr/diff/optimize.py).

The scene's float leaves, named by dotted paths ("spheres.pos",
"camera.quat"), are the parameters; int and bool leaves (texture ids,
hollow flags) stay put.  The optimiser is ``torch.optim.Adam``, whose update
is optax.adam's: m̂ / (√v̂ + eps), eps = 1e-8.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from txr_torch import resolve_device
from txr_torch.render.render import render
from txr_torch.scene.types import flatten_with_paths as _flatten_with_paths
from txr_torch.scene.types import unflatten_like as _unflatten_like
from txr_torch.utils.checkpoint import load_arrays, rebuild_tree, save_state


def image_loss(img, target, kind="l2"):
    d = img - target
    if kind == "l2":
        return (d * d).mean()
    if kind == "l1":
        return d.abs().mean()
    raise ValueError(kind)


def _selected(path, param_paths):
    return param_paths is None or any(path == m or path.startswith(m + ".")
                                      for m in param_paths)


def scene_grad(loss_fn, scene, *args, **kwargs):
    """(value, grads) of ``loss_fn(scene, *args, **kwargs)``, a scalar
    tensor, over the scene's float leaves (txr/diff/optimize.py:51-54).
    ``grads`` is a scene of the same structure: each float leaf holds its
    gradient (zeros where the loss does not reach it), each int or bool
    leaf zeros, as ``jax.value_and_grad(allow_int=True)`` and the JAX
    package's zeroing of int tangents give."""
    flat = _flatten_with_paths(scene)
    params = {p: v.detach().clone().requires_grad_(True) for p, v in flat.items()
              if v.is_floating_point()}
    val = loss_fn(_unflatten_like(scene, params), *args, **kwargs)
    got = torch.autograd.grad(val, list(params.values()), allow_unused=True)
    grads = {p: torch.zeros_like(v) for p, v in flat.items()}
    grads.update({p: g for p, g in zip(params, got) if g is not None})
    return val.detach(), _unflatten_like(scene, grads)


def select_params(mask_paths):
    """A filter of ``scene_grad``'s grads: leaves whose dotted path is one of
    ``mask_paths`` or lies under one (e.g. ["spheres.pos", "camera"]) keep
    their gradient, every other leaf becomes zeros (optimize.py:57-69)."""

    def apply(grads):
        return _unflatten_like(grads, {
            p: g if _selected(p, mask_paths) else torch.zeros_like(g)
            for p, g in _flatten_with_paths(grads).items()})

    return apply


def optimize_scene(scene, textures, cfg, target, steps=100, lr=1e-2, param_paths=None,
                   loss_kind="l2", optimizer=None, callback=None, param_transform=None,
                   metrics_path=None, device=None, checkpoint_path=None, checkpoint_every=0,
                   resume=False):
    """Gradient-descend scene parameters toward ``target`` [H, W, 3].
    Returns (optimised scene, list of losses).

    ``param_paths``: the dotted leaf paths that move (prefixes count);
    default every float leaf.  ``lr``: a rate, or a function of the step
    giving the rate (a schedule).  ``optimizer``: a function of (params, lr)
    returning a ``torch.optim.Optimizer``; default Adam.
    ``param_transform``: {path: fn} applied to a parameter before it enters
    the scene, the stored parameter staying free (e.g. ``QUAT_NORMALIZE``).
    ``callback(step, scene, loss)`` runs after each step.  ``metrics_path``:
    one JSON record per step (step, loss, grad_norm, wall_s, rays_per_s).
    Runs on CUDA unless ``device`` says otherwise.

    Failure recovery: with ``checkpoint_path`` and ``checkpoint_every=k``,
    the parameters, the optimiser's state (Adam: exp_avg, exp_avg_sq, step
    per parameter), the step counter and the loss history are written
    every k steps and after the last (``utils.checkpoint``, atomically);
    ``resume=True`` restarts from the file, if there is one, and goes on to
    ``steps`` in all: the lr schedule resumes at the saved step and the
    metrics file is appended to.  On the CPU a resumed run is bit-identical
    to an uninterrupted one."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    target = torch.as_tensor(target, dtype=torch.float32).to(dev)
    flat = _flatten_with_paths(scene)
    params = {p: v.detach().clone().requires_grad_(True) for p, v in flat.items()
              if v.is_floating_point() and _selected(p, param_paths)}
    if not params:
        raise ValueError(f"optimize_scene: no float leaf matches {param_paths}")
    rate = lr if callable(lr) else (lambda _step: lr)
    make = optimizer or (lambda ps, r: torch.optim.Adam(ps, lr=r, eps=1e-8))
    opt = make(list(params.values()), rate(0))

    def rebuild():
        merged = {**flat, **params}
        for path, fn in (param_transform or {}).items():
            if path in merged:
                merged[path] = fn(merged[path])
        return _unflatten_like(scene, merged)

    losses, start = [], 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        start, losses = _restore(checkpoint_path, params, opt)

    n_rays = cfg.width * cfg.height * cfg.supersample ** 2
    metrics_f = open(metrics_path, "a") if metrics_path else None
    try:
        for i in range(start, steps):
            t0 = time.perf_counter()
            for group in opt.param_groups:
                group["lr"] = rate(i)
            opt.zero_grad(set_to_none=True)
            loss = image_loss(render(rebuild(), textures, cfg, device=dev), target, loss_kind)
            loss.backward()
            gnorm = torch.sqrt(sum((p.grad * p.grad).sum() for p in params.values()
                                   if p.grad is not None))
            opt.step()
            val = float(loss.detach())     # fences the step, so wall_s is real
            losses.append(val)
            if metrics_f is not None:
                wall = time.perf_counter() - t0
                metrics_f.write(json.dumps({
                    "step": i, "loss": val, "grad_norm": float(gnorm), "wall_s": round(wall, 5),
                    "rays_per_s": round(n_rays / max(wall, 1e-9))}) + "\n")
                metrics_f.flush()
            if callback:
                with torch.no_grad():
                    callback(i, rebuild(), val)
            if checkpoint_path and checkpoint_every and (
                    (i + 1) % checkpoint_every == 0 or i + 1 == steps):
                _save(checkpoint_path, params, opt, i + 1, losses)
    finally:
        if metrics_f is not None:
            metrics_f.close()
    with torch.no_grad():
        out = rebuild()
    return _detach(out), losses


def _save(path, params, opt, step, losses):
    """The run's state as ``utils.checkpoint.save_state`` writes it:
    params.<path>, opt_state.<path>.<key> (the optimiser's per-parameter
    state), step, losses."""
    state = opt.state
    save_state(path, {
        "params": params,
        "opt_state": {k: dict(state[p]) for k, p in params.items() if p in state},
        "step": np.int64(step),
        "losses": np.asarray(losses, np.float64),
    })


def _restore(path, params, opt):
    """Load ``_save``'s file into ``params`` (in place) and ``opt`` →
    (step, losses)."""
    arrays, _ = load_arrays(path)
    held = {k[len("params."):] for k in arrays if k.startswith("params.")}
    if held != set(params):
        raise ValueError(f"optimize_scene: the checkpoint {path} holds parameters "
                         f"{sorted(held)}, this run optimises {sorted(params)}")
    saved = rebuild_tree(arrays, {"params": {k: p.detach() for k, p in params.items()}})
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved["params"][k])
    sd = opt.state_dict()
    for i, k in enumerate(params):
        pre = f"opt_state.{k}."
        entry = {key[len(pre):]: torch.from_numpy(np.array(v)) for key, v in arrays.items()
                 if key.startswith(pre) and "." not in key[len(pre):]}
        if entry:
            sd["state"][i] = entry
    # casts each moment to its parameter's dtype and device, keeps step as saved
    opt.load_state_dict(sd)
    return int(arrays["step"]), [float(v) for v in arrays["losses"]]


def _detach(scene):
    return _unflatten_like(scene, {p: v.detach() for p, v in _flatten_with_paths(scene).items()})
