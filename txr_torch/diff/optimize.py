"""Inverse rendering: fit scene parameters to a target image by gradient
descent on the render (txr/diff/optimize.py).

The scene's float leaves, named by dotted paths ("spheres.pos",
"camera.quat"), are the parameters; int and bool leaves (texture ids,
hollow flags) stay put.  The optimiser is ``torch.optim.Adam``, whose update
is optax.adam's: m̂ / (√v̂ + eps), eps = 1e-8.
"""

from __future__ import annotations

import json
import time

import torch

from txr_torch import resolve_device
from txr_torch.render.render import render
from txr_torch.scene.types import flatten_with_paths as _flatten_with_paths
from txr_torch.scene.types import unflatten_like as _unflatten_like


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
    Runs on CUDA unless ``device`` says otherwise.  Checkpoint and resume
    are not ported yet and raise."""
    if checkpoint_path or checkpoint_every or resume:
        raise NotImplementedError("optimize_scene: checkpoint and resume are not ported yet")
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

    n_rays = cfg.width * cfg.height * cfg.supersample ** 2
    losses = []
    metrics_f = open(metrics_path, "a") if metrics_path else None
    try:
        for i in range(steps):
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
    finally:
        if metrics_f is not None:
            metrics_f.close()
    with torch.no_grad():
        out = rebuild()
    return _detach(out), losses


def _detach(scene):
    return _unflatten_like(scene, {p: v.detach() for p, v in _flatten_with_paths(scene).items()})
