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
from txr_torch.render.render import frame_programs, keep_train_frame, render, train_frame
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


def _adam(params, lr):
    """The default optimiser: Adam with optax.adam's update, m̂ / (√v̂ +
    eps), eps = 1e-8, as ``torch.optim.Adam``'s fused kernel, whose step
    count and rate (the 0-dim tensor ``lr``) stay on the device: no host
    read, so its update can be captured (``capturable`` on the card)."""
    return torch.optim.Adam(params, lr=lr, eps=1e-8, fused=True, capturable=lr.is_cuda)


class _Fit:
    """One ``optimize_scene`` run: its parameters, the optimiser over them
    and its step.  Captured (``optimize_scene``'s only form): the
    parameters are the static buffers of the run's train frame
    (``render.train_frame``, keyed by cfg, the scene topology, the atlas
    layout, the trainable paths, their transforms and the loss kind; the
    run's alone until ``close`` keeps it for the next run of its key), and
    ``step`` replays the frame's forward, loss, backward and gradient norm,
    then the optimiser's update (``graphs.Recorder.capture_update``).  Not
    captured: ``_eager_step``, the op-by-op step the capture is held
    against.  ``lr`` is a 0-dim tensor on the device that the optimiser
    reads and ``step`` fills, so a schedule needs no capture of its own."""

    def __init__(self, scene, textures, cfg, target, param_paths=None, loss_kind="l2",
                 optimizer=None, lr=1e-2, param_transform=None, device=None, captured=True):
        self.dev = dev = resolve_device(device)
        self.cfg, self.loss_kind, self.captured = cfg, loss_kind, captured
        scene = scene.to(dev)
        flat = _flatten_with_paths(scene)
        paths = tuple(p for p, v in flat.items()
                      if v.is_floating_point() and _selected(p, param_paths))
        if not paths:
            raise ValueError(f"optimize_scene: no float leaf matches {param_paths}")
        self.transform = {p: fn for p, fn in (param_transform or {}).items() if p in flat}
        # a frozen leaf enters the scene transformed once
        self.scene0 = _unflatten_like(scene, {p: fn(flat[p]) for p, fn in self.transform.items()
                                              if p not in paths})
        self.target = torch.as_tensor(target, dtype=torch.float32).to(dev)
        if captured:
            self.frame, self.textures = train_frame(
                self.scene0, textures, cfg, dev, ("fit", loss_kind),
                frame_programs(cfg, train=True), paths, self.transform,
                lambda f, out: image_loss(out, f.target, loss_kind), tuple(self.target.shape))
            self.frame.load(self.scene0, self.textures, flat, self.target)
            self.params = self.frame.params
        else:
            self.textures = textures
            self.params = {p: flat[p].detach().clone().requires_grad_(True) for p in paths}
        self.rate = lr if callable(lr) else (lambda _step: lr)
        self.lr = torch.full((), float(self.rate(0)), device=dev)
        self.opt = (optimizer or _adam)(list(self.params.values()), self.lr)
        if callable(lr) and any(g["lr"] is not self.lr for g in self.opt.param_groups):
            raise ValueError("optimize_scene: a schedule needs an optimiser that reads the lr "
                             "tensor it is given")
        self.update = None

    def close(self):
        """The run is over: its train frame is kept for the next run of its
        key (``render.keep_train_frame``); the fit steps no more."""
        if self.captured and self.frame is not None:
            keep_train_frame(self.frame)
            self.frame = None

    def rebuild(self, params=None):
        """The scene of the parameters (default the fit's own), each
        through its transform."""
        merged = dict(self.params if params is None else params)
        for p, fn in self.transform.items():
            if p in merged:
                merged[p] = fn(merged[p])
        return _unflatten_like(self.scene0, merged)

    def scene(self):
        """The scene of the current parameters, on storage of its own."""
        with torch.no_grad():
            return self.rebuild({p: v.detach().clone() for p, v in self.params.items()})

    def step(self, i):
        """Step ``i`` → (loss, gradient norm), 0-dim tensors on the device;
        the gradients stay in each parameter's ``.grad``."""
        self.lr.fill_(self.rate(i))
        if not self.captured:
            return _eager_step(self)
        self.frame.step()
        if self.update is None:
            self.update = self.frame.rec.capture_update(self.opt)
        self.update.replay()
        return self.frame.flat[0], self.frame.gnorm


def _eager_step(fit):
    """The op-by-op step that the captured one replays, and its reference:
    ``render``, ``loss.backward()``, the gradient norm, ``opt.step()`` →
    (loss, gradient norm)."""
    fit.opt.zero_grad(set_to_none=True)
    loss = image_loss(render(fit.rebuild(), fit.textures, fit.cfg, device=fit.dev), fit.target,
                      fit.loss_kind)
    loss.backward()
    gnorm = torch.sqrt(sum((p.grad * p.grad).sum() for p in fit.params.values()
                           if p.grad is not None))
    fit.opt.step()
    return loss.detach(), gnorm


def optimize_scene(scene, textures, cfg, target, steps=100, lr=1e-2, param_paths=None,
                   loss_kind="l2", optimizer=None, callback=None, param_transform=None,
                   metrics_path=None, device=None, checkpoint_path=None, checkpoint_every=0,
                   resume=False):
    """Gradient-descend scene parameters toward ``target`` [H, W, 3].
    Returns (optimised scene, list of losses).

    ``param_paths``: the dotted leaf paths that move (prefixes count);
    default every float leaf.  ``lr``: a rate, or a function of the step
    giving the rate (a schedule).  ``optimizer``: a function of (params, lr)
    returning a ``torch.optim.Optimizer``, ``lr`` a 0-dim tensor on the
    device whose value is the step's rate; default Adam (``_adam``).
    ``param_transform``: {path: fn} applied to a parameter before it enters
    the scene, the stored parameter staying free (e.g. ``QUAT_NORMALIZE``).
    ``callback(step, scene, loss)`` runs after each step.  ``metrics_path``:
    one JSON record per step (step, loss, grad_norm, wall_s, rays_per_s).
    Runs on CUDA unless ``device`` says otherwise.

    Each step runs as CUDA graphs, the counterpart of the JAX package's
    jitted step: forward, loss, backward to every parameter, gradient norm
    and update, captured at the first step (``_Fit``) and replayed; the
    loss is read on the host once a step.  An optimiser that cannot be
    captured raises.  On the CPU the same pieces run eagerly.

    Failure recovery: with ``checkpoint_path`` and ``checkpoint_every=k``,
    the parameters, the optimiser's state (Adam: exp_avg, exp_avg_sq, step
    per parameter), the step counter and the loss history are written
    every k steps and after the last (``utils.checkpoint``, atomically);
    ``resume=True`` restarts from the file, if there is one, and goes on to
    ``steps`` in all: the lr schedule resumes at the saved step and the
    metrics file is appended to.  A resumed run is bit-identical to an
    uninterrupted one."""
    fit = _Fit(scene, textures, cfg, target, param_paths, loss_kind, optimizer, lr,
               param_transform, device)
    losses, start = [], 0
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        start, losses = _restore(checkpoint_path, fit.params, fit.opt)

    n_rays = cfg.width * cfg.height * cfg.supersample ** 2
    metrics_f = open(metrics_path, "a") if metrics_path else None
    try:
        for i in range(start, steps):
            t0 = time.perf_counter()
            loss, gnorm = fit.step(i)
            val = float(loss)     # fences the step, so wall_s is real
            losses.append(val)
            if metrics_f is not None:
                wall = time.perf_counter() - t0
                metrics_f.write(json.dumps({
                    "step": i, "loss": val, "grad_norm": float(gnorm), "wall_s": round(wall, 5),
                    "rays_per_s": round(n_rays / max(wall, 1e-9))}) + "\n")
                metrics_f.flush()
            if callback:
                with torch.no_grad():
                    callback(i, fit.scene(), val)
            if checkpoint_path and checkpoint_every and (
                    (i + 1) % checkpoint_every == 0 or i + 1 == steps):
                _save(checkpoint_path, fit.params, fit.opt, i + 1, losses)
        return fit.scene(), losses
    finally:
        if metrics_f is not None:
            metrics_f.close()
        fit.close()


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
        # contiguous strides even when empty (numpy gives an empty array
        # zero strides): the fused update wants its parameter's layout
        entry = {key[len(pre):]: torch.from_numpy(np.array(v)).clone(
                     memory_format=torch.contiguous_format)
                 for key, v in arrays.items() if key.startswith(pre) and "." not in key[len(pre):]}
        if entry:
            sd["state"][i] = entry
    # casts each moment to its parameter's dtype and device, keeps step as
    # saved; the hyperparameters stay the run's own (lr: the run's tensor)
    groups = [dict(g) for g in opt.param_groups]
    opt.load_state_dict(sd)
    for g, kept in zip(opt.param_groups, groups):
        g.update(kept)
    return int(arrays["step"]), [float(v) for v in arrays["losses"]]
