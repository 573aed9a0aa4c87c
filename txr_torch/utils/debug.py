"""Numerical sanitizers (txr/utils/debug.py).

* ``enable_nan_checks()`` turns on autograd's anomaly detection (a backward
  node that returns a NaN raises, naming the forward op behind it) and a
  dispatch mode that watches the float outputs of every op that takes a
  tensor, for a NaN and, with ``infs``, for an Inf made out of finite
  inputs (an overflow or a division by zero).  It follows
  ``jax_debug_nans``/``jax_debug_infs``, which check a jit program's
  outputs and only then find the primitive at fault: an op outside the
  renderer's entry points (``render``, ``trace``, ``render_debug``, marked
  by ``program``) raises ``FloatingPointError`` at once; inside one, the
  first such op is remembered, and the entry point raises, naming it, only
  if its own output is not finite.  Masked lanes compute Infs that a
  ``where`` drops (the torus quartic overflows on rays far from it), so a
  clean render passes, as it does in the JAX package.  Every op waits on
  the device: debugging only.
* ``checked_render()`` renders and checks finiteness with one reduction
  on the device; ``err.throw()`` reads it and raises.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_MODE = []
_LIFT = torch.ops.aten.lift_fresh.default      # torch.tensor(...) of a Python value


def _floats(xs):
    return [x for x in tree_leaves(xs)
            if isinstance(x, torch.Tensor) and x.is_floating_point() and x.numel()]


class _NanCheck(TorchDispatchMode):
    def __init__(self, infs):
        super().__init__()
        self.infs = infs
        self.depth = 0          # entry points running
        self.first = {}         # "NaN"/"Inf" → the first op that made one inside them

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (torch._C._current_autograd_node() is not None or func is _LIFT
                or not any(isinstance(x, torch.Tensor) for x in tree_leaves((args, kwargs)))):
            return out          # the backward (anomaly mode's), factories and constants
        outs = _floats(out)
        found = None
        if any(bool(torch.isnan(o).any()) for o in outs):
            found = "NaN"
        elif (self.infs and any(bool(torch.isinf(o).any()) for o in outs)
              and all(bool(torch.isfinite(x).all()) for x in _floats((args, kwargs)))):
            found = "Inf"
        if found and not self.depth:
            raise FloatingPointError(f"{found} made by {func}")
        if found:
            self.first.setdefault(found, str(func))
        return out


def program(fn=None, *, checked=None):
    """Mark an entry point: with the checks on, its ops' NaNs and Infs
    count only if its output holds one (see the module doc).  ``checked``:
    a function of the output giving the tensors to check (default: all)."""
    if fn is None:
        return functools.partial(program, checked=checked)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not _MODE:
            return fn(*args, **kwargs)
        mode = _MODE[-1]
        mode.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            mode.depth -= 1
        if not mode.depth:
            first, mode.first = mode.first, {}
            vals = _floats(out if checked is None else checked(out))
            bad = ("NaN" if any(bool(torch.isnan(v).any()) for v in vals) else
                   "Inf" if mode.infs and any(bool(torch.isinf(v).any()) for v in vals) else None)
            if bad:
                raise FloatingPointError(
                    f"{bad} in the output of {fn.__name__}; first made by "
                    f"{first.get(bad, 'no op (an input held it)')}")
        return out

    return run


def enable_nan_checks(infs=True):
    """Turn the checks on (idempotent)."""
    disable_nan_checks()
    torch.autograd.set_detect_anomaly(True)
    mode = _NanCheck(infs)
    mode.__enter__()
    _MODE.append(mode)


def disable_nan_checks():
    while _MODE:
        _MODE.pop().__exit__(None, None, None)
    torch.autograd.set_detect_anomaly(False)


class RenderError:
    """The finiteness check of one render: a flag on the device, read by
    ``get``/``throw`` (the only host sync)."""

    def __init__(self, ok):
        self._ok = ok

    def get(self):
        """The error message, or None when every pixel is finite."""
        return None if bool(self._ok) else "non-finite pixels in render"

    def throw(self):
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


def checked_render(scene, textures, cfg, device=None):
    """→ (err, img): the render and its finiteness check, one reduction on
    the image's device; ``err.throw()`` raises if any pixel is not finite.
    Cheap enough to leave on in long unattended runs."""
    from txr_torch.render.render import render

    img = render(scene, textures, cfg, device=device)
    return RenderError(torch.isfinite(img).all()), img
