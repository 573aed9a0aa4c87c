"""The general traffic generator: a traffic mix (``rtbench/traffic/<mix>.json``)
names a loop kind and its parameters, and one of the loops below drives
the system with it.  Both are closed loops with one caller.

``view``: the live viewer's frame loop (txr_torch/apps/live.py:211-250).
Frame k poses the scene at t = t0 + k / fps (``update_scene``, dt 0),
renders it with ``render_jit``, converts it to uint8 on the card, starts a
non-blocking copy to pinned host memory, then waits for the previous
frame's copy: that frame is delivered.  Parameters: ``fps``, ``t0`` (the
range t0 is drawn from), ``check_frames`` (frames compared with the
reference, drawn from the first ``check_span_s`` seconds of frames),
``trace_skip`` and ``trace_units`` (the frames a traced run profiles).

``fit``: the captured inverse-rendering step of ``optimize_scene``
(``diff.optimize._Fit``): the gradient of mean(img²) over every float leaf
of the scene posed at a time t drawn from ``t``, Adam at rate ``lr``; each
step's loss read on the host, as ``optimize_scene`` reads it.
Parameters: ``t``, ``lr``, ``first_steps`` (taken in set-up, the first
two capture), ``trace_skip`` and ``trace_units``.

Each loop: ``setup()`` builds, warms up and captures, and returns the
seconds of its capturing calls; ``window(seconds, traced)`` runs the timed
window; ``outputs()`` copies what the timed path produced to the host and
frees the program's state; ``compare(dev)`` runs the reference and
returns the numbers compared and the reference's work tally.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import check, system, textures
from rtbench import traces as tr
from rtbench.reference import render as ref

# Adam's moment rates (torch.optim.Adam's defaults, which _Fit's optimiser
# keeps): the reference reads the gradient back out of the moments
BETAS = (0.9, 0.999)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Profiled:
    """The profiler of a traced run: ``arm()`` starts it in set-up (its
    start-up stays out of the window), ``begin()`` opens the mark before
    the first traced unit, ``end()`` closes it once the last traced unit
    has ended on the device and stops the profiler; ``read()`` parses the
    trace."""

    def __init__(self, dev):
        self.dev, self.prof, self.mark = dev, None, None

    def arm(self):
        act = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            act.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=act)
        self.prof.__enter__()

    def begin(self):
        if self.prof is not None and self.mark is None:
            self.mark = torch.profiler.record_function(tr.MARK)
            self.mark.__enter__()

    def end(self):
        if not self.mark:
            return
        _sync(self.dev)
        self.mark.__exit__(None, None, None)
        self.mark = False
        # the tracer keeps only the device records inside its own window
        time.sleep(0.05)
        self.prof.__exit__(None, None, None)

    def read(self, kernels):
        if not self.prof:
            return None
        self.end()
        return tr.read(self.prof, kernels)


class Loop:
    def __init__(self, cfg, traffic, seed, dev, traced=False, size=None):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, int(seed), dev
        self.size = size or (cfg["render"]["width"], cfg["render"]["height"])
        self.rng = np.random.default_rng(self.seed)
        self.prof = _Profiled(dev)
        self.traced = traced
        # seconds of each part of set-up, in order (printed on stderr)
        self.phases = {}

    def _timed(self, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        _sync(self.dev)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t
        return out

    def _build_inputs(self):
        self.raw = textures.make(self.cfg, self.seed, self.dev)
        self.settings = ref.settings(self.cfg, *self.size)

    def _build(self):
        self._timed("import_program", system.imports)
        self._timed("textures", self._build_inputs)
        self.scene0, self.handles = self._timed("scene", system.scene, self.cfg, self.dev)
        self.tex = self._timed("mips", system.textures, self.cfg, self.raw)
        self.rc = system.render_config(self.cfg, *self.size)


class View(Loop):
    kind = "view"

    def __init__(self, cfg, traffic, seed, dev, traced=False, size=None):
        super().__init__(cfg, traffic, seed, dev, traced, size)
        p = traffic
        self.fps = float(p["fps"])
        lo, hi = p["t0"]
        self.t0 = lo + (hi - lo) * float(self.rng.random())
        if traced:
            pool = np.arange(p["trace_skip"], p["trace_skip"] + p["trace_units"])
        else:
            pool = np.arange(int(p["check_span_s"] * self.fps))
        self.checked = sorted(int(k) for k in self.rng.choice(pool, p["check_frames"],
                                                              replace=False))

    def t_of(self, k):
        return self.t0 + k / self.fps

    def _frame(self, k):
        from txr_torch.render import render as rr

        with torch.no_grad():
            img = rr.render_jit(system.pose(self.scene0, self.handles, self.t_of(k)), self.tex,
                                self.rc, device=self.dev)
            u8 = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        if self.dev.type != "cuda":
            return img, u8, None
        host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(u8, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return img, host, done

    def setup(self):
        self._build()
        self.kept, self.host = {}, {}
        self._timed("capture", self._frame, 0)
        self._timed("second_frame", self._frame, 1)
        if self.traced:
            self._timed("profiler", self.prof.arm)
        return self.phases["capture"]

    def window(self, seconds):
        prof, traced = self.prof, self.traced
        skip, n_tr = self.traffic["trace_skip"], self.traffic["trace_units"]
        start, host_s, delivered = [], [], []
        pending = None
        k = 0
        w0 = time.perf_counter()
        closed = None

        def deliver(p):
            j, host, done = p
            if done is not None:
                done.synchronize()
            delivered.append(time.perf_counter())
            if j in self.checked:
                self.host[j] = host.clone()

        while True:
            if traced and k == skip:
                prof.begin()
            s = time.perf_counter()
            img, host, done = self._frame(k)
            start.append(s)
            host_s.append(time.perf_counter() - s)
            if k in self.checked:
                self.kept[k] = img.clone()
            if pending is not None:
                deliver(pending)
                if traced and pending[0] == skip + n_tr - 1:
                    prof.end()
            pending = (k, host, done)
            k += 1
            now = time.perf_counter()
            if closed is None and now - w0 >= seconds:
                deliver(pending)
                pending = None
                closed = (len(delivered), delivered[-1])
            if closed is not None:
                # frames checked but not reached in the window come late:
                # render on, untimed, for at most a minute
                if all(j in self.host for j in self.checked) or now - closed[1] > 60.0:
                    break
        if pending is not None:
            deliver(pending)
        prof.end()
        n, end = closed
        lat = [(d - s) * 1e3 for s, d in zip(start[:n], delivered[:n])]
        # wall a frame where no profiler ran: between deliveries after it
        after = skip + n_tr + 1 if traced else 1
        walls = np.diff(delivered[:n])[after - 1:] * 1e3
        return dict(units=n, window_s=end - w0, frames_per_s=n / (end - w0),
                    frame_ms_p95=float(np.percentile(lat, 95)),
                    host_ms=[h * 1e3 for j, h in enumerate(host_s[:n]) if j >= after],
                    wall_ms=float(walls.mean()) if walls.size else None,
                    traced_units=n_tr if traced else 0)

    def outputs(self):
        from txr_torch.render.render import clear_jit_cache

        out = dict(frames={k: v.double().cpu() for k, v in self.kept.items()},
                   u8={k: v.cpu() for k, v in self.host.items()})
        self.kept = self.host = None
        self.scene0 = self.tex = None
        clear_jit_cache()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def compare(self, out, dtype=torch.float64, tally=False):
        T = ref.Textures(self.cfg, self.raw, dtype)
        numbers, work = [], []
        for k in self.checked:
            if k not in out["frames"] or k not in out["u8"]:
                # a frame that never came is off everywhere
                numbers.append(dict(frame_missing=1.0, frame_off=1.0, u8_off=1.0))
                continue
            S = ref.Scene(self.cfg, self.t_of(k), dtype, self.dev)
            steps = [] if tally else None
            with torch.no_grad():
                want = ref.render(S, T, self.settings, tally=steps).double().cpu()
            numbers.append(dict(check.frame_numbers(out["frames"][k], out["u8"][k], want),
                                frame_missing=0.0))
            if tally:
                work.append(steps)
        return check.worst(numbers), work

    def control(self, dtype):
        """What the view would deliver if the reference in ``dtype`` stood in
        the program's place, as ``outputs`` gives it."""
        self._build_inputs()
        T = ref.Textures(self.cfg, self.raw, dtype)
        out = dict(frames={}, u8={})
        for k in self.checked:
            with torch.no_grad():
                img = ref.render(ref.Scene(self.cfg, self.t_of(k), dtype, self.dev), T,
                                 self.settings).float()
            out["frames"][k] = img.double().cpu()
            out["u8"][k] = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).cpu()
        return out


class Fit(Loop):
    kind = "fit"

    def __init__(self, cfg, traffic, seed, dev, traced=False, size=None):
        super().__init__(cfg, traffic, seed, dev, traced, size)
        lo, hi = traffic["t"]
        self.t = lo + (hi - lo) * float(self.rng.random())

    def _step(self, i):
        loss, _ = self.fit.step(i)
        return float(loss)

    def _moment(self, v, key):
        """The optimiser's moment of parameter v (zeros if it kept none)."""
        got = self.fit.opt.state.get(v, {}).get(key)
        return torch.zeros(v.shape, dtype=torch.float64) if got is None else got.double().cpu()

    def setup(self):
        from txr_torch.diff.optimize import _Fit

        self._build()
        posed = system.pose(self.scene0, self.handles, self.t)
        target = torch.zeros((self.rc.height, self.rc.width, 3), device=self.dev)
        self.fit = _Fit(posed, self.tex, self.rc, target, lr=float(self.traffic["lr"]),
                        device=self.dev)
        self.params0 = {p: v.detach().clone() for p, v in self.fit.params.items()}
        self.losses = []
        for i in range(self.traffic["first_steps"]):
            self.losses.append(self._timed("capture" if i < 2 else "first_steps", self._step, i))
            if i == 0:
                # the first gradient as the optimiser got it: m₁ = (1 − β₁)·g
                self.g_first = {p: self._moment(v, "exp_avg") / (1 - BETAS[0])
                                for p, v in self.fit.params.items()}
        self.steps = self.traffic["first_steps"]
        if self.traced:
            self._timed("profiler", self.prof.arm)
        return self.phases["capture"]

    def window(self, seconds):
        prof, traced = self.prof, self.traced
        skip, n_tr = self.traffic["trace_skip"], self.traffic["trace_units"]
        n, walls = 0, []
        w0 = time.perf_counter()
        while True:
            if traced and n == skip:
                prof.begin()
            s = time.perf_counter()
            self.losses.append(self._step(self.steps))
            end = time.perf_counter()
            self.steps += 1
            n += 1
            if traced and n == skip + n_tr:
                prof.end()
            elif not traced or n > skip + n_tr:
                walls.append((end - s) * 1e3)
            if end - w0 >= seconds and (not traced or n > skip + n_tr):
                break
        prof.end()
        return dict(units=n, window_s=end - w0, step_ms=(end - w0) * 1e3 / n,
                    wall_ms=float(np.mean(walls)), traced_units=n_tr if traced else 0)

    def outputs(self):
        from txr_torch.render.render import clear_jit_cache

        fit = self.fit
        n = self.steps
        out = dict(losses=list(self.losses), g_first=self.g_first, steps=n,
                   g_last={p: v.grad.double().cpu() for p, v in fit.params.items()},
                   g_m={}, g_v={}, moved=0.0)
        for p, v in fit.params.items():
            out["g_m"][p] = self._moment(v, "exp_avg") / (1 - BETAS[0] ** n)
            out["g_v"][p] = torch.sqrt(self._moment(v, "exp_avg_sq") / (1 - BETAS[1] ** n))
            if v.numel():
                out["moved"] = check.most([out["moved"],
                                           float((v.detach() - self.params0[p]).abs().max())])
        fit.close()
        self.fit = self.scene0 = self.tex = self.params0 = None
        clear_jit_cache()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def compare(self, out, dtype=torch.float64, tally=False):
        S = ref.Scene(self.cfg, self.t, dtype, self.dev, requires_grad=True)
        T = ref.Textures(self.cfg, self.raw, dtype)
        # the step's forward is the posed frame's: its tally prices the step
        steps = [] if tally else None
        loss, grads, _ = ref.loss_and_grad(S, T, self.settings, tally=steps)
        grads = {k: v.double().cpu() for k, v in grads.items()}
        return check.fit_numbers(out, loss, grads), [steps] if tally else []

    def control(self, dtype, rows=None):
        """What the fit would leave if the reference in ``dtype`` stood in the
        program's place (with ``rows``, its mean taken over those image
        rows alone), as ``outputs`` gives it."""
        self._build_inputs()
        S = ref.Scene(self.cfg, self.t, dtype, self.dev, requires_grad=True)
        loss, grads, _ = ref.loss_and_grad(S, ref.Textures(self.cfg, self.raw, dtype),
                                           self.settings, rows=rows)
        g = {k: v.double().cpu() for k, v in grads.items()}
        return dict(losses=[loss], g_first=g, g_last=g, g_m=g, g_v=g, moved=0.0, steps=1)


LOOPS = dict(view=View, fit=Fit)
