"""CUDA graphs of the render's fixed-shape pieces: the port's counterpart of
``jax.jit`` (``render.render_jit``, ``dist.sharded.render_sharded_jit``,
and the train step of ``diff.optimize_scene`` and
``dist.sharded.make_train_step``).

A piece is a function of no arguments that reads tensors held by an object
and sets new ones there.  On the card, ``Recorder.capture`` records it into
a ``torch.cuda.CUDAGraph``; every piece of one key shares the recorder's
memory pool and is replayed in the order of capture, so the tensors a piece
sets stay where the next piece's capture read them.  On the CPU the piece
runs eagerly at each "replay": the driver code is the same, without the
capture.  Pieces run inside ``render.intersect.fixed_shapes()`` and
``torch.no_grad()``; a piece that needs a gradient (a VJP) turns it on
inside and calls ``torch.autograd.grad``, whose backward a capture
records on the capture stream like any other op.

``TraceUnit`` is the bounce loop over R rays as pieces: a head, a step
for each lane capacity of ``capacities(R)``, a tail.  Its driver never
waits on the device: after each step it enqueues a non-blocking copy of
the count of live lanes into pinned memory and an event, and before it
enqueues step k + 1 it waits on step k − 1's event and reads that count.
A dead lane never lives again, so the count bounds the live lanes of step
k + 1: a count of 0 ends the loop (the while-loop condition of
txr/render/trace.py, read one step late: at most one extra step runs on a
state where every lane is dead, and such a step changes nothing), and
otherwise step k + 1 runs at the least capacity that holds the count: the
live lanes, in order, gathered into a buffer of that many rows, stepped,
and written back.  Every op of a step works lane by lane, so on the card
a step of C rows gives each lane the bits a step of R rows gives it.

Autograd cannot span two replays, so the train step is a chain of pieces,
each beside its VJP piece (``train``: txr/render/trace.py:1035-1332's loop
VJP): each forward step saves its residuals, and the backward replays the
steps' VJPs in reverse at the capacities the forward ran, reading nothing
on the host (``TraceUnit``, ``TraceProgram``).  The optimiser's update is
one more piece (``Recorder.capture_update``).

The kernel wrappers count a launch when they are called, also while a
graph records it.  A captured piece gives back what its capture counted
and adds it again at each replay, so ``kernels.launch_counts()`` counts the
launches that ran.
"""

from __future__ import annotations

import functools
import math

import torch

from txr_torch.kernels import add_launch_counts, launch_counts
from txr_torch.render import trace as tr
from txr_torch.render.intersect import fixed_shapes
from txr_torch.scene.types import unflatten_like
from txr_torch.utils import profiling
from txr_torch.utils.profiling import count, span


def _run(fn):
    with fixed_shapes(), torch.no_grad():
        fn()


class _Eager:
    """A piece run eagerly at each replay (the CPU, and the warm-up)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        _run(self.fn)


class _Graph:
    """A captured piece and the kernel launches its capture recorded."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches

    def replay(self):
        self.graph.replay()
        add_launch_counts(self.launches)


class _CapturedLater:
    """``fn`` as a piece that its recorder captures at its second replay:
    the first runs ``fn`` as it is, as the capture's warm-up on a side
    stream (the train step's update: the optimiser's first step creates
    the state a capture needs); the graph is replayed as soon as it is
    captured, so that what ``fn`` keeps (a tensor it makes, as
    ``keep_grads_sgd`` keeps the gradients) is the graph's, filled."""

    def __init__(self, rec, fn):
        self.rec, self.fn, self.warm, self.piece = rec, fn, False, None

    def replay(self):
        if not self.warm:
            self.rec.warm_up(self.fn)
            self.warm = True
            return
        if self.piece is None:
            self.piece = self.rec.capture(self.fn)
        self.piece.replay()


class Recorder:
    """Captures the pieces of one key into CUDA graphs sharing one memory
    pool (on the card), or keeps them to run eagerly (on the CPU)."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None

    def capture(self, fn):
        """fn as a piece: recorded into a graph on the card (a failed
        capture raises), kept as it is on the CPU."""
        if not self.cuda:
            return _Eager(fn)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            _run(fn)
        recorded = {k: n - before[k] for k, n in launch_counts().items()}
        add_launch_counts({k: -n for k, n in recorded.items()})
        return _Graph(graph, recorded)

    def warm_up(self, run):
        """run() (every piece once, eagerly) before any capture, on a side
        stream on the card: it builds and loads every kernel library and
        fills the caches (``intersect._slot_lookup``) that a capture must
        find ready."""
        if not self.cuda:
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def capture_update(self, opt):
        """``opt.step()`` as a piece (the train step's update).  A capture
        needs the optimiser's state, which its first ``step()`` creates, so
        on the card the first replay runs the update as it is and the
        second captures it (``_CapturedLater``): no assumption is made
        about where the state starts.  Raises for an optimiser built with
        ``capturable=False`` on the card, and on a failed capture (a
        ``step()`` that reads the host)."""
        if self.cuda and any(g.get("capturable") is False for g in opt.param_groups):
            raise ValueError(f"{type(opt).__name__} cannot be captured: build it with "
                             "capturable=True")
        return _CapturedLater(self, opt.step) if self.cuda else _Eager(opt.step)


# the least lane capacity of a compacted step; a frame's live lanes halve
# and more at each bounce (PERF.md §6), so the steps after the first two
# run on a fraction of the rays
MIN_CAPACITY = 1 << 14


def capacities(R, device):
    """The lane capacities a TraceUnit of R rays captures a step for: R, and
    on the card each power of two below R down to ``MIN_CAPACITY``.  The
    CPU steps every lane: its ATen ``atan2`` and ``pow`` round a value by
    where it sits in its array, so gathered lanes could change in a last
    bit against ``render``'s full-width step."""
    caps = [R]
    if device.type == "cuda":
        c = 1 << max(R - 1, 1).bit_length() - 1
        while c >= MIN_CAPACITY:
            caps.append(c)
            c //= 2
    return caps


def _state_fields(n):
    """The bounce state of n rows (``trace.initial_state``'s types)."""
    v3, v1 = ((n, 3), torch.float32), ((n,), torch.float32)
    return dict(ro=v3, rd=v3, color=v3, mask=v3, absorb_dist=v1, bounces=((n,), torch.int32),
                alive=((n,), torch.bool), missed=((n,), torch.bool))


def _probe_fields(n, counts):
    """The probe's residuals of n rows (``trace._SAVE_KEYS``, as
    ``kernels.step_probe.unpack`` gives them)."""
    L, nr = counts["lights_point"] + counts["lights_direct"], counts["rings"]
    out = dict(slot=((n,), torch.int64), t=((n,), torch.float32),
               light_solid=((n, L), torch.float32))
    if L and nr:
        out.update(ring_hit=((n, L, nr), torch.bool), ring_uv=((n, L, nr, 2), torch.float32))
    return out


class _Blob:
    """Tensors of the given shapes and types (``views``) as views of one
    byte buffer (``buf``), so that one copy saves or restores them all."""

    def __init__(self, fields, device):
        spans, n = [], 0
        for k, (shape, dtype) in fields.items():
            size = math.prod(shape) * dtype.itemsize
            spans.append((k, n, size, shape, dtype))
            n += -(-size // 16) * 16
        self.buf = torch.empty(n, dtype=torch.uint8, device=device)
        self.views = {k: self.buf[o:o + size].view(dtype).view(shape)
                      for k, o, size, shape, dtype in spans}


class TraceUnit:
    """``trace``'s bounce loop over R rays as pieces: ``head`` makes the
    primary state from the rays in ``ro``, ``rd`` (static [R, 3] inputs)
    in buffers of R + 1 rows, the last a row that compacted steps write
    their fill lanes to; a step for each capacity C of ``capacities`` runs
    one bounce step of ``cfg``'s route on the live lanes gathered into C
    rows (every lane when C = R) and writes the new state over the old,
    then counts the live lanes; ``tail`` adds the environment of the rays
    that missed → ``color`` [R, 3].  ``frame`` holds the static scene,
    textures and packed table (``frame.scene``, ``frame.textures``,
    ``frame.table``).

    With ``train`` (a frame of ``render.train_frame``) the unit also runs
    its VJP, the loop VJP of txr/render/trace.py:1035-1332 as pieces.  Each
    step also writes its residuals into its capacity's ``stage``: its input
    rows, the lane map (C < R) and, on the probe route, the probe's
    ``_SAVE_KEYS``; ``run`` copies the stage out after each step and the
    final state after the tail (a tape).  ``backward(tape)``, from the
    colours' cotangent ``g_color`` [R, 3]: the tail's VJP, then each step's
    VJP piece in reverse at the capacity it ran (its stage copied back in),
    which gathers the cotangent rows ``g`` of its lanes (a fill lane reads
    the zero spare row, so adds nothing), pulls them back through
    ``trace.step_vjp`` and scatters them back; the scene leaves' gradients
    go into the frame's accumulators (``frame.gleaf``, ``frame.leaf_grads``)
    in the association of the op-by-op backward, so the two agree bit for
    bit: each use added on in turn (the accumulators seed the VJP), but a
    probe-route step's sum added whole, as ``_FusedStep`` returns it.  The
    rays' cotangent ends in ``g["ro"]``, ``g["rd"]``."""

    def __init__(self, frame, cfg, R, rec, train=False):
        self.frame, self.cfg, self.rec, self.R, self.train = frame, cfg, rec, R, train
        dev = rec.device
        self.ro = torch.empty((R, 3), dtype=torch.float32, device=dev)
        self.rd = torch.empty((R, 3), dtype=torch.float32, device=dev)
        self.caps = capacities(R, dev)
        self.state = _Blob(_state_fields(R + 1), dev)
        self.rows = self.state.views
        self.st = {k: v[:R] for k, v in self.rows.items()}
        self.counts = torch.zeros(max(cfg.max_steps, 1), dtype=torch.int64,
                                  pin_memory=rec.cuda)
        self.events = ([torch.cuda.Event() for _ in range(cfg.max_steps)] if rec.cuda
                       else None)
        self.live = {}
        self.steps_run = []
        if train:
            self.stage = {C: _Blob(self._stage_fields(C), dev) for C in self.caps}
            self.g = {k: torch.zeros((R + 1,) + tuple(v.shape[1:]), device=dev)
                      for k, v in self.rows.items() if k in tr._FLOAT_STATE}
            self.g_color = torch.zeros((R, 3), device=dev)
        self._pieces(_Eager)

    def _stage_fields(self, C):
        """A step's residuals at capacity C: its input rows, the lane map
        (C < R) and the probe's saves (probe route)."""
        out = _state_fields(C)
        if C < self.R:
            out["lane"] = ((C,), torch.int64)
        if self.cfg.fused != "off":
            out.update(_probe_fields(C, self.frame.scene.counts))
        return out

    def _pieces(self, make):
        self.head = make(self._head)
        self.steps = {C: make(functools.partial(self._step, C)) for C in self.caps}
        self.tail = make(self._tail)
        if self.train:
            self.steps_bwd = {C: make(functools.partial(self._step_bwd, C)) for C in self.caps}
            self.tail_bwd = make(self._tail_bwd)

    def _head(self):
        for k, v in tr.initial_state(self.ro, self.rd).items():
            self.st[k].copy_(v)

    def _step(self, C):
        f, st, R = self.frame, self.st, self.R
        if C == R:
            sub = st
        else:
            # the live lanes in order into C rows, the rest of them fills
            alive = st["alive"]
            pos = torch.cumsum(alive, 0) - 1
            lane = torch.full((C + 1,), R, dtype=torch.int64, device=alive.device)
            lane.index_put_((torch.where(alive & (pos < C), pos, C),),
                            torch.arange(R, device=alive.device))
            lane = lane[:C]
            fill = lane == R
            src = torch.clamp(lane, max=R - 1)
            sub = {k: st[k].index_select(0, src) for k in tr.STATE_KEYS}
            sub["alive"] = sub["alive"] & ~fill
        if self.train:
            stage = self.stage[C].views
            new, saved = tr.step_saving(f.scene, f.textures, self.cfg, sub, f.table)
            for k, v in {**sub, **(saved or {}), **({} if C == R else {"lane": lane})}.items():
                if v is not None:
                    stage[k].copy_(v)
        else:
            new = tr.make_step(f.scene, f.textures, self.cfg, f.table)(sub)
        if C == R:
            for k in tr.STATE_KEYS:
                st[k].copy_(new[k])
        else:
            for k in tr.STATE_KEYS:
                self.rows[k].index_put_((lane,), new[k])
        self.live[C] = st["alive"].sum()

    def _tail(self):
        self.color = tr.shade_misses(self.frame.scene, self.frame.textures, self.st)

    def _step_bwd(self, C):
        f, R, g = self.frame, self.R, self.g
        v = self.stage[C].views
        saved = None if self.cfg.fused == "off" else {k: v.get(k) for k in tr._SAVE_KEYS}
        lane = None if C == R else v["lane"]
        g_out = {k: g[k][:R] if lane is None else g[k].index_select(0, lane) for k in g}
        # as the op-by-op backward sums: a probe-route step's leaf gradients
        # as one term (``_FusedStep``), an eager step's one use at a time
        seeds = None if saved is not None else list(f.gleaf.values())
        grads = tr.step_vjp(f.scene, f.textures, self.cfg, f.table,
                            {k: v[k] for k in tr.STATE_KEYS}, saved, g_out, f.trained(),
                            seeds=seeds)
        for k, gk in zip(tr._FLOAT_STATE, grads):
            gk = torch.zeros_like(g_out[k]) if gk is None else gk
            if lane is None:
                g[k][:R].copy_(gk)
            else:
                g[k].index_put_((lane,), gk)
                g[k][R:].zero_()
        f.leaf_grads(grads[len(tr._FLOAT_STATE):], add=seeds is None)

    def _tail_bwd(self):
        f, R = self.frame, self.R
        g_st, grads = tr.shade_misses_vjp(f.scene, f.textures, self.st, self.g_color, f.trained(),
                                          list(f.gleaf.values()))
        torch._foreach_zero_(list(self.g.values()))
        for k, gk in g_st.items():
            if gk is not None:
                self.g[k][:R].copy_(gk)
        f.leaf_grads(grads)

    def warm_up(self, ro, rd, color):
        """Every piece once, each step at every capacity (before a capture),
        on the rays ``ro``, ``rd``, the colours out into ``color``."""
        self.ro.copy_(ro)
        self.rd.copy_(rd)
        self.head.replay()
        for step in self.steps.values():
            step.replay()
        self.tail.replay()
        color.copy_(self.color)
        if self.train:
            self.tail_bwd.replay()
            for step in self.steps_bwd.values():
                step.replay()

    def capture(self):
        self._pieces(self.rec.capture)

    def _live_after(self, k, name="txr.wait_live"):
        with span(name):
            if self.events is not None:
                self.events[k].synchronize()
            return int(self.counts[k])

    def run(self, ro, rd, color):
        """The rays ``ro``, ``rd`` [R, 3] in, head, steps until no lane lives
        (seen one step late) or ``cfg.max_steps`` ran, each at the least
        capacity that holds the live lanes counted one step late, tail, the
        colours out into ``color`` [R, 3].  With ``train`` → the tape of
        ``backward``: (the capacities of the steps that saw a live lane,
        each one's stage copied out, the final state copied out); the step
        after the last live one changed nothing, so it has no VJP to run.
        With the tracer on, each step adds its live lanes, capacity and 1
        to the counters ``lanes``, ``rows`` and ``steps``: the count it
        reads one step late is the lanes entering the step before."""
        traced = profiling.enabled()
        with span("txr.head"):
            self.ro.copy_(ro)
            self.rd.copy_(rd)
            self.head.replay()
        self.steps_run, saves = [], []
        steps = self.cfg.max_steps
        for k in range(steps):
            live = self.R if k < 2 else self._live_after(k - 2)
            if traced and k != 1:
                # the lanes entering step k − 1 (k = 0: every ray of step 0)
                count("lanes", live)
            if not live:
                del saves[-1:]
                break
            with span("txr.step"):
                C = min(c for c in self.caps if c >= live)
                self.steps[C].replay()
                self.counts[k].copy_(self.live[C], non_blocking=True)
                if self.events is not None:
                    self.events[k].record()
            self.steps_run.append(C)
            if traced:
                count("rows", C)
                count("steps", 1)
            if self.train:
                saves.append((C, self.stage[C].buf.clone()))
        with span("txr.tail"):
            self.tail.replay()
            color.copy_(self.color)
        if traced and len(self.steps_run) == steps > 1:
            # the loop stopped at max_steps: the last step's lanes are unread
            count("lanes", self._live_after(steps - 2, "txr.wait_last"))
        if self.train:
            return saves, self.state.buf.clone()

    def backward(self, tape):
        """The VJP of the ``run`` that gave ``tape``: from ``g_color`` to
        the rays' cotangent (``g["ro"]``, ``g["rd"]``) and the leaves'
        gradients; no host read."""
        saves, final = tape
        self.state.buf.copy_(final)
        self.tail_bwd.replay()
        for C, buf in reversed(saves):
            self.stage[C].buf.copy_(buf)
            self.steps_bwd[C].replay()


class TraceProgram:
    """A fixed-shape trace of ``n`` rays in ``cfg.ray_chunk`` chunks: a head
    piece that runs ``prepare(self)`` (when given) and sets ``self.ro``,
    ``self.rd`` [n, 3] = ``rays(self, frame.scene)``, one ``TraceUnit`` per
    chunk size, and a tail piece that sets ``self.out`` = ``finish(self,
    self.color, prev.out)`` from the colours [n, 3] (and the output of the
    program ``prev``, None without).  The chunks' rays and colours move
    between the units' static buffers by copies outside the graphs.

    ``rays`` and ``finish`` are differentiable in the scene's leaves and in
    their tensor arguments: with ``out_shape`` (the shape of ``out``; a
    train frame's program), ``backward`` pulls ``g_out``, the cotangent of
    ``out``, back through the tail's VJP (``g_color``, and into
    ``prev.g_out``), each chunk's unit in reverse chunk order (the chunk
    cotangents copied in and out as the rays are) and the head's VJP (the
    rays' cotangent ``g_ro``, ``g_rd`` into the leaves' gradients)."""

    def __init__(self, frame, cfg, n, rays, finish, rec, prepare=None, prev=None,
                 out_shape=None):
        self.frame, self.rec, self.prev = frame, rec, prev
        self.train = out_shape is not None
        size = cfg.ray_chunk if cfg.ray_chunk and n > cfg.ray_chunk else n
        self.chunks = [(o, min(size, n - o)) for o in range(0, n, size)] if n else []
        self.units = {R: TraceUnit(frame, cfg, R, rec, self.train) for _, R in self.chunks}
        dev = rec.device
        self.color = torch.empty((n, 3), dtype=torch.float32, device=dev)
        self._rays, self._finish, self._prepare = rays, finish, prepare
        if self.train:
            self.g_out = torch.zeros(out_shape, device=dev)
            self.g_color, self.g_ro, self.g_rd = (torch.zeros((n, 3), device=dev)
                                                  for _ in range(3))
        self._pieces(_Eager)

    def _pieces(self, make):
        self.pieces = [make(self._head), make(self._tail)]
        if self.train:
            self.pieces += [make(self._tail_bwd), make(self._head_bwd)]

    def _head(self):
        if self._prepare is not None:
            self._prepare(self)
        self.ro, self.rd = self._rays(self, self.frame.scene)

    def _tail(self):
        self.out = self._finish(self, self.color, None if self.prev is None else self.prev.out)

    def _tail_bwd(self):
        ins = [self.color] + ([] if self.prev is None else [self.prev.out])
        grads = tr.vjp(lambda c, b=None: self._finish(self, c, b), ins, [self.g_out])
        self.g_color.copy_(grads[0])
        if self.prev is not None and grads[1] is not None:
            self.prev.g_out.add_(grads[1])

    def _head_bwd(self):
        f = self.frame
        leaves = f.trained()
        paths = list(leaves)
        grads = tr.vjp(lambda *lv: self._rays(self, unflatten_like(f.scene, dict(zip(paths, lv)))),
                       list(leaves.values()), [self.g_ro, self.g_rd],
                       seeds=dict(enumerate(f.gleaf.values())))
        f.leaf_grads(grads)

    def capture(self):
        self._pieces(self.rec.capture)
        for unit in self.units.values():
            unit.capture()

    def run(self, warm_up=False):
        """Head, each chunk's unit (with ``warm_up``, its every piece once,
        and then the program's VJP pieces), tail → each chunk's tape (a
        train frame's program)."""
        head, tail = self.pieces[:2]
        with span("txr.head"):
            head.replay()
        tapes = []
        for o, R in self.chunks:
            unit = self.units[R]
            run = unit.warm_up if warm_up else unit.run
            tapes.append(run(self.ro[o:o + R], self.rd[o:o + R], self.color[o:o + R]))
        with span("txr.tail"):
            tail.replay()
        if warm_up and self.train:
            for piece in self.pieces[2:]:
                piece.replay()
        return tapes

    def backward(self, tapes):
        """The VJP of the ``run`` that gave ``tapes``, from ``g_out``."""
        tail_bwd, head_bwd = self.pieces[2:]
        tail_bwd.replay()
        for (o, R), tape in zip(reversed(self.chunks), reversed(tapes)):
            unit = self.units[R]
            unit.g_color.copy_(self.g_color[o:o + R])
            unit.backward(tape)
            self.g_ro[o:o + R].copy_(unit.g["ro"][:R])
            self.g_rd[o:o + R].copy_(unit.g["rd"][:R])
        head_bwd.replay()
