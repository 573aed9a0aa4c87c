"""CUDA graphs of the render's fixed-shape pieces: the port's counterpart of
``jax.jit`` (``render.render_jit``, ``dist.sharded.render_sharded_jit``).

A piece is a function of no arguments that reads tensors held by an object
and sets new ones there.  On the card, ``Recorder.capture`` records it into
a ``torch.cuda.CUDAGraph``; every piece of one key shares the recorder's
memory pool and is replayed in the order of capture, so the tensors a piece
sets stay where the next piece's capture read them.  On the CPU the piece
runs eagerly at each "replay": the driver code is the same, without the
capture.  Pieces run inside ``render.intersect.fixed_shapes()`` and
``torch.no_grad()``.

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

The kernel wrappers count a launch when they are called, also while a
graph records it.  A captured piece gives back what its capture counted
and adds it again at each replay, so ``kernels.launch_counts()`` counts the
launches that ran.
"""

from __future__ import annotations

import torch

from txr_torch.kernels import add_launch_counts, launch_counts
from txr_torch.render import trace as tr
from txr_torch.render.intersect import fixed_shapes


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
    ``frame.table``)."""

    def __init__(self, frame, cfg, R, rec):
        self.frame, self.cfg, self.rec, self.R = frame, cfg, rec, R
        dev = rec.device
        self.ro = torch.empty((R, 3), dtype=torch.float32, device=dev)
        self.rd = torch.empty((R, 3), dtype=torch.float32, device=dev)
        self.caps = capacities(R, dev)
        self.counts = torch.zeros(max(cfg.max_steps, 1), dtype=torch.int64,
                                  pin_memory=rec.cuda)
        self.events = ([torch.cuda.Event() for _ in range(cfg.max_steps)] if rec.cuda
                       else None)
        self.live = {}
        self.steps_run = []
        self._pieces(_Eager)

    def _pieces(self, make):
        self.head = make(self._head)
        self.steps = {C: make(lambda C=C: self._step(C)) for C in self.caps}
        self.tail = make(self._tail)

    def _head(self):
        st = tr.initial_state(self.ro, self.rd)
        self.rows = {k: torch.cat([v, v[:1]]) for k, v in st.items()}
        self.st = {k: v[:self.R] for k, v in self.rows.items()}

    def _step(self, C):
        f, st, R = self.frame, self.st, self.R
        step = tr.make_step(f.scene, f.textures, self.cfg, f.table)
        if C == R:
            new = step(st)
            for k in tr.STATE_KEYS:
                st[k].copy_(new[k])
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
            new = step(sub)
            for k in tr.STATE_KEYS:
                self.rows[k].index_put_((lane,), new[k])
        self.live[C] = st["alive"].sum()

    def _tail(self):
        self.color = tr.shade_misses(self.frame.scene, self.frame.textures, self.st)

    def warm_up(self):
        """Every piece once, each step at every capacity (before a capture)."""
        self.head.replay()
        for step in self.steps.values():
            step.replay()
        self.tail.replay()

    def capture(self):
        self._pieces(self.rec.capture)

    def _live_after(self, k):
        if self.events is not None:
            self.events[k].synchronize()
        return int(self.counts[k])

    def run(self):
        """Head, steps until no lane lives (seen one step late) or
        ``cfg.max_steps`` ran, each at the least capacity that holds the
        live lanes counted one step late, tail."""
        self.head.replay()
        self.steps_run = []
        for k in range(self.cfg.max_steps):
            live = self.R if k < 2 else self._live_after(k - 2)
            if not live:
                break
            C = min(c for c in self.caps if c >= live)
            self.steps[C].replay()
            self.counts[k].copy_(self.live[C], non_blocking=True)
            if self.events is not None:
                self.events[k].record()
            self.steps_run.append(C)
        self.tail.replay()


class TraceProgram:
    """A fixed-shape trace of ``n`` rays in ``cfg.ray_chunk`` chunks: a head
    piece ``rays(self)`` that sets ``self.ro``, ``self.rd`` [n, 3], one
    ``TraceUnit`` per chunk size, and a tail piece ``finish(self)`` that
    reads the colours ``self.color`` [n, 3] and sets ``self.out``.  The
    chunks' rays and colours move between the units' static buffers by
    copies outside the graphs."""

    def __init__(self, frame, cfg, n, rays, finish, rec):
        self.frame, self.rec = frame, rec
        size = cfg.ray_chunk if cfg.ray_chunk and n > cfg.ray_chunk else n
        self.chunks = [(o, min(size, n - o)) for o in range(0, n, size)] if n else []
        self.units = {R: TraceUnit(frame, cfg, R, rec) for _, R in self.chunks}
        self.color = torch.empty((n, 3), dtype=torch.float32, device=rec.device)
        self._rays, self._finish = rays, finish
        self.pieces = [_Eager(self._head), _Eager(self._tail)]

    def _head(self):
        self._rays(self)

    def _tail(self):
        self._finish(self)

    def capture(self):
        head = self.rec.capture(self._head)
        for unit in self.units.values():
            unit.capture()
        self.pieces = [head, self.rec.capture(self._tail)]

    def run(self, warm_up=False):
        """Head, each chunk's unit (with ``warm_up``, its every piece once),
        tail."""
        head, tail = self.pieces
        head.replay()
        for o, R in self.chunks:
            unit = self.units[R]
            unit.ro.copy_(self.ro[o:o + R])
            unit.rd.copy_(self.rd[o:o + R])
            unit.warm_up() if warm_up else unit.run()
            self.color[o:o + R].copy_(unit.color)
        tail.replay()
