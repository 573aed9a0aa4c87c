"""The lane map of a compacted bounce step (kernels/lane_map.py,
kernels/csrc/lane_map.cu).

On the CPU (tier 1):

* the twins' contract: the live lanes in ascending order, then R as
  fills; each mapped row the state's row of its lane, each fill row row
  R − 1's with ``alive`` off; the scatter writes the new rows at their
  lanes, leaves every other row of the first R untouched, and adds the
  live new rows at non-fill lanes to the count, which ``compact`` gives
  as 0; over R that is and is not a multiple of the kernel's tile, at
  live = 0, 1, a fraction of C and C;
* the wrappers run the twins on CPU tensors, and the kernel launchers
  raise there; every entry raises on a field of the wrong type or shape,
  a non-contiguous field, a lane map or count of the wrong type, and no
  lane or row;
* a profile reads a compact call as both its device kernels.

On the card (marker ``card``; no JAX, so the file runs alone there,
without the CPU suite's conftest:
``python -m pytest --noconftest -m card tests/test_torch_lane_map.py``):

* the library's tile is the one these cases straddle;
* the kernels equal the twins byte for byte (the lane map, every byte of
  the C rows, the first R rows after the scatter, the count) on every
  compacted step of the 1080p demo frame at its real live counts, view
  and ultra (whose edge pass has R = 960,000), and on synthetic states:
  R not a multiple of the block, live = 0, 1 and C;
* ``render_jit``'s 1080p demo frame, view and ultra, is ``render``'s bit
  for bit, and the twins' (the former ATen lane map) bit for bit;
* the captured fit step's first loss and gradients are the twins' bit for
  bit at a fixed pose.
"""

import pytest
import torch

from txr_torch.kernels import lane_map as lm
from txr_torch.kernels import launch_counts, reset_launch_counts
from txr_torch.kernels.step_consume import STATE_KEYS

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)

# the kernel's tile, which the library reports (``lm.tile()``, held to this
# on the card), so that CASES straddle its multiples
TILE = 2048


def _state(n, gen, alive=None, device="cpu"):
    """A bounce state of n rows drawn from ``gen``: float fields with a
    few infinities and NaNs of several payloads, so a copy must move bits."""
    f = lambda *s: torch.randn(*s, generator=gen) * 10.0
    st = dict(ro=f(n, 3), rd=f(n, 3), color=f(n, 3), mask=f(n, 3), absorb_dist=f(n))
    for k in ("ro", "color"):
        v = st[k].view(torch.int32).view(-1)
        v[::97] = 0x7FC00001 + torch.arange(v[::97].numel(), dtype=torch.int32) % 7
        st[k].view(-1)[5::101] = float("inf")
    st["bounces"] = torch.randint(-5, 1 << 20, (n,), generator=gen, dtype=torch.int32)
    st["missed"] = torch.rand(n, generator=gen) < 0.5
    st["alive"] = torch.rand(n, generator=gen) < 0.5 if alive is None else alive
    return {k: st[k].contiguous().to(device) for k in STATE_KEYS}


def _alive(R, live, gen):
    """alive [R] with ``live`` lanes set at random places."""
    a = torch.zeros(R, dtype=torch.bool)
    a[torch.randperm(R, generator=gen)[:live]] = True
    return a


def _bytes(v):
    return v.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    return torch.equal(_bytes(a), _bytes(b))


# (R, C, live): R a multiple of the tile and not, live 0, 1, some, C
CASES = [(3 * TILE, TILE, 700), (3 * TILE + 77, 2048, 2048), (5000, 64, 0), (5000, 64, 1),
         (4097, 4096, 4096), (777, 512, 300), (1, 1, 1), (2, 1, 0)]


@pytest.mark.parametrize("R,C,live", CASES)
def test_twins_contract(R, C, live):
    gen = torch.Generator().manual_seed(R * 31 + C + live)
    st = _state(R, gen, _alive(R, live, gen))
    lane, sub, count = lm.compact_ref(st, C)
    want = torch.nonzero(st["alive"]).squeeze(-1)
    assert lane.dtype == torch.int64 and lane.shape == (C,) and int(count) == 0
    assert torch.equal(lane[:live], want) and bool((lane[live:] == R).all())
    for k in STATE_KEYS:
        assert _same(sub[k][:live], st[k][want]), k
        fill = st[k][R - 1:].repeat((C - live,) + (1,) * (st[k].dim() - 1))
        if k == "alive":
            assert not bool(sub[k][live:].any())
        else:
            assert _same(sub[k][live:], fill), k
    # the scatter: a step's new rows, a few of them dead now
    new = _state(C, gen)
    rows = {k: torch.cat([st[k], st[k][:1]]) for k in STATE_KEYS}
    before = {k: v.clone() for k, v in rows.items()}
    lm.scatter_ref(new, lane, rows, count)
    assert int(count) == int(new["alive"][:live].sum())
    out = torch.ones(R, dtype=torch.bool)
    out[want] = False
    for k in STATE_KEYS:
        assert _same(rows[k][want], new[k][:live]), k
        assert _same(rows[k][:R][out], before[k][:R][out]), k


@pytest.mark.parametrize("R,C,live", CASES[:4])
def test_wrappers_run_the_twins_on_the_cpu(R, C, live):
    gen = torch.Generator().manual_seed(R + live)
    st = _state(R, gen, _alive(R, live, gen))
    got, want = lm.compact(st, C), lm.compact_ref(st, C)
    assert _same(got[0], want[0]) and _same(got[2], want[2])
    assert all(_same(got[1][k], want[1][k]) for k in STATE_KEYS)
    new = _state(C, gen)
    rows = {k: torch.cat([st[k], st[k][-1:]]) for k in STATE_KEYS}
    rows2 = {k: v.clone() for k, v in rows.items()}
    lm.scatter(new, got[0], rows, got[2])
    lm.scatter_ref(new, want[0], rows2, want[2])
    assert int(got[2]) == int(want[2]) and all(_same(rows[k], rows2[k]) for k in STATE_KEYS)


def _args(R=300, C=128):
    gen = torch.Generator().manual_seed(7)
    st = _state(R, gen, _alive(R, 100, gen))
    lane, sub, live = lm.compact_ref(st, C)
    rows = {k: torch.cat([st[k], st[k][:1]]) for k in STATE_KEYS}
    return st, C, _state(C, gen), lane, rows, live


def test_launchers_raise_on_cpu_tensors():
    st, C, new, lane, rows, live = _args()
    before = dict(launch_counts())
    with pytest.raises(ValueError, match="CUDA tensors"):
        lm.launch_compact(st, C)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lm.launch_scatter(new, lane, rows, live)
    assert launch_counts() == before


def _bad_states(st):
    """(what is wrong, the state with it)."""
    n = st["alive"].shape[0]
    yield "alive as uint8", dict(st, alive=st["alive"].to(torch.uint8))
    yield "float64 ro", dict(st, ro=st["ro"].double())
    yield "int64 bounces", dict(st, bounces=st["bounces"].long())
    yield "ro [n, 4]", dict(st, ro=torch.zeros(n, 4))
    yield "a short field", dict(st, missed=st["missed"][1:])
    yield "non-contiguous rd", dict(st, rd=st["rd"].t().contiguous().t())
    yield "non-contiguous absorb", dict(st, absorb_dist=torch.zeros(2 * n)[::2])
    yield "a missing field", {k: v for k, v in st.items() if k != "mask"}


@pytest.mark.parametrize("which", range(8))
def test_wrappers_raise_on_bad_states(which):
    st, C, new, lane, rows, live = _args()
    (what, bad), = [x for i, x in enumerate(_bad_states(st)) if i == which]
    for call in (lambda: lm.compact(bad, C), lambda: lm.launch_compact(bad, C)):
        with pytest.raises(ValueError):
            call()
    (_, bad_new), = [x for i, x in enumerate(_bad_states(new)) if i == which]
    (_, bad_rows), = [x for i, x in enumerate(_bad_states(rows)) if i == which]
    for args in ((bad_new, lane, rows, live), (new, lane, bad_rows, live)):
        for fn in (lm.scatter, lm.launch_scatter):
            with pytest.raises(ValueError):
                fn(*args)


def test_wrappers_raise_on_bad_maps_and_sizes():
    st, C, new, lane, rows, live = _args()
    empty = {k: v[:0] for k, v in st.items()}
    for bad in (lambda: lm.compact(st, 0), lambda: lm.compact(empty, 4)):
        with pytest.raises(ValueError, match="lane_compact"):
            bad()
    for args in ((new, lane.int(), rows, live), (new, lane[:-1], rows, live),
                 (new, torch.zeros(2 * C, dtype=torch.int64)[::2], rows, live),
                 (new, lane, rows, live.int()),
                 (new, lane, rows, torch.zeros(2, dtype=torch.int64)),
                 (new, lane, {k: v[:1] for k, v in rows.items()}, live)):
        for fn in (lm.scatter, lm.launch_scatter):
            with pytest.raises(ValueError, match="lane_scatter"):
                fn(*args)


def test_a_traced_compact_is_both_its_kernels():
    """The profile reads a compact call as its two device kernels: a call
    counts once both are in the trace, and its time is theirs together."""
    from txr_torch.apps.profile_frame import KERNELS, kernel_events

    ev = lambda name, us: (f"(anonymous namespace)::{name}(unsigned char const*, long long)",
                           0.0, us)
    knames = KERNELS["lane_compact"][1]
    events = [ev("lane_count_kernel", 3.0), ev("lane_compact_kernel", 20.0),
              ev("lane_count_kernel", 2.0), ev("lane_compact_kernel", 10.0),
              ev("lane_count_kernel", 4.0), ev("lane_scatter_kernel", 7.0),
              ev("lane_count_kernel_x", 50.0)]
    calls, ms = kernel_events(events, knames)
    assert knames == ("lane_count_kernel", "lane_compact_kernel")
    assert calls == 2 and ms == pytest.approx(0.039)
    assert kernel_events(events, KERNELS["lane_scatter"][1]) == (1, pytest.approx(0.007))


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _kernel_equals_twin_compact(st, C):
    k_lane, k_sub, k_live = lm.launch_compact(st, C)
    t_lane, t_sub, t_live = lm.compact_ref(st, C)
    assert torch.equal(k_lane, t_lane) and int(k_live) == int(t_live) == 0
    for k in STATE_KEYS:
        assert _same(k_sub[k], t_sub[k]), k
    return t_lane, t_live


def _kernel_equals_twin_scatter(new, lane, rows, live):
    R = rows["alive"].shape[0] - 1
    k_rows = {k: v.clone() for k, v in rows.items()}
    t_rows = {k: v.clone() for k, v in rows.items()}
    k_live, t_live = live.clone(), live.clone()
    lm.launch_scatter(new, lane, k_rows, k_live)
    lm.scatter_ref(new, lane, t_rows, t_live)
    assert int(k_live) == int(t_live)
    for k in STATE_KEYS:
        assert _same(k_rows[k][:R], t_rows[k][:R]), k
    return int(k_live)


@pytest.mark.card
def test_the_kernels_tile_is_the_cases(card):
    assert lm.tile() == TILE


@pytest.mark.card
@pytest.mark.parametrize("R,C,live", CASES + [(960_000, 524_288, 400_001),
                                              (2_073_600, 1_048_576, 1_048_576)])
def test_kernels_equal_twins_on_synthetic_states(card, R, C, live):
    gen = torch.Generator().manual_seed(R + C + live)
    st = _state(R, gen, _alive(R, live, gen), card)
    lane, zero = _kernel_equals_twin_compact(st, C)
    new = _state(C, gen, device=card)
    rows = {k: torch.cat([st[k], st[k][:1]]) for k in STATE_KEYS}
    n = _kernel_equals_twin_scatter(new, lane, rows, zero)
    assert n == int(new["alive"][:live].sum())


def _demo(card, width=1920, height=1080, t=60.5):
    from txr_torch.apps import demo as tdemo
    from txr_torch.render.texture import with_mips
    from txr_torch.render.trace import RenderConfig

    scene, handles = tdemo.build_scene(width, height)
    posed = tdemo.update_scene(scene.to(card), handles, 0.0, t)
    cfg = RenderConfig(width=width, height=height, iterations=5, extra_refraction_steps=6)
    return posed, with_mips(tdemo.demo_textures().to(card)), cfg


@pytest.mark.card
@pytest.mark.parametrize("preset", [None, "ultra"])
def test_kernels_equal_twins_on_the_demo_frame(card, monkeypatch, preset):
    """Every compact and scatter call of a render_jit 1080p frame (its
    pieces run eagerly, so each call's inputs can be kept), replayed through
    kernel and twin."""
    from txr_torch.apps.profile_frame import uncaptured
    from txr_torch.render import render as rr

    scene, tex, cfg = _demo(card)
    cfg = cfg.with_aa_preset(preset) if preset else cfg
    calls, compact, scatter = [], lm.compact, lm.scatter

    def keep_compact(st, C):
        calls.append(("compact", {k: v.clone() for k, v in st.items()}, C))
        return compact(st, C)

    def keep_scatter(new, lane, rows, live):
        calls.append(("scatter", {k: v.clone() for k, v in new.items()}, lane.clone(),
                      {k: v.clone() for k, v in rows.items()}, live.clone()))
        return scatter(new, lane, rows, live)

    rr.clear_jit_cache()
    try:
        with uncaptured(), torch.no_grad():
            rr.render_jit(scene, tex, cfg, device=card)     # the warm-up runs every capacity
            monkeypatch.setattr(lm, "compact", keep_compact)
            monkeypatch.setattr(lm, "scatter", keep_scatter)
            rr.render_jit(scene, tex, cfg, device=card)
    finally:
        rr.clear_jit_cache()
    monkeypatch.undo()
    steps = [c for c in calls if c[0] == "compact"]
    Rs = {c[1]["alive"].shape[0] for c in steps}
    assert len(steps) >= 4 and min(c[2] for c in steps) == 16384, [(c[1]["alive"].shape, c[2])
                                                                   for c in steps]
    assert Rs == ({1920 * 1080} if preset is None else {1920 * 1080, 960_000}), Rs
    for call in calls:
        if call[0] == "compact":
            st, C = call[1:]
            assert int(st["alive"].sum()) <= C
            _kernel_equals_twin_compact(st, C)
        else:
            new, lane, rows, live = call[1:]
            assert int(live) == 0
            _kernel_equals_twin_scatter(new, lane, rows, live)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _twins(monkeypatch):
    monkeypatch.setattr(lm, "compact", lm.compact_ref)
    monkeypatch.setattr(lm, "scatter", lm.scatter_ref)


@pytest.mark.card
@pytest.mark.parametrize("preset", [None, "ultra"])
def test_render_jit_of_the_1080p_demo_is_renders(card, monkeypatch, preset):
    from txr_torch.render import render as rr

    scene, tex, cfg = _demo(card)
    cfg = cfg.with_aa_preset(preset) if preset else cfg
    rr.clear_jit_cache()
    reset_launch_counts()
    try:
        with torch.no_grad():
            jit = rr.render_jit(scene, tex, cfg, device=card).clone()
            jit2 = rr.render_jit(scene, tex, cfg, device=card).clone()
            assert launch_counts()["lane_compact"] >= 8
            ref = rr.render(scene, tex, cfg, device=card)
            _twins(monkeypatch)
            rr.clear_jit_cache()
            twin = rr.render_jit(scene, tex, cfg, device=card).clone()
    finally:
        rr.clear_jit_cache()
    assert _bits_equal(jit, ref) and _bits_equal(jit2, ref) and _bits_equal(twin, ref)


@pytest.mark.card
def test_fit_steps_first_gradient_is_the_twins(card, monkeypatch):
    from txr_torch.diff.optimize import _Fit
    from txr_torch.render import render as rr

    scene, tex, cfg = _demo(card, 480, 270)

    def first_step():
        rr.clear_jit_cache()
        fit = _Fit(scene, tex, cfg, torch.zeros((270, 480, 3), device=card), lr=0.0, device=card)
        loss, _ = fit.step(0)
        grads = {p: v.grad.clone() for p, v in fit.params.items() if v.grad is not None}
        fit.close()
        rr.clear_jit_cache()
        return loss.clone(), grads

    reset_launch_counts()
    loss, grads = first_step()
    assert launch_counts()["lane_compact"] > 0
    _twins(monkeypatch)
    t_loss, t_grads = first_step()
    assert _bits_equal(loss, t_loss) and grads.keys() == t_grads.keys() and grads
    for p in grads:
        assert _bits_equal(grads[p], t_grads[p]), p
