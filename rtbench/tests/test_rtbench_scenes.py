"""Configurations that are not the demo, and the reference's batched sweeps.

A static scene of spheres on a floor box (``conftest.spheres_config``: no
textures, handles or animation) runs through ``rtbench/run.py`` on the CPU
with ``correct`` true, and false with its frame broken.  The reference's
nearest-hit, shadow and hit-info passes, batched by primitive type, are bit
for bit the primitive-by-primitive loops they replaced, kept below as the
oracle: frames, gradients and the work model's tallies.
"""

from __future__ import annotations

import json

import pytest
import torch
from conftest import run_cell, spheres_config
from test_rtbench_faults import _altered, _half_rows, run

from rtbench import scenedata, textures
from rtbench.reference import render as ref

# the test cell's limits, from the readings at 96x54 (program against the
# float64 reference; the bfloat16 control): frame_off 0.092 (200 spheres),
# 0.179 (7,381), control 1.0; u8_off 0.0003, 0.0154, control 0.361, 0.440.
# Spheres a pixel or two wide alias, so more pixels sit on a silhouette
# than in the demo's frame.
LIMITS = dict(frame_off=0.5, u8_off=0.04, frame_missing=0.0)


def add_scene(root, n):
    """The n-sphere configuration, its view cell and its limits added to the
    benchmark copy at ``root`` as a later PR adds them: files and manifest
    entries → the cell's name."""
    name, cell = f"spheres-{n}", f"spheres-{n}-view"
    rt = root / "rtbench"
    (rt / "configs" / f"{name}.json").write_text(json.dumps(spheres_config(n)))
    (rt / "limits" / f"{cell}.json").write_text(json.dumps(LIMITS))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name=name, source="a test scene", reduced=[],
                               file=f"rtbench/configs/{name}.json", why="spheres on a floor"))
    man["workloads"].append(dict(name=cell, config=name, traffic="viewer-30fps", chips=1,
                                 why="a test cell"))
    for m in man["end_to_end"]:
        if "demo-1080p-view" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return cell


@pytest.mark.parametrize("n", [200, 7381])
def test_static_scene_runs(bench_copy, n):
    cell = add_scene(bench_copy, n)
    rc, line, err = run_cell(bench_copy, "--workload", cell, "--seed", "3000000101",
                             "--seconds", "1", "--trace", "0", "--size", "96x54", timeout=900)
    assert rc == 0, err[-2000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", ["altered", "half_rows"])
def test_static_scene_fault(bench_copy, capsys, monkeypatch, fault):
    from txr_torch.render import render as rr

    from rtbench import check

    cell = add_scene(bench_copy, 200)
    # this process's rtbench finds the copy's configurations and limits
    for mod in (scenedata, check):
        monkeypatch.setattr(mod, "HERE", str(bench_copy / "rtbench"))
    monkeypatch.setattr(rr, "render_jit",
                        dict(altered=_altered, half_rows=_half_rows)[fault](rr.render_jit))
    line = run(bench_copy, capsys, cell, "96x54")
    assert line["correct"] is False, line["checks"]


# -- the oracle: the reference's primitive-by-primitive loops ---------------------

def _sphere_t(ro, rd, pos, radius, hollow):
    oc = ro - pos
    b = ref.dot(oc, rd)
    c = ref.dot(oc, oc) - radius * radius
    h = b * b - c
    hs = ref.sqrt(h)
    t = -b - hs
    if hollow:
        t = torch.where(t < 0, -b + hs, t)
    return ref._miss(t, (h >= 0) & (t > 0))


@torch.no_grad()
def _torus_t(ro, rd, pos, q, form):
    """One torus against rays [R, 3]."""
    t = torch.full(ro.shape[:-1], ref.INF, dtype=ro.dtype, device=ro.device)
    near = ref.torus_crosses(ro, rd, pos, q, form, ref.TORUS_CULL)
    sel = torch.nonzero(near).squeeze(-1)
    if not sel.numel():
        return t
    cdt = torch.complex128 if ro.dtype == torch.float64 else torch.complex64
    rdt = torch.float64 if ro.dtype == torch.float64 else torch.float32
    c = [x.to(rdt) for x in ref._torus_quartic(ro[sel], rd[sel], pos, q, form)]
    cc = [x.to(cdt) for x in c]
    n = sel.numel()
    z0 = complex(0.4, 0.9)
    roots = [torch.full((n,), v, dtype=cdt, device=ro.device)
             for v in (complex(1.0, 0.0), z0, z0 ** 2, z0 ** 3)]
    done = torch.zeros(n, dtype=torch.bool, device=ro.device)
    for _ in range(60):
        err = torch.zeros(n, dtype=rdt, device=ro.device)
        for i in range(4):
            den = torch.ones_like(roots[i])
            for j in range(4):
                if j != i:
                    den = den * (roots[i] - roots[j])
            den = torch.where(den == 0, torch.full_like(den, 1e-30), den)
            delta = ref._horner(cc, roots[i]) / den
            roots[i] = torch.where(done, roots[i], roots[i] - delta)
            err = torch.maximum(err, torch.maximum(delta.real.abs(), delta.imag.abs()))
        done = done | (err < 1e-3)
        if bool(done.all()):
            break
    best = torch.full((n,), 1e4, dtype=rdt, device=ro.device)
    for z in roots:
        stop = torch.zeros(n, dtype=torch.bool, device=ro.device)
        for _ in range(3):
            fp = ref._horner_d(cc, z)
            stop = stop | (fp.abs() ** 2 < 1e-30)
            z = torch.where(stop, z,
                            z - ref._horner(cc, z) / torch.where(stop, torch.ones_like(fp), fp))
        ok = (z.imag.abs() <= 1e-3) & (z.real >= 0)
        best = torch.where(ok, torch.minimum(best, z.real), best)
    hit = (best > 0) & (best < 100)
    for _ in range(2):
        fp = ref._horner_d(c, best)
        go = hit & (fp.abs() > 1e-6)
        best = torch.where(go, best - ref._horner(c, best)
                           / torch.where(go, fp, torch.ones_like(fp)), best)
    t[sel] = torch.where(hit, best, torch.full_like(best, ref.INF)).to(ro.dtype)
    return t


def _test(S, cfg, kind, i, ro, rd):
    prim = lambda *names: ref._prim(S, kind, i, *names)
    if kind == "planes":
        pos, n = prim("pos", "normal")
        return ref.plane_t(ro, rd, n, pos, cfg.plane_oneside)
    if kind == "spheres":
        pos, r = prim("pos", "radius")
        return _sphere_t(ro, rd, pos, r, S.hollow[kind][i])
    if kind == "surfaces":
        return ref.surface_t(ro, rd, *prim("pos", "quat", "coef", "v_min", "v_max"))
    if kind == "boxes":
        return ref.box_t(ro, rd, *prim("pos", "quat", "form"))
    if kind == "toruses":
        return _torus_t(ro, rd, *prim("pos", "quat", "form"))
    return ref.ring_t(ro, rd, *prim("pos", "quat", "r1", "r2"))


def calc_inter_loop(S, cfg, ro, rd):
    R = ro.shape[0]
    with torch.no_grad():
        tmin = torch.full((R,), ref.MAX_DIST, dtype=ro.dtype, device=ro.device)
        typ = torch.full((R,), -1, dtype=torch.int64, device=ro.device)
        num = torch.zeros(R, dtype=torch.int64, device=ro.device)
        d_ro, d_rd = ro.detach(), rd.detach()
        tests = [(kind, ty, i) for kind, ty in ref.SWEEP for i in range(S.count[kind])]
        tests += [("lights_point", ref.T_LIGHT, i) for i in range(S.count["lights_point"])]
        for kind, ty, i in tests:
            if kind == "lights_point":
                pos, r = ref._prim(S, kind, i, "pos", "radius")
                t = _sphere_t(d_ro, d_rd, pos, r, False)
            else:
                t = _test(S, cfg, kind, i, d_ro, d_rd)
            up = t < tmin
            tmin = torch.where(up, t, tmin)
            typ = torch.where(up, ty, typ)
            num = torch.where(up, i, num)
    if not (torch.is_grad_enabled() and (ro.requires_grad or rd.requires_grad
                                          or any(v.requires_grad for v in S.leaves.values()))):
        return tmin, typ, num
    t = tmin
    for kind, ty, i in tests:
        sel = torch.nonzero((typ == ty) & (num == i)).squeeze(-1)
        if not sel.numel():
            continue
        o, d = ro[sel], rd[sel]
        if kind == "lights_point":
            pos, r = ref._prim(S, kind, i, "pos", "radius")
            tv = _sphere_t(o, d, pos, r, False)
        elif kind == "toruses":
            tv = ref.torus_t_grad(o, d, *ref._prim(S, kind, i, "pos", "quat", "form"), tmin[sel])
        else:
            tv = _test(S, cfg, kind, i, o, d)
        t = t.index_put((sel,), tv)
    return t, typ, num


@torch.no_grad()
def in_shadow_loop(S, T, cfg, ro, rd, dist, tally=None):
    solid = torch.zeros(ro.shape[0], dtype=torch.bool, device=ro.device)
    for kind in ("spheres", "surfaces", "boxes", "toruses"):
        for i in range(S.count[kind]):
            if kind == "spheres":
                pos, r = ref._prim(S, kind, i, "pos", "radius")
                t = _sphere_t(ro, rd, pos, r, False)
            else:
                t = _test(S, cfg, kind, i, ro, rd)
            solid |= t < dist
    if not cfg.plane_oneside:
        for i in range(S.count["planes"]):
            pos, n = ref._prim(S, "planes", i, "pos", "normal")
            solid |= ref.plane_t(ro, rd, n, pos, False) < dist
    shadow = solid.to(ro.dtype)
    keys = [] if tally is not None else None
    for i in range(S.count["rings"]):
        pos, q, r1, r2 = ref._prim(S, "rings", i, "pos", "quat", "r1", "r2")
        t = ref.ring_t(ro, rd, pos, q, r1, r2)
        hit = t < dist
        if S.texture["rings"][i] > 0 and T.ring_alpha is not None:
            sel = torch.nonzero(hit).squeeze(-1)
            if sel.numel():
                u, v = ref.ring_uv(ro[sel], rd[sel], t[sel], pos, q, r1, r2)
                a = ref.trilinear(T.ring_alpha, u, v, None, keys=keys)[..., 3]
                shadow = shadow.index_add(0, sel, a)
        else:
            shadow = torch.maximum(shadow, hit.to(ro.dtype))
    if tally is not None:
        tally.update(solid=solid, ring_keys=keys)
    return torch.clamp(shadow, max=1.0)


def hit_info_loop(S, T, cfg, ro, rd, t, typ, num, pix_angle, keys=None, key_mask=None):
    R = t.shape[0]
    slot = S.slot_of(typ, num)
    mat = {m: v[slot] for m, v in S.mat_table().items()}
    pt = ro + rd * t[..., None]
    normal = torch.zeros_like(ro)
    alpha = torch.ones_like(t)
    textured = torch.zeros(R, dtype=torch.bool, device=t.device)

    def lod(sel, n, texels_per_world):
        if pix_angle is None:
            return None
        return ref.lod_of(ref.footprint(t[sel], ref.dot(rd[sel], n).abs(), pix_angle)
                          * texels_per_world)

    def count_taps(tx, u, v, lv, sel):
        if keys is not None:
            m = key_mask[sel]
            if bool(m.any()):
                ref.trilinear(tx, u[m], v[m], None if lv is None else lv[m], keys)

    def fetch(tx, u, v, lv, sel):
        count_taps(tx, u, v, lv, sel)
        return ref.trilinear(tx, u, v, lv)

    for kind, ty in ref.SWEEP:
        for i in range(S.count[kind]):
            sel = torch.nonzero((typ == ty) & (num == i)).squeeze(-1)
            if not sel.numel():
                continue
            o, d, p, tt = ro[sel], rd[sel], pt[sel], t[sel]
            tex = S.texture[kind][i]
            c = None
            if kind == "spheres":
                pos, radius, q = ref._prim(S, kind, i, "pos", "radius", "quat")
                n = ref.nrm(p - pos)
                if 0 < tex <= len(T.sphere):
                    tx = T.sphere[tex - 1]
                    sn = ref.rot(q, n)
                    pole = (sn[..., 0] == 0) & (sn[..., 2] == 0)
                    sx = torch.where(pole, torch.ones_like(sn[..., 0]), sn[..., 0])
                    u = 0.5 + torch.atan2(sn[..., 2], sx) / (2 * ref.PI)
                    edge = 1.0 - torch.finfo(sn.dtype).eps
                    v = 0.5 - torch.asin(torch.clamp(sn[..., 1], -edge, edge)) / ref.PI
                    H, W = tx.shape0
                    tpw = max(W / (2.0 * ref.PI), H / ref.PI) / torch.clamp(radius, min=1e-6)
                    c = fetch(tx, u, v, lod(sel, n, tpw), sel)
                    alpha = ref._scatter(alpha, sel, c[..., 3])
            elif kind == "planes":
                n = ref.nrm(S["planes.normal"][i]).expand(p.shape)
            elif kind == "surfaces":
                pos, q, coef = ref._prim(S, kind, i, "pos", "quat", "coef")
                n = ref.surface_normal(o, d, tt, pos, q, coef)
            elif kind == "boxes":
                pos, q, form = ref._prim(S, kind, i, "pos", "quat", "form")
                n = ref.box_normal(o, d, pos, q, form)
                if tex > 0 and T.box is not None:
                    bp, pp, nn = ref.rot(q, pos.expand(p.shape)), ref.rot(q, p), ref.rot(q, n)
                    H, W = T.box.shape0
                    lv = lod(sel, n, 0.5 * max(H, W))
                    rel = pp - bp
                    fu = 0.5 * torch.stack([rel[..., 2], rel[..., 2], rel[..., 0]], -1) - 0.5
                    fv = 0.5 * torch.stack([rel[..., 1], rel[..., 0], rel[..., 1]], -1) - 0.5
                    c = sum(nn[..., k:k + 1].abs()
                            * ref.trilinear(T.box, fu[..., k], fv[..., k], lv) for k in range(3))
                    dom = nn.abs().argmax(-1, keepdim=True)
                    count_taps(T.box, fu.gather(-1, dom)[..., 0], fv.gather(-1, dom)[..., 0],
                               lv, sel)
            elif kind == "toruses":
                pos, q, form = ref._prim(S, kind, i, "pos", "quat", "form")
                n = ref.torus_normal(o, d, tt, pos, q, form)
            else:
                pos, q, r1, r2 = ref._prim(S, kind, i, "pos", "quat", "r1", "r2")
                zdir = torch.tensor([0.0, 0.0, -1.0], dtype=p.dtype, device=p.device)
                n = ref.rot(ref.qinv(q), zdir.expand(p.shape))
                if tex > 0 and T.ring is not None:
                    u, v = ref.ring_uv(o, d, tt, pos, q, r1, r2)
                    H, W = T.ring.shape0
                    rm = ref.sqrt(torch.clamp(0.5 * (r1 + r2), min=1e-12))
                    tpw = torch.maximum(W * 2.0 * rm / torch.clamp(r2 - r1, min=1e-12),
                                        H / (ref.PI * rm))
                    c = fetch(T.ring, u, v, lod(sel, n, tpw), sel)
                    alpha = ref._scatter(alpha, sel, c[..., 3])
            if c is not None:
                mat["color"] = ref._scatter(mat["color"], sel, c[..., :3])
                textured[sel] = True
            normal = ref._scatter(normal, sel, n)
    bias = (9e-3 * ref.sqrt(ref.dot(pt - ro, pt - ro)) + 35.0) / 35e3
    return mat, normal, bias, alpha, textured


def _loops(monkeypatch):
    monkeypatch.setattr(ref, "calc_inter", calc_inter_loop)
    monkeypatch.setattr(ref, "in_shadow", in_shadow_loop)
    monkeypatch.setattr(ref, "hit_info", hit_info_loop)


def _bits(x):
    """Tensors as their bits (so NaNs and signed zeros compare too),
    recursively through dicts and lists."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[x.element_size()])
        return x.tolist()
    return x


def _config(name):
    if name.startswith("spheres-"):
        return spheres_config(int(name.split("-")[1]))
    return scenedata.load_config(name)


def _frame(cfg, raw, W, H, t=60.45):
    tally = []
    with torch.no_grad():
        img = ref.render(ref.Scene(cfg, t), ref.Textures(cfg, raw), ref.settings(cfg, W, H),
                         tally=tally)
    return img, tally


@pytest.mark.parametrize("name,size", [("demo-1080p", (64, 36)), ("demo-1080p-ultra", (64, 36)),
                                       ("spheres-7381", (64, 36))])
def test_batched_frame_is_the_loop(monkeypatch, name, size):
    torch.set_num_threads(2)
    cfg = _config(name)
    raw = textures.make(cfg, 41, torch.device("cpu"))
    got = _frame(cfg, raw, *size)
    _loops(monkeypatch)
    want = _frame(cfg, raw, *size)
    assert _bits(got) == _bits(want)


def test_batched_gradient_is_the_loop(monkeypatch):
    torch.set_num_threads(2)
    cfg = scenedata.load_config("demo-1080p")
    raw = textures.make(cfg, 42, torch.device("cpu"))

    def grad():
        S = ref.Scene(cfg, 60.45, requires_grad=True)
        return ref.loss_and_grad(S, ref.Textures(cfg, raw), ref.settings(cfg, 48, 27))

    got = grad()
    _loops(monkeypatch)
    want = grad()
    assert _bits(got) == _bits(want)


def test_ties_across_blocks_go_to_the_first_slot(monkeypatch):
    """Every sphere twice, the copy 200 slots later in another colour, and
    blocks of 64 primitives: an exact tie within a block and across blocks
    goes to the first slot, as the loop's strict ``<`` gives."""
    torch.set_num_threads(2)
    cfg = spheres_config(200)
    sc = cfg["scene"]
    sc["spheres"] += [dict(s, name=s["name"] + "b", mat=dict(s["mat"], color=[1.0, 0.0, 0.0]))
                      for s in sc["spheres"]]
    monkeypatch.setattr(ref, "PAIR_BLOCK", 64)
    got = _frame(cfg, {}, 16, 9)
    # no copy ever wins: the frame is the frame without them
    assert _bits(got[0]) == _bits(_frame(spheres_config(200), {}, 16, 9)[0])
    _loops(monkeypatch)
    want = _frame(cfg, {}, 16, 9)
    assert _bits(got) == _bits(want)
