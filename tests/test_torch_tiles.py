"""A scene table larger than a block's shared memory: the kernels sweep it in
tiles of its slot records (``csrc/txr_common.cuh``: ``plan_stage``,
``Span``), in slot order with the whole sweep's strict ``<``.

On the CPU (tier 1):

* the twins' sweeps test spheres in blocks (``scene_table.SPHERE_BLOCK``):
  the nearest hit and the occlusion bit of a block sweep are those of one
  sphere at a time, bit for bit, ties to the first slot within a block and
  across blocks, hollow spheres from inside;
* the launchers' ctypes argument lists are their libraries' C signatures,
  argument for argument (the tile arguments they gained).

On the card (marker ``card``; no JAX, so the file runs alone there:
``python -m pytest --noconftest -m card tests/test_torch_tiles.py``):

* the demo's table, which fits a block, is staged whole (1 tile a launch);
* with tiles forced smaller than the demo's table (smaller than a record,
  a few records, one tile of it all), the step probe writes the whole-table
  launch's rows bit for bit, every element, over rows set to NaN
  beforehand, with and without fill rows, both shading variants, with a
  lane mask; the nearest-hit and shadow-sweep kernels their outputs;
* the tiles stage each sphere as one (centre, r²) record
  (``txr_common.cuh: tile_layout``): forced tiles that cut the sphere
  section mid-way and mid-record, that hold a single sphere or none, on
  rays that start inside the demo's hollow spheres, and a shadow sweep
  whose only occluder is the one sphere of the last tile, give the
  whole-table launch's outputs bit for bit;
* the tiled probe's shadow pass takes a shading lane's lights in groups
  (``csrc/step_probe.cu: Lights``, ``txr_common.cuh: occluded_group_span``):
  with 1, 2, 3, G, G + 1 and 2G + 1 lights, point and directional, rings,
  two-sided planes, a box, a quadric and a torus, its rows are the
  whole-table launch's bit for bit; and one lane's lights occluded in
  different tiles, one light by nothing, give the whole-table rows.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from txr_torch.kernels import primitives as prim
from txr_torch.kernels import scene_table
from txr_torch.kernels import step_probe as sp
from txr_torch.kernels.primitives import INF_T
from txr_torch.scene.factories import SceneBuilder

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)


def _spheres_scene(n, seed=0):
    """n spheres in a 10-unit cube, some hollow, with copies at block
    edges (exact ties), a box and a point light."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(camera_pos=(0.0, 0.0, -20.0))
    b.add_light_point((0.0, 30.0, 0.0), (1.0, 1.0, 1.0), 1.0)
    m = b.material((0.5, 0.5, 0.5))
    pos = rng.uniform(-5.0, 5.0, (n, 3))
    rad = rng.uniform(0.05, 0.6, n)
    B = scene_table.SPHERE_BLOCK
    for i, j in ((11, 10), (B, B - 1), (B + 5, 3), (2 * B + 1, B)):
        if i < n:
            pos[i], rad[i] = pos[j], rad[j]
    for k in range(n):
        b.add_sphere(tuple(pos[k]), float(rad[k]), m, hollow=bool(k % 7 == 0))
    b.add_box((0.0, -6.0, 0.0), (8.0, 0.1, 8.0), m)
    return b.build()


def _rays(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    ro = (torch.rand(n, 3, generator=g) - 0.5) * 14.0
    rd = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    return ro.contiguous(), rd.contiguous()


def test_block_sweeps_are_the_slot_by_slot_sweeps():
    scene = _spheres_scene(2 * scene_table.SPHERE_BLOCK + 40)
    buf, hdr = scene_table.pack_scene(scene, None)
    cnt, sec = scene_table.sections(buf, hdr)
    ro, rd = _rays(3000)
    o3, d3 = ro.unbind(-1), rd.unbind(-1)
    # one sphere at a time, as the sweep read before it took blocks
    SP = sec["spheres"]
    tmin = torch.full((ro.shape[0],), INF_T)
    slot = torch.zeros(ro.shape[0], dtype=torch.int64)
    solid = torch.zeros(ro.shape[0], dtype=torch.bool)
    dist = torch.full((ro.shape[0],), 6.0)
    for i in range(cnt["spheres"]):
        t, hit = prim._sphere_test(SP[i, 0], SP[i, 1], SP[i, 2], SP[i, 3], SP[i, 4] != 0, o3, d3)
        upd = hit & (t < tmin)
        tmin, slot = torch.where(upd, t, tmin), torch.where(upd, i, slot)
        t, hit = prim._sphere_test(SP[i, 0], SP[i, 1], SP[i, 2], SP[i, 3], None, o3, d3)
        solid |= hit & (t < dist)
    # the box and the light's bulb are swept after the spheres (slot order)
    rest = list(scene_table.slot_tests(cnt, sec, o3, d3, True))[cnt["spheres"]:]
    for s, (t, hit) in enumerate(rest, cnt["spheres"]):
        upd = hit & (t < tmin)
        tmin, slot = torch.where(upd, t, tmin), torch.where(upd, s, slot)
    got_t, got_slot = scene_table.sweep_ref(cnt, sec, o3, d3, True)
    assert torch.equal(got_t.view(torch.int32), tmin.view(torch.int32))
    assert torch.equal(got_slot, slot)
    # the copies tie exactly: the first of each pair wins wherever both are hit
    assert not torch.isin(got_slot, torch.tensor([11, scene_table.SPHERE_BLOCK])).any()
    assert int((got_slot < cnt["spheres"]).sum()) > 100
    box_t, box_hit = prim._box_test(sec["boxes"][:, 0:3], sec["boxes"][:, 3:7],
                                    sec["boxes"][:, 7:10], 0, o3, d3)
    want_solid = solid | (box_hit & (box_t < dist))
    got_solid, _ = scene_table.occlusion_ref(cnt, sec, o3, d3, dist, True)
    assert torch.equal(got_solid, torch.where(want_solid, 1.0, 0.0))
    assert 0 < int(want_solid.sum()) < ro.shape[0]


_CTYPES = {"float": ctypes.c_float, "int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", ["step_probe", "nearest_hit", "shadow_sweep"])
def test_launcher_args_are_the_c_signature(name):
    import importlib

    mod = importlib.import_module(f"txr_torch.kernels.{name}")
    path = os.path.join(os.path.dirname(mod.__file__), "csrc", f"{name}.cu")
    with open(path) as f:
        src = f.read()
    (params,) = re.findall(rf'extern "C" int txr_{name}\(([^)]*)\)', src)
    want = []
    for p in params.split(","):
        p = " ".join(p.split())
        if "*" in p:
            want.append(ctypes.c_void_p)
        else:
            want.append(_CTYPES[p.rsplit(" ", 1)[0].replace("const ", "")])
    assert mod._ARGS == want


# ---- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


NAN_BITS = 0x7FC00000


def _probe_into_nan(buf, hdr, ro, rd, pix, alive, tile):
    """The probe launched with ``tile`` (0: as planned) into rows set to NaN
    beforehand → (f, i, tiles a sweep, 1 where its shadow pass took lights
    in groups)."""
    from txr_torch.kernels import build

    N = ro.shape[0]
    f = torch.full((sp.n_rows(scene_table.counts_of(hdr)), N), float("nan"), device=ro.device)
    i = torch.full((3, N), NAN_BITS, dtype=torch.int32, device=ro.device)
    tiles, grouped = ctypes.c_int(0), ctypes.c_int(0)
    build.run("step_probe", "txr_step_probe", sp._ARGS, ro.device, hdr, buf.data_ptr(),
              float(pix), ro.data_ptr(), rd.data_ptr(),
              None if alive is None else alive.view(torch.uint8).data_ptr(), f.data_ptr(),
              i.data_ptr(), N, int(tile), ctypes.addressof(tiles), ctypes.addressof(grouped))
    return f, i, tiles.value, grouped.value


def _demo_rays(card, n_random=1 << 16):
    """The demo's primary rays at 480×270 at t = 60.5 s, rays from 2 away
    at its point light's bulb, and random rays; a lane mask of about 70 %."""
    from txr_torch.apps import demo as tdemo
    from txr_torch.render.raygen import primary_rays
    from txr_torch.render.texture import with_mips

    scene, handles = tdemo.build_scene(480, 270)
    posed = tdemo.update_scene(scene.to(card), handles, 0.0, 60.5)
    tex = with_mips(tdemo.demo_textures().to(card))
    buf, hdr = scene_table.pack_scene(posed, tex.atlas)
    _, sec = scene_table.sections(buf, hdr)
    ro, rd = primary_rays(posed.camera, 480, 270, 1)
    g = torch.Generator(device=card).manual_seed(3)
    bulb = torch.tensor(sec["lights_point"][0, 0:3].copy(), device=card)
    at = bulb + torch.nn.functional.normalize(
        torch.randn(4096, 3, generator=g, device=card), dim=-1) * 2.0
    o = (torch.rand(n_random, 3, generator=g, device=card) - 0.5) * 30.0
    d = torch.nn.functional.normalize(torch.randn(n_random, 3, generator=g, device=card), dim=-1)
    ro = torch.cat([ro, at, o]).contiguous()
    rd = torch.cat([rd, torch.nn.functional.normalize(bulb - at, dim=-1), d]).contiguous()
    alive = (torch.rand(ro.shape[0], generator=g, device=card) < 0.7).contiguous()
    return buf, hdr, ro, rd, alive


def _bits(v):
    return v.contiguous().view(torch.int32)


def _tile_layout(hdr):
    """The kernels' tile layout (``csrc/txr_common.cuh: tile_layout``):
    each slot type's first float, and the slot records' length."""
    o_su, o_ld = hdr[12], hdr[17]
    sp = (6 * hdr[0] + 3) & ~3
    su = sp + 4 * hdr[1]
    return [0, sp, su] + [su + hdr[10 + j] - o_su for j in range(3, 7)], su + o_ld - o_su


def _all_kernels(buf, hdr, ro, rd, dist, pix, alive, tile):
    """The probe (into rows set to NaN), nearest-hit and shadow-sweep
    launches with ``tile`` → (their outputs, floats as int32 bits; the
    probe's tiles a sweep)."""
    from txr_torch.kernels import nearest_hit as nh
    from txr_torch.kernels import shadow_sweep as ss

    f, i, n, _ = _probe_into_nan(buf, hdr, ro, rd, pix, alive, tile)
    t, s = nh.launch(buf, hdr, ro, rd, alive, tile=tile)
    k = ss.launch(buf, hdr, ro, rd, dist, alive, tile=tile)
    out = [_bits(f), i, _bits(t), s, _bits(k[0])]
    if k[1] is not None:
        out += [k[1], _bits(k[2])]
    return out, n


@pytest.mark.card
@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("shade_flipped", [True, False])
def test_tiled_probe_is_the_whole_tables(card, fill, shade_flipped):
    buf, hdr, ro, rd, alive = _demo_rays(card)
    hdr = scene_table.set_flags(hdr, shade_flipped=shade_flipped, fill=fill)
    pix = 1.0 / 1080.0
    f0, i0, n0, g0 = _probe_into_nan(buf, hdr, ro, rd, pix, alive, 0)
    assert (n0, g0) == (1, 0)             # the demo's table fits a block
    hit = alive & (f0[0] < 1e30)
    assert int(hit.sum()) > 10000 and int((alive & ~hit).sum()) > 10000
    _, n_rec = _tile_layout(hdr)
    for tile in (5, 16, 64, n_rec):
        f, i, n, g = _probe_into_nan(buf, hdr, ro, rd, pix, alive, tile)
        assert n == -(-n_rec // tile) and g == 1
        assert torch.equal(_bits(f), _bits(f0)), tile
        assert torch.equal(i, i0), tile


@pytest.mark.card
def test_tiled_eager_kernels_are_the_whole_tables(card):
    from txr_torch.kernels import nearest_hit as nh
    from txr_torch.kernels import shadow_sweep as ss

    buf, hdr, ro, rd, alive = _demo_rays(card)
    dist = torch.rand(ro.shape[0], device=card) * 40.0
    t0, s0 = nh.launch(buf, hdr, ro, rd, alive)
    k0 = ss.launch(buf, hdr, ro, rd, dist, alive)
    assert int((t0 < 1e30).sum()) > 10000 and int((k0[0] > 0).sum()) > 1000
    for tile in (5, 16, 64, _tile_layout(hdr)[1]):
        t, s = nh.launch(buf, hdr, ro, rd, alive, tile=tile)
        assert torch.equal(_bits(t), _bits(t0)) and torch.equal(s, s0), tile
        k = ss.launch(buf, hdr, ro, rd, dist, alive, tile=tile)
        assert torch.equal(k[0], k0[0]), tile
        assert torch.equal(k[1], k0[1]) and torch.equal(_bits(k[2]), _bits(k0[2])), tile


@pytest.mark.card
def test_packed_sphere_tiles_are_the_whole_tables(card):
    """Tiles of the tile layout, whose spheres are (centre, ±r²) records,
    against the whole-table launch, on the demo's rays and rays from inside
    its hollow spheres (the far root, taken only where the line meets the
    sphere)."""
    buf, hdr, ro, rd, alive = _demo_rays(card)
    _, sec = scene_table.sections(buf, hdr)
    spheres = torch.as_tensor(sec["spheres"].copy(), device=card)
    hollow = spheres[spheres[:, 4] != 0]
    assert hollow.shape[0] >= 1
    g = torch.Generator(device=card).manual_seed(5)
    m = 8192
    pick = torch.randint(0, hollow.shape[0], (m,), generator=g, device=card)
    d = torch.nn.functional.normalize(torch.randn(m, 3, generator=g, device=card), dim=-1)
    o = hollow[pick, 0:3] + d.roll(1, 0) * hollow[pick, 3:4] * 0.9
    ro = torch.cat([ro, o]).contiguous()
    rd = torch.cat([rd, d]).contiguous()
    alive = torch.cat([alive, torch.ones(m, dtype=torch.bool, device=card)]).contiguous()
    dist = torch.rand(ro.shape[0], generator=g, device=card) * 40.0
    pix = 1.0 / 1080.0
    off, n_rec = _tile_layout(hdr)
    s0, s1 = off[1], off[2]                 # the sphere section: 4 floats a sphere
    assert s1 - s0 == 4 * spheres.shape[0] and s0 % 4 == 0
    want, n0 = _all_kernels(buf, hdr, ro, rd, dist, pix, alive, 0)
    assert n0 == 1
    # the inner lanes hit a hollow sphere from inside, at its far root
    slot = want[3][-m:]
    inner = torch.isin(slot, torch.nonzero(spheres[:, 4] != 0).flatten().to(slot) + hdr[0])
    assert int(inner.sum()) > m // 2
    cases = {
        "one sphere a tile": 4,             # then tiles of no sphere after the section
        "mid-record cuts": s0 + 10,         # boundaries inside a sphere's record
        "mid-section cut": s0 + 4 * (spheres.shape[0] // 2) + 2,
        "the section alone": s1 - s0,
        "one float a tile": 1,              # most tiles hold no record at all
    }
    for what, tile in cases.items():
        got, n = _all_kernels(buf, hdr, ro, rd, dist, pix, alive, tile)
        assert n == -(-n_rec // tile), what
        for j, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (what, j)


@pytest.mark.card
def test_occluder_in_the_last_tile(card):
    """A shadow sweep toward a light whose only occluder is the one sphere
    of the last tile: rays from the floor under it toward the light; and
    the probe's shading of primary rays that hit that floor under three
    lights: that light, one that the first tile's first sphere occludes
    from the same floor, and one that nothing occludes."""
    from txr_torch.kernels import shadow_sweep as ss

    n_sp = 64
    b = SceneBuilder(camera_pos=(0.0, 0.5, -8.0))
    b.add_light_point((0.0, 10.0, 0.0), (1.0, 1.0, 1.0), 1.0)
    b.add_light_point((12.0, 10.0, 0.0), (1.0, 1.0, 1.0), 1.0)
    b.add_light_point((0.0, 0.5, -30.0), (1.0, 1.0, 1.0), 1.0)
    mat = b.material((0.5, 0.5, 0.5))
    # the second light's occluder, first: on its line from the floor's middle,
    # out of the first light's rays from the floor
    b.add_sphere((4.8, 3.46, 0.0), 1.0, mat)
    for k in range(n_sp - 2):                # far off to the side: no shadow on the floor
        b.add_sphere((30.0 + 0.5 * k, 5.0, 30.0), 0.2, mat, hollow=bool(k % 5 == 0))
    b.add_sphere((0.0, 2.0, 0.0), 1.0, mat)  # the first light's occluder, last
    b.add_box((0.0, -1.0, 0.0), (10.0, 0.1, 10.0), mat)
    buf, hdr = scene_table.pack_scene(b.build().to(card), None)
    off, n_rec = _tile_layout(hdr)
    tile = off[1] + 4 * (n_sp - 1)          # the last tile starts at the last sphere
    assert -(-n_rec // tile) == 2
    g = torch.Generator(device=card).manual_seed(7)
    m = 1 << 15
    at = (torch.rand(m, 3, generator=g, device=card) - 0.5) * 6.0
    at[:, 1] = -0.9 + 1e-3                  # just above the floor's top
    light = torch.tensor([0.0, 10.0, 0.0], device=card)
    to = light - at
    dist = to.norm(dim=-1).contiguous()
    sd = (to / dist[:, None]).contiguous()
    want = ss.launch(buf, hdr, at.contiguous(), sd, dist)
    got = ss.launch(buf, hdr, at.contiguous(), sd, dist, tile=tile)
    twin = ss.shadow_sweep_ref(buf, hdr, at.contiguous(), sd, dist)
    assert torch.equal(got[0], want[0]) and torch.equal(got[0], twin[0])
    assert m // 50 < int(got[0].sum()) < m - m // 50
    # primary rays from beside the occluders down to the same floor
    ro = torch.cat([(torch.rand(m, 1, generator=g, device=card) - 0.5) * 6.0,
                    torch.full((m, 1), 0.5, device=card), torch.full((m, 1), -8.0, device=card)],
                   dim=1)
    rd = torch.nn.functional.normalize(at - ro, dim=-1).contiguous()
    ro = ro.contiguous()
    f0, i0, n0, g0 = _probe_into_nan(buf, hdr, ro, rd, 0.0, None, 0)
    f, i, n, g1 = _probe_into_nan(buf, hdr, ro, rd, 0.0, None, tile)
    assert (n0, n, g0, g1) == (1, 2, 0, 1)
    assert torch.equal(_bits(f), _bits(f0)) and torch.equal(i, i0)
    box = i0[0] == n_sp                     # the floor's slot, after the spheres
    first, second, third = (f0[23 + 3 * j + 2][box] > 0 for j in range(3))  # solid rows
    n_box = int(box.sum())
    assert n_box > m // 2 and m // 50 < int(first.sum()) < n_box
    # lanes whose first light the last tile occludes and second the first tile
    assert int((first & second).sum()) > m // 50 and int((second & ~first).sum()) > m // 50
    assert not third.any()


def _group_size():
    """The lights a thread of the tiled probe's shadow pass takes at once
    (``csrc/step_probe.cu: kGroup``)."""
    path = os.path.join(os.path.dirname(sp.__file__), "csrc", "step_probe.cu")
    with open(path) as f:
        (g,) = re.findall(r"constexpr int kGroup = (\d+);", f.read())
    return int(g)


def _lit_scene(n_lights, seed=11):
    """Spheres (some hollow), two planes, a box, a quadric, a torus and two
    rings, with n_lights lights: point and directional in turn, so a group
    of lights holds both kinds."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(camera_pos=(0.0, 1.0, -14.0))
    m = b.material((0.6, 0.5, 0.4), specular=20)
    for k in range(40):
        b.add_sphere(tuple(rng.uniform(-4.0, 4.0, 3)), float(rng.uniform(0.2, 0.8)), m,
                     hollow=bool(k % 6 == 0))
    b.add_plane((0.0, 1.0, 0.0), (0.0, -4.5, 0.0), m)
    b.add_plane((0.96, 0.0, 0.28), (-6.0, 0.0, 0.0), m)
    b.add_box((2.0, -3.0, 2.0), (1.5, 0.4, 1.0), m)
    b.add_surface((1.0, 1.0, 4.0, 0.0, 0.0, -1.0), m, pos=(-2.5, -2.0, -2.0))
    b.add_torus((-2.0, 0.5, 3.0), (1.2, 0.3), m)
    b.add_ring((0.0, 2.0, 1.0), 0.8, 2.0, m, quat=(0.3826834, 0.0, 0.0, 0.9238795))
    b.add_ring((3.0, 1.0, -1.0), 0.5, 1.5, m)
    for j in range(n_lights):
        # above the floor and on the lit side of the other plane, so a light
        # behind neither occludes every lane; lanes under the floor see the
        # floor occlude it (two-sided)
        u = np.zeros(3)
        while u @ (0.96, 0.0, 0.28) < 0.2:
            u = rng.normal(size=3)
            u[1] = abs(u[1]) + 0.5
            u /= np.linalg.norm(u)
        if j % 2 == 0:
            b.add_light_point(tuple(u * 12.0), (1.0, 1.0, 1.0), 1.0)
        else:
            b.add_light_direct(tuple(-u), (1.0, 1.0, 1.0), 0.7)
    return b.build()


@pytest.mark.card
@pytest.mark.parametrize("groups,extra", [(0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (2, 1)])
def test_grouped_lights_are_the_whole_tables(card, groups, extra):
    """The tiled probe, whose shadow pass takes a shading lane's lights in
    groups, against the whole-table probe, whose pairs take one light each:
    every row bit for bit (base rows, each light's diffuse, specular and
    solid rows, each ring's hit and uv), into rows set to NaN beforehand,
    with 1, 2, 3, G, G + 1 and 2G + 1 lights (G the group size), two-sided
    planes, with and without fill rows, both shading variants, a lane mask,
    and tiles that cut the table mid-record and in halves."""
    n_lights = groups * _group_size() + extra
    scene = _lit_scene(n_lights).to(card)
    buf, hdr0 = scene_table.pack_scene(scene, None)
    ro, rd = _rays(1 << 16, seed=4)
    ro, rd = ro.to(card).contiguous(), rd.to(card).contiguous()
    alive = (torch.rand(ro.shape[0], generator=torch.Generator().manual_seed(6)) < 0.8).to(card)
    _, n_rec = _tile_layout(hdr0)
    counts = scene.counts
    nr = counts["rings"]
    for fill in (True, False):
        for flipped in (True, False):
            hdr = scene_table.set_flags(hdr0, one_side=False, shade_flipped=flipped, fill=fill)
            f0, i0, n0, g0 = _probe_into_nan(buf, hdr, ro, rd, 0.0, alive, 0)
            assert (n0, g0) == (1, 0)
            for tile in (17, -(-n_rec // 2)):
                f, i, n, g = _probe_into_nan(buf, hdr, ro, rd, 0.0, alive, tile)
                assert n == -(-n_rec // tile) and g == 1, tile
                assert torch.equal(_bits(f), _bits(f0)), (fill, flipped, tile)
                assert torch.equal(i, i0), (fill, flipped, tile)
    # the shadows and rings the comparison covered
    lights = f0[23:].reshape(n_lights, 3 + 3 * nr, -1)
    shading = alive & (f0[0] < 1e30) & (i0[0] < sum(counts[k] for k in sp.SLOT_ORDER)
                                        - counts["lights_point"])
    solid = lights[:, 2][:, shading] > 0
    assert int(shading.sum()) > 5000
    assert ((solid.sum(1) > 50) & (solid.sum(1) < int(shading.sum()) - 50)).all()
    assert int((lights[:, 3::3][:, :, shading] > 0).sum()) > 50
