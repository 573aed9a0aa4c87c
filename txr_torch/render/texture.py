"""Texture and environment sampling (txr/render/texture.py).

Semantics kept from the JAX package: RGBA8 quantisation of every stored
level, the integer-exact 2×2 mip pyramid, trilinear sampling at the
ray-footprint LOD with the ``BLOCK_LOD_EPS`` clamp, GL_REPEAT wrap for scene
textures and clamp-to-edge for the cubemap (level 0 only).  The storage is
plain: one flat f32 texel table holding every level of every 2D texture,
addressed per ray by (slot, level) offsets.  The JAX package's u8 word
packing and one-gather block layout are gather-count tricks for the TPU and
store the same values.
"""

from __future__ import annotations

import dataclasses

import torch

from txr_torch import resolve_device
from txr_torch.geometry import quaternion as quat
from txr_torch.utils.index import take

_PI = 3.14159265358979  # PI_F, rt.frag:5

MIP_MIN_SIZE = 4   # stop the pyramid when a side would shrink below this
# trilinear lod is clamped to L-1-eps (the f64 oracle applies the same clamp)
BLOCK_LOD_EPS = 1.0 / 1024.0


@dataclasses.dataclass
class SceneAtlas:
    """Every 2D scene texture's mip pyramid in one flat table.  Slot map as
    the JAX SceneAtlas: sphere texture n in slot n−1, then the box texture,
    then the ring texture."""

    texels: torch.Tensor     # [T, 4] f32, every level row-major, level 0 first
    offset: torch.Tensor     # [n_tex, Lmax] int64: first texel of each level
    h0: torch.Tensor         # [n_tex] int64 level-0 height
    w0: torch.Tensor         # [n_tex] int64 level-0 width
    levels: torch.Tensor     # [n_tex] int64 pyramid depth
    dims: tuple              # ((H0, W0), ...) per slot, host-side
    n_sphere: int
    box_slot: object = None
    ring_slot: object = None

    def to(self, device):
        return dataclasses.replace(
            self, texels=self.texels.to(device), offset=self.offset.to(device),
            h0=self.h0.to(device), w0=self.w0.to(device), levels=self.levels.to(device))


@dataclasses.dataclass
class TextureSet:
    """Raw textures and the sampling tables ``with_mips`` derives from them.

    sphere:  tuple of [H,W,4] f32; a sphere's ``texture`` n selects sphere[n-1].
    ring, box: [H,W,4] or None.
    cubemap: [6,S,S,4] or None, faces (+x,-x,+y,-y,+z,-z).
    atlas:   SceneAtlas over sphere, box and ring textures (with_mips).
    cube:    [6,S,S,4] quantised cubemap faces (with_mips).
    ring_alpha: [H,W] quantised level-0 ring alpha for the shadow attenuation
             fetch (with_mips).
    """

    sphere: tuple = ()
    ring: object = None
    box: object = None
    cubemap: object = None
    atlas: object = None
    cube: object = None
    ring_alpha: object = None

    def to(self, device):
        mv = lambda a: None if a is None else a.to(device)
        return TextureSet(sphere=tuple(s.to(device) for s in self.sphere),
                          ring=mv(self.ring), box=mv(self.box), cubemap=mv(self.cubemap),
                          atlas=mv(self.atlas), cube=mv(self.cube),
                          ring_alpha=mv(self.ring_alpha))


def _unit(codes):
    """Integer u8 codes k → k/255 in float32, correctly rounded, by a
    256-entry table.  Not ``codes / 255.0``: PyTorch's CUDA kernel divides
    by a scalar as a product with its reciprocal, which lands some k/255 one
    ulp off, so the card's texels would not be the CPU's (or the JAX
    package's).  The table's float64 quotients are within 2⁻⁵² of k/255,
    far closer than any float32 rounding tie (k/255 repeats k's 8 bits)."""
    lut = (torch.arange(256, dtype=torch.float64, device=codes.device) / 255.0).float()
    return lut[codes.long()]


def quantize_u8(x):
    """RGBA8 storage quantisation: values become exactly k/255 in f32, with
    a straight-through gradient so texture contents stay optimisable
    (texture.py:161-169).  x + (q − x) rounds to q exactly: the two are
    within 1/510 of each other, so q − x is exact (Sterbenz)."""
    q = _unit(torch.round(torch.clamp(x.detach(), 0.0, 1.0) * 255.0))
    return x + (q - x.detach())


def mip_down_u8(a, b, c, d):
    """Integer-exact RGBA8 2×2 box downsample, (a+b+c+d+2) >> 2 on the u8
    codes — the only tie-proof formula (texture.py:172-184).  No gradient:
    ``_mip_levels`` routes it through the float mean."""
    si = sum(torch.round(x.detach() * 255.0).to(torch.int32) for x in (a, b, c, d))
    return _unit((si + 2) >> 2)


def _mip_levels(tex):
    """Quantised 2×2 box pyramid; stops when a side would drop below
    MIP_MIN_SIZE or become odd.  Forward: the integer-exact level; backward:
    the float mean of the four texels (straight-through, texture.py:198-203)."""
    levels = [quantize_u8(tex)]
    while True:
        t = levels[-1]
        H, W = t.shape[0], t.shape[1]
        if H % 2 or W % 2 or H // 2 < MIP_MIN_SIZE or W // 2 < MIP_MIN_SIZE:
            break
        r = t.reshape(H // 2, 2, W // 2, 2, t.shape[-1])
        a, b, c, d = r[:, 0, :, 0], r[:, 0, :, 1], r[:, 1, :, 0], r[:, 1, :, 1]
        mean = 0.25 * (a + b + c + d)
        q = mip_down_u8(a, b, c, d)
        levels.append(mean + (q - mean.detach()))
    return levels


def build_atlas(texs, n_sphere, box_slot, ring_slot):
    """Flatten the pyramids of ``texs`` (in slot order) into a SceneAtlas."""
    pyramids = [_mip_levels(t) for t in texs]
    lmax = max(len(p) for p in pyramids)
    dev = texs[0].device
    chunks, offset, off = [], [], 0
    for p in pyramids:
        row = []
        for lev in p:
            row.append(off)
            chunks.append(lev.reshape(-1, lev.shape[-1]))
            off += lev.shape[0] * lev.shape[1]
        offset.append(row + [0] * (lmax - len(row)))
    i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    dims = tuple((int(t.shape[0]), int(t.shape[1])) for t in texs)
    return SceneAtlas(
        texels=torch.cat(chunks), offset=i64(offset),
        h0=i64([h for h, _ in dims]), w0=i64([w for _, w in dims]),
        levels=i64([len(p) for p in pyramids]), dims=dims,
        n_sphere=n_sphere, box_slot=box_slot, ring_slot=ring_slot)


def with_mips(textures: TextureSet) -> TextureSet:
    """TextureSet with its sampling tables built (idempotent) — the
    glGenerateMipmap moment (GLWrapper.cpp:343)."""
    if textures.atlas is not None or textures.cube is not None:
        return textures
    texs = list(textures.sphere)
    n_sphere = len(texs)
    box_slot = ring_slot = None
    if textures.box is not None:
        box_slot = len(texs)
        texs.append(textures.box)
    if textures.ring is not None:
        ring_slot = len(texs)
        texs.append(textures.ring)
    return dataclasses.replace(
        textures,
        atlas=build_atlas(texs, n_sphere, box_slot, ring_slot) if texs else None,
        cube=None if textures.cubemap is None else quantize_u8(textures.cubemap),
        ring_alpha=None if textures.ring is None else quantize_u8(textures.ring[..., 3]),
    )


LOD_COS_MIN = 0.125     # grazing-angle floor of the footprint's 1/cos


def footprint_world(t, cos_in, pix_angle):
    """World-space width of one sample's footprint at distance t
    (texture.py:878-879)."""
    return t * pix_angle / torch.clamp(cos_in, min=LOD_COS_MIN)


def _lod_from_texels(texels):
    return torch.log2(torch.clamp(texels, min=1.0))


def lod_sphere(fw, radius, shape0):
    """Spherical mapping: texels per world unit max(W/2π, H/π)/r
    (texture.py:882-890).  shape0 = (H, W): ints or per-ray tensors."""
    H, W = (torch.as_tensor(v, dtype=fw.dtype, device=fw.device) for v in shape0)
    tpw = torch.maximum(W / (2.0 * _PI), H / _PI) / torch.clamp(radius, min=1e-6)
    return _lod_from_texels(fw * tpw)


def lod_box(fw, shape0):
    """Triplanar mapping uv = 0.5·p: 0.5 uv-units per world unit."""
    return _lod_from_texels(fw * 0.5 * float(max(shape0)))


def lod_ring(fw, r1_sq, r2_sq, shape0):
    """Annulus mapping: radial W·2ρm/(r2²−r1²), angular H/(π·ρm) at the mid
    radius ρm (texture.py:900-910)."""
    H, W = (float(v) for v in shape0)
    rm = torch.sqrt(torch.clamp(0.5 * (r1_sq + r2_sq), min=1e-12))
    tpw = torch.maximum(W * 2.0 * rm / torch.clamp(r2_sq - r1_sq, min=1e-12), H / (_PI * rm))
    return _lod_from_texels(fw * tpw)


def box_face_uv(pt, normal, box_pos, box_quat):
    """(uv, weight) of the dominant triplanar face (texture.py:944-964).  The
    reference rotates box.pos by the quat, not pos-relative — kept."""
    pos = quat.rotate(box_quat, box_pos)
    p = quat.rotate(box_quat, pt)
    n = quat.rotate(box_quat, normal)
    rel = p - pos
    ax, ay, az = n[..., 0].abs(), n[..., 1].abs(), n[..., 2].abs()
    dom_x = (ax >= ay) & (ax >= az)
    dom_y = ~dom_x & (ay >= az)
    u = torch.where(dom_x, rel[..., 2], torch.where(dom_y, rel[..., 2], rel[..., 0]))
    v = torch.where(dom_x, rel[..., 1], torch.where(dom_y, rel[..., 0], rel[..., 1]))
    uv = 0.5 * torch.stack([u, v], dim=-1) - 0.5
    w = torch.where(dom_x, ax, torch.where(dom_y, ay, az))
    return uv, w


def _taps(base, H, W, uv, clamp):
    """The GL bilinear footprint in a flat texel table of an H×W image per
    ray starting at row ``base`` → (rows [4, ...] of the taps 00, 01, 10,
    11, and the weights fu, fv [..., 1]).  REPEAT wraps the taps;
    clamp-to-edge clamps the sample point into the texel-centre span."""
    dt = uv.dtype
    u = uv[..., 0] * W.to(dt) - 0.5
    v = uv[..., 1] * H.to(dt) - 0.5
    if clamp:
        u = torch.minimum(torch.clamp(u, min=0.0), (W - 1).to(dt))
        v = torch.minimum(torch.clamp(v, min=0.0), (H - 1).to(dt))
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.to(torch.int64)
    v0 = v0.to(torch.int64)
    if clamp:
        # the index clamps only matter for non-finite uv (never consumed)
        cu0 = torch.minimum(u0.clamp(min=0), W - 1)
        cv0 = torch.minimum(v0.clamp(min=0), H - 1)
        cu1 = torch.minimum(cu0 + 1, W - 1)
        cv1 = torch.minimum(cv0 + 1, H - 1)
    else:
        cu0, cu1 = torch.remainder(u0, W), torch.remainder(u0 + 1, W)
        cv0, cv1 = torch.remainder(v0, H), torch.remainder(v0 + 1, H)
    r0 = base + cv0 * W
    r1 = base + cv1 * W
    return torch.stack([r0 + cu0, r0 + cu1, r1 + cu0, r1 + cu1]), fu, fv


def _lerp(c, fu, fv):
    """Bilinear blend of the four taps' texels c [4, ..., C]."""
    c00, c01, c10, c11 = c
    top = c00 * (1.0 - fu) + c01 * fu
    bot = c10 * (1.0 - fu) + c11 * fu
    return top * (1.0 - fv) + bot * fv


def _bilinear(table, base, H, W, uv, clamp):
    """GL bilinear fetch from a flat [T, C] texel table (see ``_taps``):
    one gather for the four taps."""
    rows, fu, fv = _taps(base, H, W, uv, clamp)
    return _lerp(take(table, rows), fu, fv)


def sample_atlas(atlas: SceneAtlas, k, uv, lod=None):
    """textureLod on the scene atlas: k [R] slot, uv [R,2], lod [R] or None
    (level-0 bilinear) → RGBA [R,4].  Trilinear between floor(lod) and the
    next level, lod clamped to [0, L−1−BLOCK_LOD_EPS] (sample_packed).  The
    eight taps are one gather, so the texel table's gradient is one segment
    sum and one dense write per sample, not eight."""
    L = atlas.levels[k]
    h0, w0 = atlas.h0[k], atlas.w0[k]

    if lod is None:
        return _bilinear(atlas.texels, atlas.offset[k, 0], h0, w0, uv, clamp=False)

    def taps(level):
        return _taps(atlas.offset[k, level], h0 >> level, w0 >> level, uv, clamp=False)

    lmax = torch.clamp((L - 1).to(lod.dtype) - BLOCK_LOD_EPS, min=0.0)
    lod = torch.minimum(torch.clamp(lod, min=0.0), lmax)
    l0 = torch.floor(lod).to(torch.int64)
    l1 = torch.minimum(l0 + 1, L - 1)
    f = (lod - l0.to(lod.dtype))[..., None]
    rows0, fu0, fv0 = taps(l0)
    rows1, fu1, fv1 = taps(l1)
    c = take(atlas.texels, torch.cat([rows0, rows1]))
    return _lerp(c[:4], fu0, fv0) * (1.0 - f) + _lerp(c[4:], fu1, fv1) * f


def sample_ring_alpha(textures: TextureSet, uv):
    """Level-0 bilinear alpha of the ring texture (REPEAT) → [R]."""
    ra = textures.ring_alpha
    H, W = ra.shape
    z = torch.zeros(uv.shape[:-1], dtype=torch.int64, device=uv.device)
    return _bilinear(ra.reshape(-1, 1), z, z + H, z + W, uv, clamp=False)[..., 0]


def sphere_uv(normal):
    """Spherical UV from the rotated unit normal (rt.frag:323-325)."""
    u = 0.5 + torch.atan2(normal[..., 2], normal[..., 0]) / (2.0 * _PI)
    v = 0.5 - torch.asin(torch.clamp(normal[..., 1], -1.0, 1.0)) / _PI
    return torch.stack([u, v], dim=-1)


def _cube_face_uv(d):
    """direction [...,3] → (face [...] int64 in +x,-x,+y,-y,+z,-z order,
    uv [...,2]) per the GL cubemap face rule."""
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-20)
    sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                     torch.where(is_y, x, torch.where(z >= 0, x, -x)))
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face.to(torch.int64), torch.stack([u, v], dim=-1)


def sample_cubemap(textures: TextureSet, d):
    """Environment colour for direction d [R,3] → RGB [R,3]: level-0
    bilinear, clamp to edge (the reference's cubemap has no mips)."""
    cube = textures.cube
    S = cube.shape[1]
    face, uv = _cube_face_uv(d)
    size = torch.full_like(face, S)
    return _bilinear(cube.reshape(-1, cube.shape[-1]), face * (S * S), size, size,
                     uv, clamp=True)[..., :3]


def checkerboard(h=256, w=256, c1=(1.0, 1.0, 1.0), c2=(0.2, 0.2, 0.2), tiles=8, device=None):
    """Procedural [h, w, 4] texture of tiles × tiles squares in c1 and c2,
    alpha 1 (texture.py:1088), on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                            indexing="ij")
    mask = ((yy * tiles // h + xx * tiles // w) % 2).to(torch.float32)[..., None]
    c1 = torch.tensor(c1, dtype=torch.float32, device=dev)
    c2 = torch.tensor(c2, dtype=torch.float32, device=dev)
    rgb = c1 * (1 - mask) + c2 * mask
    return torch.cat([rgb, torch.ones((h, w, 1), device=dev)], dim=-1)
