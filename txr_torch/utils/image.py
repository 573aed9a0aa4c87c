"""Image helpers (txr/utils/image.py): the golden criterion, tonemap to
8 bits, PNG read and write, side-by-side strips.

PNGs are written and read with ``zlib`` and ``struct`` alone (8-bit, not
interlaced, every filter type); PIL is imported only to read JPEGs and
other formats.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _np(img):
    """A numpy array of ``img`` (a numpy array or a tensor on any device)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def oracle_edge_mask(want, contrast=0.25):
    """[H,W] bool: pixels whose 3×3 neighbourhood in the reference image
    spans ≥ ``contrast`` in some channel — where a last-bit root difference
    can flip the nearest-hit winner and show a neighbouring surface.  The
    golden criterion bounds the worst error on the complement of this mask."""
    want = np.asarray(want, np.float64)
    p = np.pad(want, ((1, 1), (1, 1), (0, 0)), mode="edge")
    mx = np.full(want.shape, -np.inf)
    mn = np.full(want.shape, np.inf)
    H, W = want.shape[:2]
    for dy in range(3):
        for dx in range(3):
            sl = p[dy:dy + H, dx:dx + W]
            mx = np.maximum(mx, sl)
            mn = np.minimum(mn, sl)
    return ((mx - mn) >= contrast).any(axis=-1)


def golden_check(got, want, tol=2e-3, edge_frac=0.015, edge_abs=0.5):
    """The golden criterion (bench.py gate): at most ``edge_frac`` of pixels
    off by more than ``tol``, and no pixel outside ``oracle_edge_mask`` off
    by more than ``edge_abs``.  → (ok, frac_over_tol, worst_interior)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want).max(axis=-1)
    frac = float((diff > tol).mean())
    interior = ~oracle_edge_mask(want)
    worst = float(diff[interior].max()) if interior.any() else 0.0
    ok = bool(np.isfinite(got).all()) and frac <= edge_frac and worst <= edge_abs
    return ok, frac, worst


def to_uint8(img, clip=True):
    img = _np(img).astype(np.float64)
    if clip:
        img = np.clip(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def png_bytes(img):
    """[H,W] or [H,W,C] (C = 1..4) uint8, or float in 0..1 → PNG file bytes
    (8-bit, filter 0 on every row)."""
    arr = _np(img)
    arr = arr if arr.dtype == np.uint8 else to_uint8(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    return (_PNG_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path, img):
    """Save an [H,W,3] float (0..1) or uint8 image as a PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return path


def _unfilter(data, h, stride, bpp):
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ft == 2:
            cur = (line + prev) & 255
        elif ft in (3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ft == 3:
                    cur[x] = (cur[x] + (a + b) // 2) & 255
                    continue
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 255
        else:
            raise ValueError(f"PNG: unknown filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def png_decode(data):
    """PNG file bytes (8-bit, not interlaced) → uint8 [H,W,C]: gray, gray
    and alpha, RGB, RGBA, or a palette expanded to RGB(A)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, trns = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace:
        raise ValueError(f"PNG: only 8-bit, non-interlaced images are read (depth {depth}, "
                         f"interlace {interlace})")
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c).reshape(h, w, c)
    if ctype == 3:
        idx = px[..., 0]
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return px


def load_image(path, dtype=np.float32):
    """An image file → [H,W,4] float RGBA in [0,1] (for TextureSet).  PNGs
    are decoded here; anything else through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIG:
        arr = png_decode(data)
        if arr.shape[-1] in (1, 2):                     # gray (+ alpha)
            arr = np.concatenate([np.repeat(arr[..., :1], 3, axis=-1), arr[..., 1:]], -1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], -1)
        return (arr.astype(np.float64) / 255.0).astype(dtype)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGBA"), np.float64) / 255.0
    return img.astype(dtype)


def side_by_side(*imgs, gap=4):
    """Images [H,W,C] placed left to right, ``gap`` white columns apart,
    shorter ones padded with black below."""
    imgs = [_np(i).astype(np.float64) for i in imgs]
    h = max(i.shape[0] for i in imgs)
    parts = []
    for k, img in enumerate(imgs):
        if img.shape[0] < h:
            img = np.concatenate([img, np.zeros((h - img.shape[0],) + img.shape[1:])], axis=0)
        parts.append(img)
        if k != len(imgs) - 1:
            parts.append(np.ones((h, gap, img.shape[-1])))
    return np.concatenate(parts, axis=1)
