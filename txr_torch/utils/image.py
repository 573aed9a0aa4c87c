"""Image helpers (a copy of txr/utils/image.py:8-26)."""

from __future__ import annotations

import numpy as np


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
