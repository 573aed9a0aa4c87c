"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``rtbench/reference``), number by number,
each against the limit that ``rtbench/limits/<workload>.json`` gives it.
A number without a limit there is printed as a reading and decides
nothing.  The limits and the readings they were set from are in PERF.md.
"""

from __future__ import annotations

import json
import math
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# a pixel is off when its worst channel is more than this from the f64
# reference: float32 rounding stays far under it, a silhouette or a torus
# root that falls the other way goes over it
PIXEL_TOL = 1e-5


def frame_numbers(got, got_u8, want):
    """A frame [H, W, 3] (float) and its uint8 image as the host holds it,
    against the reference's frame (float64) → dict(frame_off: share of
    pixels off by more than PIXEL_TOL, frame_worst: the largest error,
    u8_off: share of the uint8 channels more than one level from the
    reference's rounding, clamp(x)·255 + 0.5)."""
    d = (got.double() - want).abs().amax(-1)
    want_u8 = torch.floor(want.clamp(0.0, 1.0) * 255.0 + 0.5)
    u8 = (got_u8.double() - want_u8).abs()
    # a pixel that is not a number is off
    return dict(frame_off=float((~(d <= PIXEL_TOL)).double().mean()), frame_worst=float(d.max()),
                u8_off=float((u8 > 1.0).double().mean()))


def most(values):
    """The largest of the values; not a number if any is not one."""
    values = list(values)
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def worst(rows):
    """The largest reading of each number over the rows."""
    keys = {k for r in rows for k in r}
    return {k: most(r[k] for r in rows if k in r) for k in keys}


def leaf_gaps(got, want):
    """{leaf: |‖got‖ − ‖want‖| / max(‖want‖, the median leaf's ‖want‖)}
    over the leaves with elements."""
    norms = {k: float(v.norm()) for k, v in want.items() if v.numel()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return {k: abs(float(got[k].double().norm()) - n) / max(n, med, 1e-300)
            for k, n in norms.items()}


def fit_numbers(out, loss, grads):
    """The fit's numbers → dict(loss_gap: the worst step's |loss − L| / L;
    grad_gap: the median leaf's gap (``leaf_gaps``) of the gradient as the
    optimiser got it at the first step, at the last step, and read back
    from the last step's first and second moments, the worst of the four;
    grad_gap_worst: the worst leaf's gap of the four; params_moved: the
    largest change of a parameter over the run, which rate 0 keeps at 0)."""
    loss_gap = most(abs(x - loss) / loss for x in out["losses"])
    med, top = [], []
    for src in ("g_first", "g_last", "g_m", "g_v"):
        gaps = list(leaf_gaps(out[src], grads).values())
        if any(math.isnan(g) for g in gaps):
            med.append(math.nan)
            top.append(math.nan)
            continue
        gaps.sort()
        med.append(gaps[(len(gaps) - 1) // 2])
        top.append(gaps[-1])
    return dict(loss_gap=loss_gap, grad_gap=most(med), grad_gap_worst=most(top),
                params_moved=out["moved"])


def limits(workload):
    path = os.path.join(HERE, "limits", f"{workload}.json")
    with open(path) as f:
        return json.load(f)


def decide(numbers, lim):
    """(correct, [(name, value, limit or None)]): each number with a limit
    is within it (a missing number, or one that is not finite, fails)."""
    rows, ok = [], True
    for name, limit in lim.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        rows.append((name, v, limit))
    rows += [(k, v, None) for k, v in numbers.items() if k not in lim]
    return ok, rows
