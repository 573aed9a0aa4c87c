"""The plain reference (rtbench/reference) against the program on the CPU
at a small size, by the cells' own comparison and limits; and its
control, the reference in bfloat16 put in the program's place, which the
same limits refuse."""

from __future__ import annotations

import pytest
import torch

from rtbench import check, scenedata, system, textures
from rtbench.reference import render as ref

W, H, T = 64, 36, 60.45


@pytest.fixture(scope="module", params=["demo-1080p", "demo-1080p-ultra"])
def frame_case(request):
    from txr_torch.render.render import render

    torch.set_num_threads(2)
    cfg = scenedata.load_config(request.param)
    raw = textures.make(cfg, 33, torch.device("cpu"))
    scene, handles = system.scene(cfg, "cpu")
    with torch.no_grad():
        img = render(system.pose(scene, handles, T), system.textures(cfg, raw),
                     system.render_config(cfg, W, H), device="cpu")
    cell = "demo-1080p-view" if request.param == "demo-1080p" else "demo-1080p-ultra-view"
    return cfg, raw, img, cell


def _u8(img):
    return (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _frame(cfg, raw, dtype):
    with torch.no_grad():
        return ref.render(ref.Scene(cfg, T, dtype), ref.Textures(cfg, raw, dtype),
                          ref.settings(cfg, W, H))


def test_frames_agree_with_the_program(frame_case):
    cfg, raw, img, cell = frame_case
    want = _frame(cfg, raw, torch.float64)
    nums = dict(check.frame_numbers(img, _u8(img), want), frame_missing=0.0)
    ok, rows = check.decide(nums, check.limits(cell))
    assert ok, rows
    assert nums["frame_off"] < 0.03


def test_bfloat16_control_fails_the_frame_check(frame_case):
    cfg, raw, _, cell = frame_case
    want = _frame(cfg, raw, torch.float64)
    low = _frame(cfg, raw, torch.bfloat16).float()
    nums = dict(check.frame_numbers(low, _u8(low), want), frame_missing=0.0)
    assert not check.decide(nums, check.limits(cell))[0]
    assert nums["frame_off"] > 0.5


@pytest.fixture(scope="module")
def grad_case():
    from txr_torch.render.render import render
    from txr_torch.scene.types import float_leaves, unflatten_like

    torch.set_num_threads(2)
    cfg = scenedata.load_config("demo-1080p")
    raw = textures.make(cfg, 34, torch.device("cpu"))
    scene, handles = system.scene(cfg, "cpu")
    posed = system.pose(scene, handles, T)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in float_leaves(posed).items()}
    img = render(unflatten_like(posed, leaves), system.textures(cfg, raw),
                 system.render_config(cfg, W, H), device="cpu")
    loss = (img * img).mean()
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: (torch.zeros_like(v) if g is None else g).double()
             for (k, v), g in zip(leaves.items(), got)}
    return cfg, raw, float(loss.detach()), grads


def _reference_grad(cfg, raw, dtype, rows=None):
    S = ref.Scene(cfg, T, dtype, requires_grad=True)
    loss, g, _ = ref.loss_and_grad(S, ref.Textures(cfg, raw, dtype), ref.settings(cfg, W, H),
                                   rows=rows)
    return loss, {k: v.double() for k, v in g.items()}


def _as_fit(loss, g):
    return dict(losses=[loss], g_first=g, g_last=g, g_m=g, g_v=g, moved=0.0)


def test_gradient_agrees_with_the_program(grad_case):
    cfg, raw, loss, grads = grad_case
    want_loss, want = _reference_grad(cfg, raw, torch.float64)
    assert set(want) == set(grads) and len(want) == 82
    nums = check.fit_numbers(_as_fit(loss, grads), want_loss, want)
    ok, rows = check.decide(nums, check.limits("demo-1080p-fit"))
    assert ok, rows


def test_bfloat16_control_and_half_rows_fail_the_fit_check(grad_case):
    cfg, raw, _, _ = grad_case
    want_loss, want = _reference_grad(cfg, raw, torch.float64)
    lim = check.limits("demo-1080p-fit")
    for dtype, rows in ((torch.bfloat16, None), (torch.float64, slice(0, H // 2))):
        nums = check.fit_numbers(_as_fit(*_reference_grad(cfg, raw, dtype, rows)), want_loss, want)
        assert not check.decide(nums, lim)[0], (dtype, nums)
