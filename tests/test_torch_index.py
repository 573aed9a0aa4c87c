"""The texel gradient's segment sum (txr_torch/utils/index.py).

``take``'s backward for a table over ``ONE_HOT_ROWS`` rows (the texels)
sums each row's gradient by a stable sort and a sequential segment sum in
place of ``index_add_``, whose CUDA kernel adds with atomics in whatever
order its threads arrive.  Its work scales with the reads, not the
table's rows.  Held here against ``index_add_`` within 1e-6 (float32 sums
of up to 1000 terms of order 1), bit for bit against the CPU's sequential
``index_add_`` (the same order of additions; the sign of zero included),
and two calls against each other bit for bit, on skewed reads, on a
texel-sized table of 2^22 rows with 10^4 reads, on runs of one read and
of a thousand, and on rows that sum to -0.0 or cancel; through ``take``
the table's gradient equals ``index_add_``'s.  Reads whose cotangent is
±0.0 (the fill lanes of the full-width texel fetch that the captured
train step runs) change no bit of the sum.  The texture-content gradients against
JAX stay in tests/test_torch_grads.py and tests/test_torch_optimize.py.
"""

import numpy as np
import pytest
import torch

from txr_torch.utils.index import ONE_HOT_ROWS, segment_sum, take

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)


def _case(seed, n, rows, width, kind="zipf"):
    rng = np.random.default_rng(seed)
    if kind == "zipf":
        # skewed reads: a few rows take most of them, many rows take none
        idx = np.minimum(rng.zipf(1.5, n) - 1, rows - 1)
    elif kind in ("sparse", "signed_zero"):
        # a texel table's shape: few reads spread over many rows, most empty
        idx = rng.integers(0, rows, n)
    else:
        # every row read is read n_run times, in a shuffled order
        n_run = {"distinct": 1, "runs": 1000}[kind]
        idx = rng.permutation(np.repeat(rng.choice(rows, n // n_run, replace=False), n_run))
    g = rng.normal(size=(n, width)).astype(np.float32)
    if kind == "signed_zero":
        # rows whose reads are all -0.0, or ±1 that cancel: index_add_ from a
        # +0.0 start gives +0.0 there
        g[idx % 3 == 0] = -0.0
        g[idx % 3 == 1] = np.where(rng.random(((idx % 3 == 1).sum(), 1)) < 0.5, 1.0, -1.0)
    return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(g)


@pytest.mark.parametrize("seed,n,rows,width,kind", [
    pytest.param(0, 5000, 300, 1, "zipf", id="0-5000-300-1"),
    pytest.param(1, 20000, 4096, 4, "zipf", id="1-20000-4096-4"),
    pytest.param(2, 7, 100, 3, "zipf", id="2-7-100-3"),
    pytest.param(4, 10_000, 1 << 22, 4, "sparse", id="sparse-2^22-rows"),
    pytest.param(5, 10_000, 1 << 22, 4, "distinct", id="runs-of-1"),
    pytest.param(6, 20_000, 4096, 4, "runs", id="runs-of-1000"),
    pytest.param(7, 5000, 64 * 1024, 4, "signed_zero", id="signed-zero")])
def test_segment_sum_matches_index_add(seed, n, rows, width, kind):
    idx, g = _case(seed, n, rows, width, kind)
    want = torch.zeros(rows, width).index_add_(0, idx, g)
    got = segment_sum(idx, g, rows)
    assert got.shape == (rows, width) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * max(1.0, float(want.abs().max())))
    # the CPU's index_add_ adds in index order, as the segment sum does: bit
    # for bit, the sign of zero included
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(segment_sum(idx, g, rows).view(torch.int32), got.view(torch.int32))


def test_take_backward_on_a_texel_table():
    idx, g = _case(3, 3000, 2 * ONE_HOT_ROWS + 5, 4)
    table = torch.zeros(2 * ONE_HOT_ROWS + 5, 4, requires_grad=True)
    (grad,) = torch.autograd.grad(take(table, idx.reshape(60, 50)), table, g.reshape(60, 50, 4))
    assert torch.equal(grad, torch.zeros_like(table).index_add_(0, idx, g))


@pytest.mark.parametrize("kind", ["zipf", "signed_zero"])
def test_zero_cotangent_reads_change_no_bit(kind):
    """The full-width form of a texel fetch (``intersect.over_lanes`` under
    ``fixed_shapes``) reads for every lane; a lane that requests no texel
    carries a cotangent of +0.0 or -0.0 into the segment sum.  Interleaved
    among the real reads, at rows read or not, they leave the lane-list
    form's sum as it was, bit for bit."""
    idx, g = _case(8, 4000, 4096, 4, kind)
    rng = np.random.default_rng(9)
    n_fill = 3000
    at = rng.permutation(len(idx) + n_fill) < n_fill
    fill_g = np.where(rng.random((n_fill, 4)) < 0.5, 0.0, -0.0).astype(np.float32)
    idx_all = np.empty(len(idx) + n_fill, np.int64)
    g_all = np.empty((len(idx) + n_fill, 4), np.float32)
    idx_all[~at], g_all[~at] = idx.numpy(), g.numpy()
    idx_all[at], g_all[at] = rng.integers(0, 4096, n_fill), fill_g
    want = segment_sum(idx, g, 4096)
    got = segment_sum(torch.from_numpy(idx_all), torch.from_numpy(g_all), 4096)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
