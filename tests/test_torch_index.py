"""The texel gradient's segment sum (txr_torch/utils/index.py).

``take``'s backward for a table over ``ONE_HOT_ROWS`` rows (the texels)
sums each row's gradient by a stable sort and a sequential segment sum in
place of ``index_add_``, whose CUDA kernel adds with atomics in whatever
order its threads arrive.  Held here against ``index_add_`` within 1e-6
(float32 sums of up to 400 terms of order 1), bit for bit against the
CPU's sequential ``index_add_`` (the same order of additions), and two
calls against each other bit for bit; through ``take`` the table's
gradient equals ``index_add_``'s.  The texture-content gradients against
JAX stay in tests/test_torch_grads.py and tests/test_torch_optimize.py.
"""

import numpy as np
import pytest
import torch

from txr_torch.utils.index import ONE_HOT_ROWS, segment_sum, take

# one intra-op thread: parallel test workers share the cores
torch.set_num_threads(1)


def _case(seed, n, rows, width):
    rng = np.random.default_rng(seed)
    # skewed reads: a few rows take most of them, many rows take none
    idx = np.minimum(rng.zipf(1.5, n) - 1, rows - 1)
    g = rng.normal(size=(n, width)).astype(np.float32)
    return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(g)


@pytest.mark.parametrize("seed,n,rows,width", [(0, 5000, 300, 1), (1, 20000, 4096, 4),
                                               (2, 7, 100, 3)])
def test_segment_sum_matches_index_add(seed, n, rows, width):
    idx, g = _case(seed, n, rows, width)
    want = torch.zeros(rows, width).index_add_(0, idx, g)
    got = segment_sum(idx, g, rows)
    assert got.shape == (rows, width) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * max(1.0, float(want.abs().max())))
    # the CPU's index_add_ adds in index order, as the segment sum does
    assert torch.equal(got, want)
    assert torch.equal(segment_sum(idx, g, rows), got)


def test_take_backward_on_a_texel_table():
    idx, g = _case(3, 3000, 2 * ONE_HOT_ROWS + 5, 4)
    table = torch.zeros(2 * ONE_HOT_ROWS + 5, 4, requires_grad=True)
    (grad,) = torch.autograd.grad(take(table, idx.reshape(60, 50)), table, g.reshape(60, 50, 4))
    assert torch.equal(grad, torch.zeros_like(table).index_add_(0, idx, g))
