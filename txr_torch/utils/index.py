"""Row gathers whose backward stays fast when many rays read the same row."""

from __future__ import annotations

import torch

# Tables with at most this many rows (primitives, materials, lights) sum
# their gradient by a one-hot product; larger ones (texels) by index_add.
ONE_HOT_ROWS = 64


class _Take(torch.autograd.Function):
    """index_select along dim 0 with a backward suited to the table's size.

    Advanced indexing's backward sorts the indices and then sums each run of
    equal indices in one thread: with two million rays on a handful of
    primitives, one such gather took over 100 ms of device time on the H100.
    index_select's own backward, an atomic index_add, still serialises the
    ~10⁶ adds that land on each row (about 2 ms a call).  A small table's
    gradient is instead onehot(idx)ᵀ · grad, one float64 matrix product:
    no atomics, a fixed summation order, and no TF32 whatever the matmul
    precision setting."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g2 = g.reshape(g.shape[0], -1)
        if ctx.rows > ONE_HOT_ROWS:
            out = g2.new_zeros((ctx.rows, g2.shape[1])).index_add_(0, idx, g2)
        else:
            rows = torch.arange(ctx.rows, device=idx.device)
            onehot = (idx[None, :] == rows[:, None]).to(torch.float64)
            out = (onehot @ g2.to(torch.float64)).to(g.dtype)
        return out.reshape((ctx.rows,) + g.shape[1:]), None


def take(table, idx):
    """``table[idx]`` along dim 0 for an int64 index tensor of any shape →
    [*idx.shape, *table.shape[1:]].  Every per-ray read of a primitive,
    material, light or texel goes through here (see ``_Take``)."""
    flat = _Take.apply(table, idx.reshape(-1))
    return flat.reshape(idx.shape + table.shape[1:])
