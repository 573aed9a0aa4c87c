"""Row gathers whose backward stays fast when many rays read the same row."""

from __future__ import annotations

import torch

# Tables with at most this many rows (primitives, materials, lights) sum
# their gradient by a one-hot product; larger ones (texels) by a sorted
# segment sum.
ONE_HOT_ROWS = 64


def segment_sum(idx, g2, rows):
    """Σ g2[i] over the i with idx[i] = r, for every row r < ``rows`` →
    [rows, g2.shape[1]], each row summed in the order of i.

    A stable sort groups the equal indices, keeping their order, and
    ``segment_reduce`` sums each run sequentially, so the result is the
    same on every call (an ``index_add_`` on CUDA adds with atomics in
    whatever order the threads arrive) and equals a sequential
    ``index_add_`` on the CPU.  The work scales with the reads, n, not the
    table: there is one segment per read, as long as its run where a run
    starts and empty elsewhere (its length from a binary search of the
    sorted indices for each read), and the run sums go to their rows in one
    write of the output, every empty segment to a spare last row that is
    dropped.  No host synchronisation, and no tensor of ``rows`` elements
    but the output."""
    n = idx.shape[0]
    sidx, perm = torch.sort(idx, stable=True)
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = sidx[1:] != sidx[:-1]
    run = torch.searchsorted(sidx, sidx, right=True) - torch.arange(n, device=idx.device)
    sums = torch.segment_reduce(g2.index_select(0, perm), "sum",
                                lengths=torch.where(start, run, 0), axis=0, unsafe=True)
    out = g2.new_zeros((rows + 1, g2.shape[1]))
    out.index_put_((torch.where(start, sidx, rows),), sums)
    return out[:rows]


class _Take(torch.autograd.Function):
    """index_select along dim 0 with a backward suited to the table's size.

    Advanced indexing's backward sorts the indices and then sums each run of
    equal indices in one thread: with two million rays on a handful of
    primitives, one such gather took over 100 ms of device time on the H100.
    index_select's own backward, an atomic index_add, still serialises the
    ~10⁶ adds that land on each row (about 2 ms a call).  A small table's
    gradient is instead onehot(idx)ᵀ · grad, one float64 matrix product:
    no atomics, a fixed summation order, and no TF32 whatever the matmul
    precision setting.  A large one's (texels, few reads per row) is
    ``segment_sum``: no atomics either, so a fit of texture contents is
    bit-identical from run to run on the card too."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        if table.is_cuda and table[0].numel() > 1:
            # On the H100 (PyTorch 2.11) a gather of 16-byte rows, as the
            # texel, cubemap and quaternion tables have, takes about 0.6 ns an
            # index; one along the columns of the transposed table is 9-15x
            # faster (chip_smoke.py: gather_bench).  The rows come back
            # contiguous, with the same values.
            flat = table.reshape(table.shape[0], -1)
            out = torch.index_select(flat.t(), 1, idx).t().contiguous()
            return out.reshape(idx.shape + table.shape[1:])
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g2 = g.reshape(g.shape[0], -1)
        if ctx.rows > ONE_HOT_ROWS:
            out = segment_sum(idx, g2, ctx.rows)
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
