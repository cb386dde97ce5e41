"""Row gathers on the card's row-gather kernel, whose backward adds each
gathered row's cotangent into its source row in one pass, with no sort.

`gather_rows(src, idx)` is ``src[idx]`` for a 2-D ``src`` and an int64
index of any shape.  Its forward is `kernels/gather.py::take_rows`:
`row_gather` (K7 on the card, ``src[idx]`` on the CPU) where ``src`` is
contiguous and of a 4-byte type (f32 or int32), else plain indexing.  Where
``src`` takes part in a gradient, the gather is a `RowGather`, whose
backward is `kernels/scatter.py::row_scatter_add` (K6 over the flat cells
``row * C + col`` on the card, `index_add_` on the CPU); else it has no
autograd node, and a forward-only scan pays nothing for the choice.
PyTorch's own backward of ``src[idx]`` (`index_put_(accumulate=True)`)
sorts the indices and adds each run of equal rows serially, and the record
pass gathers thousands of winners from one face row.
"""

from __future__ import annotations

import torch

from ..kernels.gather import take_rows
from ..kernels.scatter import row_scatter_add
from ..runtime.metrics import count


class RowGather(torch.autograd.Function):
    """``src[idx]`` for a (rows, C) ``src``; its backward scatters the
    rows of the cotangent into a zeroed (rows, C) gradient.  No gradient
    for the index."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = src.shape
        return take_rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows, cols = ctx.src_shape
        flat = idx.reshape(-1)
        count("row_scatter_rows", flat.numel())
        return row_scatter_add(flat, g.reshape(-1, cols).contiguous(),
                               rows), None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]``: a `RowGather` where ``src`` takes part in a gradient,
    else no autograd node; either way on `row_gather` where it takes the
    input (`take_rows`)."""
    if src.requires_grad and torch.is_grad_enabled():
        return RowGather.apply(src, idx)
    return take_rows(src, idx)
