"""Row gathers whose backward adds each gathered row's cotangent into its
source row in one pass, with no sort.

`gather_rows(src, idx)` is ``src[idx]`` for a 2-D ``src`` and an int64
index of any shape.  Where ``src`` takes part in a gradient, the gather is
a `RowGather`, whose backward is `kernels/scatter.py::row_scatter_add`
(K6 over the flat cells ``row * C + col`` on the card, `index_add_` on
the CPU); else it is plain indexing, and a forward-only scan pays nothing
for the choice.  PyTorch's own backward
of ``src[idx]`` (`index_put_(accumulate=True)`) sorts the indices and adds
each run of equal rows serially, and the record pass gathers thousands of
winners from one face row.
"""

from __future__ import annotations

import torch

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
        return src[idx]

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
    plain indexing where it does not."""
    if src.requires_grad and torch.is_grad_enabled():
        return RowGather.apply(src, idx)
    return src[idx]
