"""The forward row gathers: the hand-written CUDA kernel K7 and its plain
PyTorch version.

``src[idx]`` for a contiguous (rows, C) ``src`` of a 4-byte type (f32 or
int32) and an int64 index of any shape: the return extraction's face,
ray, vertex, neighbour and noise rows, through `take_rows`
(`physics/rows.py::gather_rows`, `utils/noise.py::stream_rows`), which
keeps plain indexing for any other input.  Bit for bit ``src[idx]``: a
gather moves bits and computes nothing.

On a CUDA tensor `row_gather` launches `csrc/row_gather.cu` once (built
with nvcc at first use into `build/kernels/`, loaded with ctypes; none for
an empty index); on a CPU tensor it runs `row_gather_plain`.  It never
falls back from one to the other.  K7 replaces no TPU kernel: PyTorch's
own gather of rows whose size is a multiple of 16 bytes launches a block
per index, and the card's rate of issuing blocks, not its bytes, sets its
pace (see the source's note).
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime.metrics import count
from .cuda_build import CudaLibrary, raw_stream

LAUNCHES = 1          # K7 launches a `row_gather` call (none for no rows)
WORD_TYPES = (torch.float32, torch.int32)


def _declare(lib):
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.lbt_row_gather.argtypes = [vp, vp, i64, i64, i64, vp, vp]
    lib.lbt_row_gather.restype = ctypes.c_int


KERNEL = CudaLibrary("row_gather.cu", _declare, "lbt_row_gather")


def gathers_rows(src: torch.Tensor, idx: torch.Tensor) -> bool:
    """Whether `row_gather` takes ``src`` and ``idx``: a contiguous 2-D
    ``src`` of a 4-byte type and an int64 index on its device."""
    return (src.dim() == 2 and src.dtype in WORD_TYPES
            and src.is_contiguous() and idx.dtype is torch.int64
            and idx.device == src.device)


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]``, of shape ``(*idx.shape, C)``, for a contiguous (rows,
    C) ``src`` of f32 or int32 and an int64 ``idx`` on the same device,
    every value in [0, rows).  K7 on a CUDA tensor (one launch; none for an
    empty index), `row_gather_plain` on a CPU one; counts the rows in
    ``row_gather_rows``.  Raises ValueError on another dtype, rank or
    device, or a non-contiguous ``src``."""
    if not (isinstance(src, torch.Tensor) and isinstance(idx, torch.Tensor)):
        raise TypeError("src and idx must be tensors")
    if not gathers_rows(src, idx):
        raise ValueError(
            f"row_gather takes a contiguous 2-D float32 or int32 src and an "
            f"int64 idx on its device; got {src.dim()}-D {src.dtype} src on "
            f"{src.device} (contiguous={src.is_contiguous()}), {idx.dtype} "
            f"idx on {idx.device}")
    count("row_gather_rows", idx.numel())
    if not src.is_cuda:
        if src.device.type == "cpu":
            return row_gather_plain(src, idx)
        raise ValueError(f"unsupported device {src.device}")
    rows, cols = src.shape
    flat = idx.reshape(-1).contiguous()
    out = torch.empty((flat.numel(), cols), dtype=src.dtype,
                      device=src.device)
    if out.numel():
        if rows == 0:
            raise IndexError("row_gather: index into a source of no rows")
        rc = KERNEL.launcher()(src.data_ptr(), flat.data_ptr(), flat.numel(),
                               cols, rows, out.data_ptr(),
                               raw_stream(src.get_device()))
        if rc:
            KERNEL.check(rc, "row_gather")
        KERNEL.launches += 1
    return out.reshape(*idx.shape, cols)


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: ``src[idx]``."""
    return src[idx]


def take_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]``: `row_gather` where it takes the input (`gathers_rows`),
    else plain indexing; the input decides."""
    return row_gather(src, idx) if gathers_rows(src, idx) else src[idx]
