"""The bench's pre-flight kernel K3: ``y = 2x + 1`` on an f32 tensor.

Counterpart of `bench.py::pallas_smoke`, the one-tile Pallas kernel the JAX
package's bench runs before it builds a workload.  On a CUDA tensor
`affine_smoke` launches `csrc/affine_smoke.cu` (built with nvcc at first
use into `build/kernels/`, loaded with ctypes); on a CPU tensor it runs
`affine_smoke_plain`.  It never falls back from one to the other.

K3 is bound by its launch path on the host, so the wrapper does no more
than it must: one test of the input, one `torch.empty_like`, the raw
stream handle and one ctypes call.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, raw_stream


def _declare(lib):
    vp = ctypes.c_void_p
    lib.lbt_affine_smoke.argtypes = [vp, vp, ctypes.c_int64, vp]
    lib.lbt_affine_smoke.restype = ctypes.c_int


KERNEL = CudaLibrary("affine_smoke.cu", _declare, "lbt_affine_smoke")


def affine_smoke(x: torch.Tensor) -> torch.Tensor:
    """``2x + 1`` of a contiguous f32 tensor: K3 on a CUDA tensor (one
    launch), `affine_smoke_plain` on a CPU one."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return affine_smoke_plain(x)
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype is not torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        rc = KERNEL.launcher()(x.data_ptr(), y.data_ptr(), n,
                               raw_stream(x.get_device()))
        if rc:
            KERNEL.check(rc, "affine_smoke")
        KERNEL.launches += 1
    return y


def affine_smoke_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    return x * 2.0 + 1.0
