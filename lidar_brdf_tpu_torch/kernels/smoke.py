"""The bench's pre-flight kernel K3: ``y = 2x + 1`` on an f32 tensor.

Counterpart of `bench.py::pallas_smoke`, the one-tile Pallas kernel the JAX
package's bench runs before it builds a workload.  On a CUDA tensor
`affine_smoke` launches `csrc/affine_smoke.cu` (built with nvcc at first
use into `build/kernels/`, loaded with ctypes); on a CPU tensor it runs
`affine_smoke_plain`.  It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_tensor


def _declare(lib):
    vp = ctypes.c_void_p
    lib.lbt_affine_smoke.argtypes = [vp, vp, ctypes.c_int64, vp]
    lib.lbt_affine_smoke.restype = ctypes.c_int


KERNEL = CudaLibrary("affine_smoke.cu", _declare)


def affine_smoke(x: torch.Tensor) -> torch.Tensor:
    """``2x + 1`` of a contiguous f32 tensor: K3 on a CUDA tensor (one
    launch), `affine_smoke_plain` on a CPU one."""
    if x.device.type == "cpu":
        return affine_smoke_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check_tensor("x", x, torch.float32, x.dim(), x.device)
    lib = KERNEL.build()
    y = torch.empty_like(x)
    rc = lib.lbt_affine_smoke(x.data_ptr(), y.data_ptr(), x.numel(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    KERNEL.check(rc, "affine_smoke")
    KERNEL.launches += 1
    return y


def affine_smoke_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    return x * 2.0 + 1.0
