"""The table gradient's scatter-add: the hand-written CUDA kernel K6 and its
plain PyTorch version.

``out[idx[i, k]] += g[i, k]`` into a zeroed f32 vector of ``n_cells``: the
backward of a measured-BRDF table read (`physics/brdf.py::TableRead`),
the counterpart of the element scatter-add in the JAX package's custom
backwards `lidar_brdf_tpu/physics/brdf.py::_hermite_windows_bwd` and
`_bilinear_windows_bwd` (`jnp.zeros(...).at[idx].add(g)`).

On a CUDA tensor `table_scatter_add` launches `csrc/table_scatter.cu` once
(built with nvcc at first use into `build/kernels/`, loaded with ctypes);
on a CPU tensor it runs `table_scatter_add_plain`.  It never falls back
from one to the other.  The kernel's sums are not bit-stable from run to
run (float atomics; see the source's note).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_tensor, raw_stream


def _declare(lib):
    vp = ctypes.c_void_p
    lib.lbt_table_scatter.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_int32,
                                      vp, vp]
    lib.lbt_table_scatter.restype = ctypes.c_int


KERNEL = CudaLibrary("table_scatter.cu", _declare, "lbt_table_scatter")


def table_scatter_add(idx: torch.Tensor, g: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """(n_cells,) f32: the sum of ``g[i, k]`` over the (i, k) with
    ``idx[i, k] == c`` at each cell c.  ``idx`` int32 and ``g`` f32, both
    contiguous (N, W) on one device, every index in [0, n_cells).  K6 on a
    CUDA tensor (one launch; none for N = 0), `table_scatter_add_plain` on
    a CPU one."""
    if not g.is_cuda:
        if g.device.type == "cpu":
            return table_scatter_add_plain(idx, g, n_cells)
        raise ValueError(f"unsupported device {g.device}")
    dev = g.get_device()
    check_tensor("g", g, torch.float32, 2, dev)
    check_tensor("idx", idx, torch.int32, 2, dev)
    if idx.shape != g.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and g {tuple(g.shape)} "
                         f"differ in shape")
    if not 0 < n_cells < 2 ** 31:
        raise ValueError(f"n_cells must be in [1, 2^31), got {n_cells}")
    out = torch.zeros(n_cells, dtype=torch.float32, device=g.device)
    if g.numel():
        rc = KERNEL.launcher()(idx.data_ptr(), g.data_ptr(), g.numel(),
                               n_cells, out.data_ptr(), raw_stream(dev))
        if rc:
            KERNEL.check(rc, "table_scatter_add")
        KERNEL.launches += 1
    return out


def table_scatter_add_plain(idx: torch.Tensor, g: torch.Tensor,
                            n_cells: int) -> torch.Tensor:
    """Plain PyTorch version of K6: `index_add_` of the flat cotangents."""
    return torch.zeros(n_cells, dtype=g.dtype, device=g.device).index_add_(
        0, idx.reshape(-1), g.reshape(-1))
