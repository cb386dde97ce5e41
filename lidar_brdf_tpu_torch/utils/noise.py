"""Deterministic noise buffers (counterpart of `lidar_brdf_tpu/utils/noise.py`).

One shared U[0,1] buffer with constant per-purpose stream offsets, as the
reference's white-noise SSBO (`LiDARSimulation.cpp:113-125`).  The buffers
are drawn from a CPU `torch.Generator` seeded explicitly, then moved to the
compute device, so one seed gives the same buffer on every device.  The
*layout* (`sample`, `stream_rows`, `stream_sample`) is the JAX package's
exactly: the same index reads the same cell, so tests can hand the JAX
buffers to the port and compare.
"""

from __future__ import annotations

import torch

from ..kernels.gather import take_rows

# Stream offsets, named after their reference uses.
DISTANCE_NOISE_OFFSET = 0x456823
LOSS_NOISE_OFFSET = 0x45632
MODEL_COMP_NOISE_OFFSET = 0xAC987
POINT_NOISE_OFFSET = 0xAC666
TERRAIN_NOISE_OFFSET_V = 0x56789
TERRAIN_NOISE_OFFSET_H = 0x65432
HORIZONTAL_AXIS_OFFSET_X = 0x45623
HORIZONTAL_AXIS_OFFSET_Z = 0x7652FA
OUTLIER_NOISE_OFFSET = 0x234578
OUTLIER_DISTANCE_OFFSET = 0xFCBA23
# Ray-builder offsets (`terrestrialSpherical-comp.glsl:6-8`)
AXIS_NOISE_OFFSET = (0xFF245, 0x23456, 0xFFFF28)
ANGLE_NOISE_OFFSET = 0xAC987
PULSE_NOISE_OFFSET = (0x66565, 0x23456)
RAY_NOISE_OFFSET = (0xFF245, 0x23456, 0xFFFF289)
HEIGHT_NOISE_OFFSET = 0xAC987

SIM_NOISE_SIZE = 5_000_000     # U[0,1]  (`LiDARSimulation.cpp:23`)
RAYGEN_NOISE_SIZE = 500_000    # U[-1,1] (`RayBuilder.cpp:11`)

_U32 = 0xFFFFFFFF


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g


def make_sim_noise(seed: int, size: int = SIM_NOISE_SIZE,
                   device="cpu") -> torch.Tensor:
    """U[0,1) buffer for the reduce/validate/outlier stages."""
    buf = torch.rand(size, generator=_generator(seed), dtype=torch.float32)
    return buf.to(device)


def make_raygen_noise(seed: int, size: int = RAYGEN_NOISE_SIZE,
                      device="cpu") -> torch.Tensor:
    """U[-1,1) buffer for the ray builders."""
    buf = torch.rand(size, generator=_generator(seed), dtype=torch.float32)
    return (buf * 2.0 - 1.0).to(device)


def _u32(index) -> torch.Tensor:
    """Index as the JAX package's uint32, held in int64."""
    return torch.as_tensor(index).to(torch.int64) & _U32


def sample(buffer: torch.Tensor, index, offset) -> torch.Tensor:
    """``noise[(index + offset) % size]`` with uint32 wrap-around."""
    idx = ((_u32(index) + _u32(offset).to(buffer.device)) & _U32) \
        % buffer.shape[0]
    return buffer[idx]


# Interleaved streams: stream k for index i lives at row (i % rows), column
# k, so all streams of one index are one row read.
NUM_STREAMS = 16
DISTANCE_STREAM = 0
LOSS_STREAM = 1
POINT_STREAM = 2
TERRAIN_V_STREAM = 3
TERRAIN_H_STREAM = 4
AXIS_X_STREAM = 5
AXIS_Z_STREAM = 6
OUTLIER_STREAM = 7
OUTLIER_DISTANCE_STREAM = 8
MODEL_COMP_STREAM = 9


def _stream_view(buffer: torch.Tensor) -> torch.Tensor:
    rows = buffer.shape[0] // NUM_STREAMS
    return buffer[:rows * NUM_STREAMS].view(rows, NUM_STREAMS)


def stream_rows(buffer: torch.Tensor, index) -> torch.Tensor:
    """(index.shape, NUM_STREAMS): every stream of each index, one 64-byte
    row each (`kernels/gather.py::take_rows`: K7 on the card for an f32
    buffer)."""
    view = _stream_view(buffer)
    return take_rows(view, _u32(index) % view.shape[0])


def stream_sample(buffer: torch.Tensor, index, stream: int) -> torch.Tensor:
    """One stream, same layout as `stream_rows`."""
    view = _stream_view(buffer)
    return view[_u32(index) % view.shape[0], stream]
