"""Frozen terrestrial spherical ray generator (a copy of the port's
`sensors/tls.py::build_tls_rays`, with the ray-generation noise buffer of
`utils/noise.py`), kept here so that the benchmark's rays never change
with the program.  The sensor settings are read from the configuration's
``sensor`` dict, keyed as the port's `SensorConfig`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RAYGEN_NOISE_SIZE = 500_000
AXIS_NOISE_OFFSET = (0xFF245, 0x23456, 0xFFFF28)
ANGLE_NOISE_OFFSET = 0xAC987
PULSE_NOISE_OFFSET = (0x66565, 0x23456)
_U32 = 0xFFFFFFFF


def raygen_noise(seed: int) -> torch.Tensor:
    """U[-1, 1) buffer drawn from a CPU generator seeded ``seed``."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.rand(RAYGEN_NOISE_SIZE, generator=g,
                      dtype=torch.float32) * 2.0 - 1.0


def _sample(buf, index, offset):
    idx = ((torch.as_tensor(index).to(torch.int64) & _U32)
           + (torch.as_tensor(offset).to(torch.int64) & _U32)) & _U32
    return buf[idx % buf.shape[0]]


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v))[..., None], min=1e-12)


def _rotate(v, axis, angle):
    axis = _normalize(axis)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    return v * c + _cross(axis, v) * s + axis * _dot(axis, v)[..., None] \
        * (1.0 - c)


def vertical_angles(sensor: dict) -> list[float]:
    """Per-row vertical angles in radians (uniform rows only)."""
    if not sensor["tls_uniform_vertical_resolution"]:
        raise ValueError("only uniform vertical resolution is generated")
    vres = sensor["tls_resolution_vertical"]
    fov_v = math.radians(sensor["tls_fov_vertical"])
    fov_v += fov_v / vres
    inc_v = fov_v / vres
    start = math.radians(sensor["tls_middle_angle_vertical"]) - fov_v / 2.0
    return [start + inc_v * i for i in range(vres)]


def tls_rays(sensor: dict, seed: int) -> dict:
    """Every pulse of one scan: ``origin`` and ``direction`` (P, R, 3) and
    ``gps_time`` (P,), float32 CPU tensors."""
    f32 = np.float32
    buf = raygen_noise(seed + 1)
    vres = sensor["tls_resolution_vertical"]
    total = sensor["tls_resolution_horizontal"] * vres
    R = sensor["rays_per_pulse"]
    vtable = torch.tensor(np.asarray(vertical_angles(sensor), f32))
    fov_h = f32(np.radians(sensor["tls_fov_horizontal"]))
    inc_h = float(fov_h / f32(total))
    c0 = float(-fov_h / f32(2.0)
               + f32(np.radians(sensor["tls_middle_angle_horizontal"])))
    position = torch.tensor(sensor["tls_position"], dtype=torch.float32)
    direction = torch.tensor(sensor["tls_direction"], dtype=torch.float32)
    advance = direction / torch.tensor([total, 1.0, total],
                                       dtype=torch.float32)
    time_pulse = float(f32((1.0 / sensor["scan_frequency_hz"]) / total))

    idx = torch.arange(total, dtype=torch.int64)
    h_id, v_id = idx // vres, idx % vres
    h_angle = (c0 + inc_h * (h_id * vres).to(torch.float32)
               + inc_h * v_id.to(torch.float32))
    zeros = torch.zeros_like(h_angle)
    sphere = torch.stack([torch.cos(h_angle), zeros, -torch.sin(h_angle)], -1)
    rot_axis = torch.stack([sphere[:, 2], zeros, -sphere[:, 0]], -1)
    dest = _rotate(sphere, rot_axis, -vtable[v_id])
    if sensor["tls_angle_jittering"] > 0:
        axis = torch.stack([_sample(buf, idx, off)
                            for off in AXIS_NOISE_OFFSET], -1)
        angle = (_sample(buf, idx, ANGLE_NOISE_OFFSET)
                 * float(f32(sensor["tls_angle_jittering"])))
        dest = _rotate(dest, axis, angle)
    idx_f = idx.to(torch.float32)
    origin = position[None, :] + advance[None, :] * idx_f[:, None]
    gps_time = time_pulse * idx_f
    up = torch.tensor([0.0, 1.0, 0.0])
    u = _normalize(_cross(torch.broadcast_to(up, dest.shape), dest))
    v = _normalize(_cross(dest, u))
    ray_ids = torch.arange(1, R, dtype=torch.int64)
    n1 = _sample(buf, idx[:, None], PULSE_NOISE_OFFSET[0] + ray_ids[None, :])
    n2 = _sample(buf, idx[:, None], PULSE_NOISE_OFFSET[1] + ray_ids[None, :])
    pr = float(f32(sensor["pulse_radius"]))
    offsets = (n1[..., None] * pr * u[:, None, :]
               + n2[..., None] * pr * v[:, None, :])
    dest_all = torch.cat([dest[:, None, :], dest[:, None, :] + offsets], 1)
    return dict(origin=torch.broadcast_to(origin[:, None, :],
                                          dest_all.shape).contiguous(),
                direction=_normalize(dest_all), gps_time=gps_time)
