"""Terrestrial spherical ray generation (counterpart of
`lidar_brdf_tpu/sensors/tls.py`; `terrestrialSpherical-comp.glsl:44-85`).

One pulse per (horizontal, vertical) grid cell, direction from a spherical
sweep with per-row vertical angles, optional angle jitter around a random
axis, and beam-footprint supersampling on a disc of ``pulse_radius``.  A
negative vertical angle points below the horizon (the GPU `rotation3d`
convention the JAX package follows).  Scalars are formed in f32 as the JAX
package forms them, so both give the same rays from the same buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import (SensorConfig, tls_vertical_angles,
                           tls_vertical_resolution)
from ..core.types import RayBundle
from ..utils import noise as noise_mod
from ..utils.safemath import cross3, dot3

UP = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32)   # footprint basis


def _normalize(v, floor: float = 1e-12):
    n = torch.sqrt(dot3(v, v))[..., None]
    return v / torch.clamp(n, min=floor)


def rotate_axis_angle(v, axis, angle):
    """Rodrigues rotation of v around axis by angle (radians)."""
    axis = _normalize(axis)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    d = dot3(axis, v)[..., None]
    return v * c + cross3(axis, v) * s + axis * d * (1.0 - c)


def radius_axes(direction, up):
    """Footprint disc basis (`Templates/computeAxes.glsl`)."""
    u = _normalize(cross3(torch.broadcast_to(up, direction.shape), direction))
    v = _normalize(cross3(direction, u))
    return u, v


def num_tls_pulses(cfg: SensorConfig) -> int:
    return cfg.tls_resolution_horizontal * tls_vertical_resolution(cfg)


def build_tls_rays(cfg: SensorConfig, noise_buf: torch.Tensor, *,
                   position=None, direction=None, start: int = 0,
                   count: int | None = None) -> RayBundle:
    """TLS pulses [start, start + count) of the scan grid, on the device of
    ``noise_buf`` (the U[-1,1] ray-generation buffer)."""
    dev = noise_buf.device
    f32 = np.float32
    vres = tls_vertical_resolution(cfg)
    total = num_tls_pulses(cfg)
    if count is None:
        count = total - start
    R = cfg.rays_per_pulse

    vtable = torch.tensor(np.asarray(tls_vertical_angles(cfg), f32),
                          device=dev)
    fov_h = f32(np.radians(cfg.tls_fov_horizontal))
    inc_h = float(fov_h / f32(total))
    c0 = float(-fov_h / f32(2.0) + f32(np.radians(
        cfg.tls_middle_angle_horizontal)))
    if position is None:
        position = torch.tensor(cfg.tls_position, dtype=torch.float32,
                                device=dev)
    if direction is None:
        direction = torch.tensor(cfg.tls_direction, dtype=torch.float32,
                                 device=dev)
    advance = direction / torch.tensor([total, 1.0, total],
                                       dtype=torch.float32, device=dev)
    time_pulse = float(f32((1.0 / cfg.scan_frequency_hz) / total))

    idx = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    h_id = idx // vres
    v_id = idx % vres
    v_angle = vtable[v_id]
    h_angle = (c0 + inc_h * (h_id * vres).to(torch.float32)
               + inc_h * v_id.to(torch.float32))
    zeros = torch.zeros_like(h_angle)
    sphere = torch.stack([torch.cos(h_angle), zeros, -torch.sin(h_angle)],
                         dim=-1)
    rot_axis = torch.stack([sphere[:, 2], zeros, -sphere[:, 0]], dim=-1)
    dest = rotate_axis_angle(sphere, rot_axis, -v_angle)

    if cfg.tls_angle_jittering > 0:
        jitter_axis = torch.stack(
            [noise_mod.sample(noise_buf, idx, off)
             for off in noise_mod.AXIS_NOISE_OFFSET], dim=-1)
        jitter_angle = (noise_mod.sample(noise_buf, idx,
                                         noise_mod.ANGLE_NOISE_OFFSET)
                        * float(f32(cfg.tls_angle_jittering)))
        dest = rotate_axis_angle(dest, jitter_axis, jitter_angle)

    idx_f = idx.to(torch.float32)
    origin = position[None, :] + advance[None, :] * idx_f[:, None]
    gps_time = time_pulse * idx_f

    # central ray + (R-1) destinations jittered on the footprint disc; TLS
    # rays share the origin (diverging beam)
    u, v = radius_axes(dest, UP.to(dev))
    ray_ids = torch.arange(1, R, dtype=torch.int64, device=dev)
    n1 = noise_mod.sample(noise_buf, idx[:, None],
                          noise_mod.PULSE_NOISE_OFFSET[0] + ray_ids[None, :])
    n2 = noise_mod.sample(noise_buf, idx[:, None],
                          noise_mod.PULSE_NOISE_OFFSET[1] + ray_ids[None, :])
    pr = float(f32(cfg.pulse_radius))
    offsets = (n1[..., None] * pr * u[:, None, :]
               + n2[..., None] * pr * v[:, None, :])          # (P, R-1, 3)
    dest_all = torch.cat([dest[:, None, :], dest[:, None, :] + offsets], dim=1)
    origin_all = torch.broadcast_to(origin[:, None, :], dest_all.shape)
    return RayBundle(origin=origin_all.contiguous(),
                     direction=_normalize(dest_all), gps_time=gps_time)
