"""Airborne ray generation: linear, zig-zag and elliptical (Palmer) scans.

Counterpart of `lidar_brdf_tpu/sensors/als.py` (the reference's
`AerialLinearBuilder.cpp`, `AerialZigZagBuilder.cpp`,
`AerialEllipticalBuilder.cpp` and `airborneLinearZigzag-comp.glsl:41-81`,
`airborneElliptical-comp.glsl`): pulses indexed along resampled flight-path
waypoints, ray fans perpendicular to the flight direction (or on a cone
around nadir for the Palmer scan), with height/ray jitter and parallel-ray
beam supersampling.

The flight plan is host numpy (`plan_flight`, same `np.random.Generator`
draws as the JAX package); the rays are built on the device of the noise
buffer.  Pulse indices are int64 where the JAX package uses uint32; the
plans of this repository stay far below 2**32 pulses, so nothing wraps.
Scalars are formed in f32 as the JAX package forms them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import LiDARType, SensorConfig
from ..core.types import RayBundle
from ..utils import noise as noise_mod
from ..utils.safemath import dot3
from .paths import auto_sweep_paths, manual_path, retrieve_waypoints
from .tls import radius_axes

AERIAL_UP = (0.0, -1.0, 0.0)

_f32 = lambda x: float(np.float32(x))     # a Python scalar rounded to f32


def _recip32(x) -> float:
    """1 / x rounded to f32.  XLA compiles a division by a constant as a
    multiplication by the constant's f32 reciprocal; the port does the
    same so that both packages give the same bits."""
    return float(np.float32(1.0) / np.float32(x))


@dataclass
class ALSPlan:
    """Host-side flight plan (waypoints resampled per scan line).

    Mirrors `ALSParameters` built by `AerialLinearBuilder::buildParameters`.
    """

    waypoints: np.ndarray       # (W, 3) f32
    num_paths: int
    path_length: int            # waypoints per path
    pulses_per_scan: int
    start_radians: float
    increment_radians: float
    # elliptical-only
    ellipse_radius: float = 0.0
    ellipse_scale: float = 0.0
    height_radius: float = 1.0

    @property
    def num_pulses(self) -> int:
        if self.increment_radians and self.pulses_per_scan:
            return (self.path_length - 1) * self.num_paths \
                * self.pulses_per_scan
        return (self.path_length - 1) * self.num_paths


def plan_flight(cfg: SensorConfig, aabb_min, aabb_max,
                rng: np.random.Generator | None = None) -> ALSPlan:
    """Build the flight plan for any aerial mode."""
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    if cfg.als_manual_path:
        paths = manual_path(cfg.als_manual_path, cfg.als_manual_canvas_size,
                            aabb_min, aabb_max, cfg.als_position[1],
                            cfg.douglas_peucker_epsilon, cfg.use_catmull_rom)
    else:
        paths = auto_sweep_paths(aabb_min, aabb_max, cfg.als_position[1],
                                 cfg.als_fov_horizontal, cfg.als_overlapping,
                                 cfg.als_max_scene_sweeps)
    scene_width = aabb_max[0] - aabb_min[0]
    pulses_per_scan = max(
        int(cfg.als_pulse_frequency // cfg.als_scan_frequency), 1)

    if cfg.lidar_type == LiDARType.AERIAL_ELLIPTICAL:
        # `AerialEllipticalBuilder::buildParameters` (cpp:32-58)
        num_scans = scene_width / cfg.als_speed * cfg.als_scan_frequency
        num_pulses = scene_width / cfg.als_speed * cfg.als_pulse_frequency
        advance_pulse = 1.0 / max(num_pulses, 1.0)
        waypoints = retrieve_waypoints(paths, advance_pulse, rng)
        path_length = len(waypoints) // len(paths)
        inc = 2.0 * math.pi / max(num_pulses / max(num_scans, 1e-9), 1e-9)
        height_radius = 1.0
        ellipse_radius = math.tan(
            math.radians(cfg.als_fov_horizontal) / 2.0) * height_radius
        return ALSPlan(
            waypoints=waypoints[:, :3].astype(np.float32),
            num_paths=len(paths), path_length=path_length,
            pulses_per_scan=0, start_radians=0.0, increment_radians=inc,
            ellipse_radius=ellipse_radius,
            ellipse_scale=cfg.als_fov_vertical,
            height_radius=height_radius)

    # linear / zigzag (`AerialLinearBuilder::buildParameters`, cpp:32-65)
    advance_scan = cfg.als_speed / cfg.als_scan_frequency
    advance_scan_t = advance_scan / max(scene_width, 1e-9)
    fov = math.radians(cfg.als_fov_horizontal)
    waypoints = retrieve_waypoints(paths, advance_scan_t, rng)
    path_length = len(waypoints) // len(paths)
    return ALSPlan(
        waypoints=waypoints[:, :3].astype(np.float32),
        num_paths=len(paths), path_length=path_length,
        pulses_per_scan=pulses_per_scan,
        start_radians=-fov / 2.0 + 2.0 * math.pi,
        increment_radians=fov / pulses_per_scan)


def build_als_rays(cfg: SensorConfig, plan: ALSPlan, noise_buf: torch.Tensor,
                   *, start: int = 0, count: int | None = None) -> RayBundle:
    """Aerial pulses [start, start + count) of the plan, on the device of
    ``noise_buf`` (the U[-1,1] ray-generation buffer)."""
    if count is None:
        count = plan.num_pulses - start
    dev = noise_buf.device
    idx = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    wp = torch.from_numpy(np.ascontiguousarray(plan.waypoints,
                                               np.float32)).to(dev)
    if cfg.lidar_type == LiDARType.AERIAL_ELLIPTICAL:
        sensor, sphere = _elliptical(cfg, plan, wp, noise_buf, idx)
    else:
        sensor, sphere = _linear_zigzag(
            cfg, plan, wp, noise_buf, idx,
            zigzag=cfg.lidar_type == LiDARType.AERIAL_ZIGZAG)
    origin_all, dir_all = _pulse_disc(cfg, noise_buf, idx, sensor, sphere)
    gps = idx.to(torch.float32) * _recip32(cfg.als_pulse_frequency)
    return RayBundle(origin=origin_all, direction=dir_all, gps_time=gps)


def _normalize(v):
    """v / max(|v|, 1e-12), |v| summed left to right as `jnp.linalg.norm`."""
    n = torch.sqrt(dot3(v, v))[..., None]
    return v / torch.clamp(n, min=1e-12)


def _jitter(noise_buf, idx, rj: float, y):
    """sphere offset: (n0 * rj, y + n1 * rj, n2 * rj) from RAY_NOISE_OFFSET."""
    n = [noise_mod.sample(noise_buf, idx, off) * rj
         for off in noise_mod.RAY_NOISE_OFFSET]
    return torch.stack([n[0], y + n[1], n[2]], dim=-1)


def _height(cfg, noise_buf, idx):
    """(0, height jitter, 0) per pulse."""
    hj = noise_mod.sample(noise_buf, idx, noise_mod.HEIGHT_NOISE_OFFSET) \
        * _f32(cfg.als_height_jittering)
    zeros = torch.zeros_like(hj)
    return torch.stack([zeros, hj, zeros], dim=-1)


def _linear_zigzag(cfg, plan, wp, noise_buf, idx, zigzag: bool):
    n_pulses = plan.pulses_per_scan
    plen = plan.path_length
    path_id = idx // ((plen - 1) * n_pulses)
    scan_id = idx // n_pulses
    waypoint_id = scan_id % (plen - 1) + 1 + path_id * plen
    pulse_id = (idx % n_pulses).to(torch.float32)
    if zigzag:
        sign = (scan_id % 2 == 0).to(torch.float32) * 2.0 - 1.0
    else:
        sign = torch.ones_like(pulse_id)

    w1 = wp[waypoint_id]
    w0 = wp[waypoint_id - 1]
    wdir = w1 - w0
    nd = _normalize(wdir)
    rot_axis = torch.stack([-nd[:, 2], torch.zeros_like(nd[:, 0]), nd[:, 0]],
                           dim=-1)
    angle = sign * _f32(plan.start_radians) \
        + sign * pulse_id * _f32(plan.increment_radians)
    sphere = rot_axis * (-torch.sin(angle))[:, None]
    sphere = sphere + _jitter(noise_buf, idx, _f32(cfg.als_ray_jittering),
                              -torch.cos(angle))
    sensor = (w1 + _height(cfg, noise_buf, idx)
              + wdir * _recip32(n_pulses) * pulse_id[:, None])
    return sensor, sphere


def _elliptical(cfg, plan, wp, noise_buf, idx):
    plen = plan.path_length
    path_id = idx // (plen - 1)
    pulse_id = (idx % (plen - 1)).to(torch.float32)
    waypoint_id = path_id * plen + (idx % (plen - 1)) + 1

    angle = _f32(plan.increment_radians) * pulse_id
    sphere = torch.stack([torch.sin(angle) * _f32(plan.ellipse_scale),
                          torch.zeros_like(angle), torch.cos(angle)],
                         dim=-1) * _f32(plan.ellipse_radius)
    sphere = sphere + _jitter(
        noise_buf, idx, _f32(cfg.als_ray_jittering),
        torch.full_like(angle, -_f32(plan.height_radius)))
    sensor = wp[waypoint_id] + _height(cfg, noise_buf, idx)
    return sensor, sphere


def _pulse_disc(cfg, noise_buf, idx, origin, sphere):
    """Shared beam supersampling: ALS offsets both origin and destination by
    the same disc noise (parallel sub-rays, `airborneLinearZigzag-comp.glsl:
    70-79`), unlike the diverging TLS beam."""
    R = cfg.rays_per_pulse
    dev = origin.device
    direction0 = _normalize(sphere)
    u, v = radius_axes(direction0,
                       torch.tensor(AERIAL_UP, dtype=torch.float32,
                                    device=dev))
    ray_ids = torch.arange(1, R, dtype=torch.int64, device=dev)
    n1 = noise_mod.sample(noise_buf, idx[:, None],
                          noise_mod.PULSE_NOISE_OFFSET[0] + ray_ids[None, :])
    n2 = noise_mod.sample(noise_buf, idx[:, None],
                          noise_mod.PULSE_NOISE_OFFSET[1] + ray_ids[None, :])
    pr = _f32(cfg.pulse_radius)
    offsets = (n1[..., None] * pr * u[:, None, :]
               + n2[..., None] * pr * v[:, None, :])          # (P, R-1, 3)
    zeros = torch.zeros_like(origin[:, None, :])
    origin_all = origin[:, None, :] + torch.cat([zeros, offsets], dim=1)
    dir_all = torch.broadcast_to(direction0[:, None, :], origin_all.shape)
    return origin_all.contiguous(), dir_all.contiguous()
