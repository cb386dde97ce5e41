"""Frozen aerial ray generator: zig-zag scans along the
automatic parallel flight lines over the scene (a copy of the port's
`sensors/als.py::plan_flight` / `build_als_rays` and `sensors/paths.py`
for that mode), kept here so that the benchmark's rays never change with
the program.  The sensor settings are read from the configuration's
``sensor`` dict, keyed as the port's `SensorConfig`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .tls import (PULSE_NOISE_OFFSET, _cross, _normalize, _sample,
                  raygen_noise)

RAY_NOISE_OFFSET = (0xFF245, 0x23456, 0xFFFF289)
HEIGHT_NOISE_OFFSET = 0xAC987
AERIAL_ZIGZAG = 2
_f32 = lambda x: float(np.float32(x))


def _recip32(x) -> float:
    return float(np.float32(1.0) / np.float32(x))


def flight_lines(lo, hi, height, fov_deg, overlapping, max_sweeps):
    """Parallel lines at constant z across the scene's x extent: (start,
    end) of each, as `RayBuilder::getAirbonePaths` lays them."""
    width = abs(math.tan(math.radians(fov_deg) / 2.0) * (height - hi[1])) * 2
    steps = int(math.ceil((hi[2] - lo[2]) / (width - width * overlapping)))
    depth_div = (hi[2] - lo[2]) / (steps + 1)
    return [(np.array([lo[0], height, depth_div * (i + 1) + lo[2]]),
             np.array([hi[0], height, depth_div * (i + 1) + lo[2]]))
            for i in range(min(steps, max_sweeps))]


def plan(sensor: dict, lo, hi, rng) -> dict:
    """Waypoints sampled along every line at the scan advance."""
    if sensor["lidar_type"] != AERIAL_ZIGZAG or sensor["als_manual_path"]:
        raise ValueError("only automatic zig-zag flights")
    lines = flight_lines(lo, hi, sensor["als_position"][1],
                         sensor["als_fov_horizontal"],
                         sensor["als_overlapping"],
                         sensor["als_max_scene_sweeps"])
    width = hi[0] - lo[0]
    step = sensor["als_speed"] / sensor["als_scan_frequency"] / max(width,
                                                                     1e-9)
    count = int(math.floor(1.0 / step)) + 1
    wps = []
    for a, b in lines:
        t0 = (rng.uniform(-1, 1) + 1.0) / 2.0 * step / 10.0
        for i in range(count):
            h = min(max(min(t0 + i * step, 1.0), 0.0), 1.0)
            wps.append(a * (1 - h) + b * h)
    fov = math.radians(sensor["als_fov_horizontal"])
    pps = max(int(sensor["als_pulse_frequency"]
                  // sensor["als_scan_frequency"]), 1)
    return dict(waypoints=np.asarray(wps, np.float64).astype(np.float32),
                path_length=count, num_paths=len(lines), pulses_per_scan=pps,
                start=-fov / 2.0 + 2.0 * math.pi, inc=fov / pps)


def als_rays(sensor: dict, scene: dict, seed: int, count: int) -> dict:
    """The first ``count`` pulses of the survey over ``scene``:
    ``origin``, ``direction`` (P, R, 3) and ``gps_time`` (P,), float32 CPU
    tensors.  The plan draws from ``default_rng(seed)``, the ray noise from
    the buffer of ``seed + 1``."""
    v = scene["vertices"]
    p = plan(sensor, v.min(0).astype(np.float64), v.max(0).astype(np.float64),
             np.random.default_rng(seed))
    total = (p["path_length"] - 1) * p["num_paths"] * p["pulses_per_scan"]
    count = min(count, total)
    buf = raygen_noise(seed + 1)
    idx = torch.arange(count, dtype=torch.int64)
    wp = torch.from_numpy(p["waypoints"])
    n, plen = p["pulses_per_scan"], p["path_length"]
    path_id = idx // ((plen - 1) * n)
    scan_id = idx // n
    wid = scan_id % (plen - 1) + 1 + path_id * plen
    pulse = (idx % n).to(torch.float32)
    sign = (scan_id % 2 == 0).to(torch.float32) * 2.0 - 1.0
    w1, w0 = wp[wid], wp[wid - 1]
    wdir = w1 - w0
    nd = _normalize(wdir)
    axis = torch.stack([-nd[:, 2], torch.zeros_like(nd[:, 0]), nd[:, 0]], -1)
    angle = sign * _f32(p["start"]) + sign * pulse * _f32(p["inc"])
    rj = _f32(sensor["als_ray_jittering"])
    jit = [_sample(buf, idx, off) * rj for off in RAY_NOISE_OFFSET]
    sphere = axis * (-torch.sin(angle))[:, None] + torch.stack(
        [jit[0], -torch.cos(angle) + jit[1], jit[2]], -1)
    hj = _sample(buf, idx, HEIGHT_NOISE_OFFSET) \
        * _f32(sensor["als_height_jittering"])
    zeros = torch.zeros_like(hj)
    origin = (w1 + torch.stack([zeros, hj, zeros], -1)
              + wdir * _recip32(n) * pulse[:, None])
    d0 = _normalize(sphere)
    up = torch.tensor([0.0, -1.0, 0.0])
    u = _normalize(_cross(torch.broadcast_to(up, d0.shape), d0))
    w = _normalize(_cross(d0, u))
    R = sensor["rays_per_pulse"]
    ray_ids = torch.arange(1, R, dtype=torch.int64)
    n1 = _sample(buf, idx[:, None], PULSE_NOISE_OFFSET[0] + ray_ids[None, :])
    n2 = _sample(buf, idx[:, None], PULSE_NOISE_OFFSET[1] + ray_ids[None, :])
    pr = _f32(sensor["pulse_radius"])
    offsets = (n1[..., None] * pr * u[:, None, :]
               + n2[..., None] * pr * w[:, None, :])
    origin_all = origin[:, None, :] + torch.cat(
        [torch.zeros_like(origin[:, None, :]), offsets], 1)
    return dict(origin=origin_all.contiguous(),
                direction=torch.broadcast_to(d0[:, None, :],
                                             origin_all.shape).contiguous(),
                gps_time=idx.to(torch.float32)
                * _recip32(sensor["als_pulse_frequency"]))
