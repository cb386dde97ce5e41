"""Flight/scan path construction: interpolation, simplification, planning.

Host numpy, copied from `lidar_brdf_tpu/sensors/paths.py` (the port keeps
its own copy and imports nothing of the JAX package).  Equivalents of the
reference's path machinery:
* Douglas-Peucker simplification of user paths (`RayBuilder::douglasPecker`,
  RayBuilder.cpp:69-104) with redundant-point removal (:290-300).
* Linear and Catmull-Rom waypoint interpolation
  (`Geometry/Animation/{LinearInterpolation,CatmullRom}`; CatmullRom.cpp:
  33-72 — uniform CR basis, clamped ends, per-segment time keys).
* Automatic parallel sweep-line planning over the scene AABB from FOV,
  altitude and overlap (`RayBuilder::getAirbonePaths` :129-213 /
  `getNumSteps` :225-232).
* Waypoint resampling at the scan advance rate (`retrievePath` :305-327).
"""

from __future__ import annotations

import math

import numpy as np

# Uniform Catmull-Rom basis (rows applied to P[k-2..k+1], 0.5 factor).
_CR_COEFFS = np.array([
    [-1.0, 2.0, -1.0, 0.0],
    [3.0, -5.0, 0.0, 2.0],
    [-3.0, 4.0, 1.0, 0.0],
    [1.0, -1.0, 0.0, 0.0],
], np.float64)


def perpendicular_distance(point, seg_a, seg_b) -> float:
    d = np.asarray(seg_b, np.float64) - np.asarray(seg_a, np.float64)
    mag = np.linalg.norm(d)
    if mag > 0:
        d = d / mag
    pv = np.asarray(point, np.float64) - np.asarray(seg_a, np.float64)
    return float(np.linalg.norm(pv - np.dot(pv, d) * d))


def douglas_peucker(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Recursive polyline simplification (parity with `douglasPecker`)."""
    points = np.asarray(points, np.float32)
    if len(points) < 3:
        return points.copy()
    end = len(points) - 1
    dists = [perpendicular_distance(points[i], points[0], points[end])
             for i in range(1, end)]
    max_d = max(dists) if dists else 0.0
    idx = int(np.argmax(dists)) + 1 if dists else 0
    if max_d > epsilon:
        left = douglas_peucker(points[:idx + 1], epsilon)
        right = douglas_peucker(points[idx:], epsilon)
        return np.concatenate([left, right[1:]])
    return np.stack([points[0], points[end]])


def remove_redundant_points(points: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    points = np.asarray(points)
    if len(points) < 2:
        return points.copy()
    keep = [0]
    for i in range(1, len(points)):
        if not np.allclose(points[i], points[keep[-1]], atol=eps):
            keep.append(i)
    return points[keep]


class LinearPath:
    """Piecewise-linear interpolation over waypoints with uniform t."""

    def __init__(self, waypoints: np.ndarray):
        self.waypoints = np.asarray(waypoints, np.float64)

    def position(self, t: float) -> np.ndarray:
        w = self.waypoints
        n = len(w)
        if n == 1:
            return w[0]
        t = min(max(t, 0.0), 1.0)
        seg = t * (n - 1)
        k = min(int(seg), n - 2)
        h = seg - k
        return w[k] * (1 - h) + w[k + 1] * h


class CatmullRomPath:
    """Uniform Catmull-Rom over waypoints with explicit time keys
    (`CatmullRom::getPosition`)."""

    def __init__(self, waypoints: np.ndarray, time_keys=None):
        self.waypoints = np.asarray(waypoints, np.float64)
        n = len(self.waypoints)
        if time_keys is None:
            time_keys = [i / float(n) for i in range(n)]
        self.time_keys = list(time_keys)

    def position(self, t: float) -> np.ndarray:
        w = self.waypoints
        n = len(w)
        if t < 1e-7:
            return w[0]
        if t >= 1.0:
            return w[-1]
        k = 0
        while k < len(self.time_keys) and self.time_keys[k] < t:
            k += 1
        k = min(k, len(self.time_keys) - 1)
        k_prev = max(k - 1, 0)
        denom = self.time_keys[k] - self.time_keys[k_prev]
        h = (t - self.time_keys[k_prev]) / denom if denom > 0 else 0.0
        result = np.zeros(w.shape[1], np.float64)
        for i in range(4):
            kn = min(max(k + i - 2, 0), n - 1)
            c = _CR_COEFFS[i]
            b = 0.5 * (((c[0] * h + c[1]) * h + c[2]) * h + c[3])
            result += b * w[kn]
        return result


class BezierPath:
    """Bezier curve over control points (the reference builds these on GPU
    for the GUI path preview, `Interpolations/buildBezierCurve-comp.glsl`;
    here a host-side de Casteljau for path tooling parity)."""

    def __init__(self, control_points: np.ndarray):
        self.points = np.asarray(control_points, np.float64)

    def position(self, t: float) -> np.ndarray:
        pts = self.points.copy()
        t = min(max(t, 0.0), 1.0)
        n = len(pts)
        for r in range(1, n):
            pts[:n - r] = (1 - t) * pts[:n - r] + t * pts[1:n - r + 1]
        return pts[0]


def sweep_width(fov_deg: float, height: float) -> float:
    """Across-track swath radius*2 (`RayBuilder::getRadius`)."""
    return abs(math.tan(math.radians(fov_deg) / 2.0) * height) * 2.0


def num_sweeps(fov_deg: float, als_height: float, aabb_min, aabb_max,
               overlapping: float) -> tuple[int, float]:
    """`RayBuilder::getNumSteps`: number of parallel sweep lines to cover
    the scene depth (z extent) given swath width and overlap."""
    max_height = als_height - aabb_max[1]
    width = sweep_width(fov_deg, max_height)
    depth = aabb_max[2] - aabb_min[2]
    return int(math.ceil(depth / (width - width * overlapping))), width


def auto_sweep_paths(aabb_min, aabb_max, als_height: float, fov_deg: float,
                     overlapping: float, max_sweeps: int) -> list[LinearPath]:
    """Automatic parallel flight lines across the scene (`getAirbonePaths`
    auto branch): numSteps lines at constant z spacing, x from min to max."""
    steps, _ = num_sweeps(fov_deg, als_height, aabb_min, aabb_max, overlapping)
    depth_div = (aabb_max[2] - aabb_min[2]) / (steps + 1)
    paths = []
    for i in range(min(steps, max_sweeps)):
        z = depth_div * (i + 1) + aabb_min[2]
        waypoints = np.array([
            [aabb_min[0], als_height, z, 1.0],
            [aabb_max[0], als_height, z, 1.0]], np.float64)
        paths.append(LinearPath(waypoints))
    return paths


def manual_path(points_2d: np.ndarray, canvas_size, aabb_min, aabb_max,
                als_height: float, epsilon: float,
                use_catmull_rom: bool) -> list:
    """User-drawn canvas path -> world-space interpolated path
    (`getAirbonePaths` manual branch)."""
    pts = remove_redundant_points(np.asarray(points_2d, np.float32))
    pts = douglas_peucker(pts, epsilon)
    scene_size = np.array([aabb_max[0] - aabb_min[0], aabb_max[2] - aabb_min[2]])
    scene_min = np.array([aabb_min[0], aabb_min[2]])
    canvas = np.asarray(canvas_size, np.float64)
    world = pts * scene_size / canvas + scene_min
    waypoints = np.stack([world[:, 0], np.full(len(world), als_height),
                          world[:, 1], np.ones(len(world))], axis=1)
    if use_catmull_rom:
        keys = [i / float(len(waypoints)) for i in range(len(waypoints))]
        return [CatmullRomPath(waypoints, keys)]
    return [LinearPath(waypoints)]


def retrieve_waypoints(paths: list, t_increment: float,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Sample all paths at the scan advance step (`retrievePath`): returns
    (num_paths * path_length, 4) waypoints.  Each path contributes exactly
    the same count (the downstream index arithmetic relies on it, see
    `AerialLinearBuilder::buildParameters`)."""
    count = int(math.floor(1.0 / t_increment)) + 1
    out = []
    for path in paths:
        t0 = 0.0
        if rng is not None:
            t0 = (rng.uniform(-1, 1) + 1.0) / 2.0 * t_increment / 10.0
        for i in range(count):
            out.append(path.position(min(t0 + i * t_increment, 1.0)))
    return np.asarray(out, np.float64)
