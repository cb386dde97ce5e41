"""Point-cloud visualization — PNG export of the reference's render modes.

Counterpart of `lidar_brdf_tpu/viz.py`.  The reference ships an OpenGL
viewer with 10 point-cloud render modes (`LiDARScene.cpp:269-330`: RGB,
semantic, ASPRS, height, intensity, return number, normal, scan angle,
scan direction, GPS time); both packages render them offline.

The JAX package draws `render_png` and `render_overlays` with matplotlib;
the port draws them in numpy and writes them with its own PNG codec
(`io/png.py`), so it needs no plotting library on the machine that holds
the card.  Their colour values per mode (`_colors`) are the JAX package's;
the pictures are the port's own: points as square splats, lines and
outlines one pixel wide, no colour bar and no title text.  `render_ortho`
is the JAX package's numpy rasterizer unchanged and writes the same bytes.
"""

from __future__ import annotations

import numpy as np

from .core.types import PointCloud, as_numpy
from .io.png import write_png

RENDER_MODES = ("height", "intensity", "return_number", "num_returns",
                "semantic", "asprs", "normal", "scan_angle",
                "scan_direction", "gps_time", "distance")

# Colour maps as a few anchor colours, interpolated linearly (sampled from
# the matplotlib maps the JAX package names); the categorical ones index.
_RAMPS = {
    "viridis": [(0.267, 0.005, 0.329), (0.231, 0.322, 0.545),
                (0.129, 0.569, 0.549), (0.369, 0.788, 0.384),
                (0.993, 0.906, 0.144)],
    "inferno": [(0.001, 0.000, 0.014), (0.341, 0.062, 0.429),
                (0.735, 0.216, 0.330), (0.978, 0.557, 0.035),
                (0.988, 0.998, 0.645)],
    "plasma": [(0.050, 0.030, 0.528), (0.494, 0.012, 0.658),
               (0.798, 0.280, 0.470), (0.973, 0.585, 0.254),
               (0.940, 0.975, 0.131)],
    "magma": [(0.001, 0.000, 0.014), (0.316, 0.072, 0.485),
              (0.716, 0.215, 0.475), (0.987, 0.536, 0.382),
              (0.987, 0.991, 0.750)],
    "coolwarm": [(0.230, 0.299, 0.754), (0.865, 0.865, 0.865),
                 (0.706, 0.016, 0.150)],
}
_TAB10 = np.array([
    [0.12, 0.47, 0.71], [1.00, 0.50, 0.05], [0.17, 0.63, 0.17],
    [0.84, 0.15, 0.16], [0.58, 0.40, 0.74], [0.55, 0.34, 0.29],
    [0.89, 0.47, 0.76], [0.50, 0.50, 0.50], [0.74, 0.74, 0.13],
    [0.09, 0.75, 0.81]], np.float32)


def _colors(cloud: PointCloud, mode: str):
    """(colour values, colour-map name) per point, as the JAX package's
    `viz._colors`; an (N, 3) array of RGB values comes with no map."""
    a = lambda n: as_numpy(getattr(cloud, n))
    if mode == "height":
        return a("position")[:, 1], "viridis"
    if mode == "intensity":
        v = a("intensity")
        hi = np.percentile(v, 98) if len(v) else 1.0
        return np.clip(v, 0, max(hi, 1e-12)), "inferno"
    if mode == "return_number":
        return a("return_number").astype(float), "tab10"
    if mode == "num_returns":
        return a("num_returns").astype(float), "tab10"
    if mode == "semantic":
        return a("semantic").astype(float), "tab20"
    if mode == "asprs":
        return a("asprs").astype(float), "tab20"
    if mode == "normal":
        return (np.abs(a("normal")) if a("normal").size else None), None
    if mode == "scan_angle":
        return a("scan_angle_rank"), "coolwarm"
    if mode == "scan_direction":
        return np.abs(a("scan_direction")), None
    if mode == "gps_time":
        return a("gps_time"), "plasma"
    if mode == "distance":
        return a("distance"), "magma"
    raise ValueError(f"unknown mode {mode!r}; one of {RENDER_MODES}")


def _colormap(values: np.ndarray, cmap: str) -> np.ndarray:
    """(N,) values -> (N, 3) RGB in [0, 1]: a ramp over the values' range,
    or a categorical palette indexed by the integer value."""
    v = np.asarray(values, np.float64)
    if cmap in ("tab10", "tab20"):
        pal = _TAB10 if cmap == "tab10" else _PALETTE
        return pal[np.asarray(np.nan_to_num(v), np.int64) % len(pal)]
    ramp = np.asarray(_RAMPS[cmap], np.float32)
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
    t = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    x = np.clip(t, 0.0, 1.0) * (len(ramp) - 1)
    i = np.minimum(x.astype(np.int64), len(ramp) - 2)
    f = (x - i)[:, None].astype(np.float32)
    return ramp[i] * (1 - f) + ramp[i + 1] * f


class _Canvas:
    """A white RGB image over a world rectangle, equal aspect, +y up."""

    def __init__(self, lo, hi, size: int, margin: int = 8):
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        span = np.maximum(hi - lo, 1e-9)
        self.scale = (size - 2 * margin) / float(span.max())
        w, h = (np.ceil(span * self.scale).astype(int) + 2 * margin)
        self.img = np.ones((h, w, 3), np.float32)
        self.lo, self.margin = lo, margin

    def pixels(self, xy):
        """World (N, 2) -> integer (col, row), row 0 at the top."""
        p = (np.asarray(xy, np.float64) - self.lo) * self.scale + self.margin
        col = np.floor(p[:, 0]).astype(np.int64)
        row = self.img.shape[0] - 1 - np.floor(p[:, 1]).astype(np.int64)
        return col, row

    def dots(self, xy, rgb, radius: int = 0):
        col, row = self.pixels(xy)
        rgb = np.broadcast_to(np.asarray(rgb, np.float32), (len(col), 3))
        h, w = self.img.shape[:2]
        for dc in range(-radius, radius + 1):
            for dr in range(-radius, radius + 1):
                c, r = col + dc, row + dr
                ok = (c >= 0) & (c < w) & (r >= 0) & (r < h)
                self.img[r[ok], c[ok]] = rgb[ok]

    def segments(self, a, b, rgb):
        """Line segments a[i] -> b[i] (world (N, 2)), one pixel wide."""
        a = np.asarray(a, np.float64).reshape(-1, 2)
        b = np.asarray(b, np.float64).reshape(-1, 2)
        for p, q in zip(a, b):
            n = int(np.ceil(np.abs(q - p).max() * self.scale)) + 2
            s = np.linspace(0.0, 1.0, n)[:, None]
            self.dots(p + (q - p) * s, rgb)


def _splat_radius(point_size: float) -> int:
    return max(int(round(np.sqrt(point_size))) - 1, 0)


def render_png(cloud: PointCloud, path: str, mode: str = "height",
               axes: tuple[int, int] = (0, 2), point_size: float = 0.5,
               dpi: int = 150, title: str | None = None) -> str:
    """Projection of the (compacted) cloud onto two axes, coloured by
    ``mode``: an image of 8 inches at ``dpi`` on its long side.  ``title``
    is accepted for the JAX signature and not drawn."""
    compact = cloud.compact_host()
    pos = as_numpy(compact.position)
    c, cmap = _colors(compact, mode)
    xy = pos[:, list(axes)]
    lo = xy.min(axis=0) if len(xy) else np.zeros(2)
    hi = xy.max(axis=0) if len(xy) else np.ones(2)
    canvas = _Canvas(lo, hi, int(8 * dpi))
    if len(xy):
        rgb = (np.zeros((len(xy), 3)) if c is None
               else c if np.ndim(c) == 2 else _colormap(c, cmap))
        canvas.dots(xy, np.clip(rgb, 0.0, 1.0), _splat_radius(point_size))
    write_png(path, canvas.img)
    return path


def render_all_modes(cloud: PointCloud, prefix: str, **kw) -> list[str]:
    return [render_png(cloud, f"{prefix}_{mode}.png", mode, **kw)
            for mode in RENDER_MODES]


def render_overlays(scene, cloud: PointCloud | None, cfg, path: str, *,
                    bvh=None, rays=None, num_rays: int = 200,
                    bvh_depth: int = 4, axes: tuple[int, int] = (0, 2),
                    point_size: float = 0.5, dpi: int = 150) -> str:
    """Scene-debug overlays: rays, BVH boxes, beam cone, max-range disc.

    The scripted equivalent of the reference viewer's overlay draws
    (`LiDARScene.cpp:269-330` + DrawRay3D/DrawAABB/beam-cone/max-range-disc
    classes): a 2D projection with
      * the point cloud (height-colored),
      * a subsample of sensor rays as origin -> max_range segments (or
        sensor -> point when no ``rays`` are given),
      * the top ``bvh_depth`` levels of BVH node AABBs as rectangles,
      * the sensor's max-range disc (circle around the TLS position /
        first ALS position), and
      * the beam FOV cone edges for TLS sensors.
    The image spans everything drawn, as the JAX package's autoscaled axes
    do.
    """
    ax0, ax1 = axes
    sel = lambda p: np.asarray(p, np.float64)[..., [ax0, ax1]]
    pts = np.zeros((0, 2))
    if cloud is not None:
        pos = as_numpy(cloud.compact_host().position).astype(np.float64)
        pts = sel(pos)
    sensor = np.asarray(
        cfg.tls_position if getattr(cfg, "is_terrestrial", True)
        else cfg.als_position, np.float64)
    rng_ = float(cfg.max_range)

    lines = []                              # (a (N, 2), b (N, 2), rgb)
    if rays is not None:                    # `DrawRay3D`
        o = as_numpy(rays.origin).astype(np.float64).reshape(-1, 3)
        d = as_numpy(rays.direction).astype(np.float64).reshape(-1, 3)
        step = max(len(o) // max(num_rays, 1), 1)
        o, d = o[::step], d[::step]
        lines.append((sel(o), sel(o + d * rng_), (1.0, 0.65, 0.0)))
    elif len(pts):
        step = max(len(pts) // max(num_rays, 1), 1)
        p = pts[::step]
        lines.append((np.broadcast_to(sel(sensor), p.shape), p,
                      (1.0, 0.65, 0.0)))
    if bvh is not None:                     # `DrawAABB`, top levels
        node_min = as_numpy(bvh.node_min)
        node_max = as_numpy(bvh.node_max)
        node_face = as_numpy(bvh.node_face)
        node_skip = as_numpy(bvh.node_skip)
        frontier = [(0, 0)]
        while frontier:
            node, depth = frontier.pop()
            (x0, y0), (x1, y1) = sel(node_min[node]), sel(node_max[node])
            corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            lines.append((corners, np.roll(corners, -1, axis=0),
                          (1.0, 0.0, 0.0)))
            if depth + 1 < bvh_depth and node_face[node] < 0:
                left = node + 1
                right = int(node_skip[left])
                frontier.append((left, depth + 1))
                if right < node_face.shape[0]:
                    frontier.append((right, depth + 1))
    # max-range disc
    ang = np.linspace(0.0, 2.0 * np.pi, 361)
    circle = sel(sensor) + rng_ * np.stack([np.cos(ang), np.sin(ang)], 1)
    lines.append((circle[:-1], circle[1:], (0.0, 0.0, 1.0)))
    # TLS beam cone edges (horizontal FOV wedge in the XZ projection)
    if getattr(cfg, "is_terrestrial", True) and axes == (0, 2):
        mid = np.deg2rad(getattr(cfg, "tls_middle_angle_horizontal", 0.0))
        half = np.deg2rad(getattr(cfg, "tls_fov_horizontal", 360.0)) / 2.0
        if half < np.pi:        # full-circle FOV has no wedge edges
            for aa in (mid - half, mid + half):
                e = sensor + rng_ * np.array([np.cos(aa), 0.0, np.sin(aa)])
                lines.append((sel(sensor)[None], sel(e)[None],
                              (0.0, 0.0, 1.0)))

    every = np.concatenate([pts] + [np.concatenate([a, b])
                                    for a, b, _ in lines])
    canvas = _Canvas(every.min(axis=0), every.max(axis=0), int(9 * dpi))
    if len(pts):
        canvas.dots(pts, _colormap(pos[:, 1], "viridis"),
                    _splat_radius(point_size))
    for a, b, rgb in lines:
        canvas.segments(a, b, rgb)
    canvas.dots(sel(sensor)[None], (0.0, 0.0, 1.0), 4)      # the sensor
    write_png(path, canvas.img)
    return path


# 20-entry categorical palette (tab20-like) for semantic/ASPRS face colors
_PALETTE = np.array([
    [0.12, 0.47, 0.71], [0.68, 0.78, 0.91], [1.00, 0.50, 0.05],
    [1.00, 0.73, 0.47], [0.17, 0.63, 0.17], [0.60, 0.87, 0.54],
    [0.84, 0.15, 0.16], [1.00, 0.60, 0.59], [0.58, 0.40, 0.74],
    [0.77, 0.69, 0.84], [0.55, 0.34, 0.29], [0.77, 0.61, 0.58],
    [0.89, 0.47, 0.76], [0.97, 0.71, 0.82], [0.50, 0.50, 0.50],
    [0.78, 0.78, 0.78], [0.74, 0.74, 0.13], [0.86, 0.86, 0.55],
    [0.09, 0.75, 0.81], [0.62, 0.85, 0.90]], np.float32)


def render_ortho(scene, path: str, *, mode: str = "kad", size: int = 512
                 ) -> dict:
    """Top-down orthographic backdrop for path drawing (no GL, no deps).

    The reference captures an aerial ortho view into an FBO texture and
    draws the TLS/ALS path canvas on top of it (`LiDARScene.cpp:118-163`,
    `GUI.cpp:160-272`).  Here: a numpy z-buffer rasterization of the scene
    faces onto the XZ plane, written as PNG by the bundled codec.

    Pixel coordinates ARE canvas coordinates: pixel (col u, row v) maps to
    world (x, z) exactly as `api.tls_path_from_canvas` /
    `SensorConfig.als_manual_path` map canvas points with
    ``canvas_size=(W, H)`` — so a path drawn in image pixels feeds those
    APIs unchanged (row 0 = min Z; flip vertically for display if you want
    +Z up).

    ``mode``: 'kad' (baked diffuse albedo), 'semantic', 'asprs', 'height'.
    Returns {path, canvas_size, world_min, world_size} (the mapping info).
    """
    V = as_numpy(scene.vertices).astype(np.float64)
    F = as_numpy(scene.faces)
    lo, hi = V.min(axis=0), V.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    W = H = int(size)
    # world -> pixel (match tls_path_from_canvas: world = px/W*size+min)
    px = (V[:, 0] - lo[0]) / span[0] * W
    pz = (V[:, 2] - lo[2]) / span[2] * H

    if mode == "kad":
        kad = as_numpy(scene.vertex_kad).astype(np.float64)
        fcol = kad[F].mean(axis=1)
    elif mode in ("semantic", "asprs"):
        labels = as_numpy(getattr(scene, f"comp_{mode}"))
        fcol = _PALETTE[labels[as_numpy(scene.face_comp)] % len(_PALETTE)]
    elif mode == "height":
        fy = V[F, 1].mean(axis=1)
        t = (fy - lo[1]) / span[1]
        fcol = np.stack([t, 0.2 + 0.6 * t, 1.0 - t], axis=1)
    else:
        raise ValueError(f"unknown ortho mode {mode!r}")

    img = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), -np.inf)
    tri_px = np.stack([px[F], pz[F]], axis=-1)          # (F, 3, 2)
    tri_y = V[F, 1]                                     # (F, 3)
    order = np.argsort(tri_y.mean(axis=1))              # low first
    for fi in order:
        t2 = tri_px[fi]
        x0, y0 = np.floor(t2.min(axis=0)).astype(int)
        x1, y1 = np.ceil(t2.max(axis=0)).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, W - 1), min(y1, H - 1)
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                             np.arange(y0, y1 + 1) + 0.5)
        a, b, c = t2[0], t2[1], t2[2]
        det = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
        if abs(det) < 1e-12:
            continue
        l1 = ((gx - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (gy - a[1])) / det
        l2 = ((b[0] - a[0]) * (gy - a[1]) - (gx - a[0]) * (b[1] - a[1])) / det
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        if not inside.any():
            continue
        depth = l0 * tri_y[fi, 0] + l1 * tri_y[fi, 1] + l2 * tri_y[fi, 2]
        sub_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (depth > sub_z)
        sub_z[upd] = depth[upd]
        img[y0:y1 + 1, x0:x1 + 1][upd] = fcol[fi]
    write_png(path, img)
    return {"path": path, "canvas_size": (W, H),
            "world_min": (float(lo[0]), float(lo[2])),
            "world_size": (float(span[0]), float(span[2]))}
