"""High-level user API (counterpart of `lidar_brdf_tpu/api.py`).

scene + config -> point cloud, plus builder helpers.  Every entry point
runs on ``device="cuda"`` unless the caller passes ``device="cpu"``; without
a card the default raises instead of quietly using the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .core.config import LiDARType, SensorConfig
from .core.types import (BVH, MaterialTable, PointCloud, RayBundle,
                         TriangleScene, as_numpy, resolve_device)
from .geom.bvh import build_bvh
from .io.materials import MaterialLibrary
from .runtime.metrics import span
from .runtime.simulate import Simulator
from .sensors.als import build_als_rays, plan_flight
from .sensors.tls import build_tls_rays, num_tls_pulses
from .utils import noise as noise_mod


def build_scene_bvh(scene: TriangleScene) -> BVH:
    return build_bvh(as_numpy(scene.vertices), as_numpy(scene.faces))


def attach_face_neighbors(scene: TriangleScene) -> TriangleScene:
    """Scene with the precomputed contiguity table (geom/adjacency.py);
    unchanged when the table would exceed its width cap or is already
    attached.  The footprint merge gives the same result either way
    (`reduceCollisions-comp.glsl:54-62`)."""
    if scene.face_neighbors is not None:
        return scene
    from .geom.adjacency import build_face_neighbors
    table = build_face_neighbors(as_numpy(scene.faces),
                                 as_numpy(scene.face_comp))
    if table is None:
        return scene
    return dataclasses.replace(
        scene, face_neighbors=torch.from_numpy(table).to(
            scene.faces.device))


def build_rays(cfg: SensorConfig, scene: TriangleScene | None = None,
               seed: int | None = None, device="cuda",
               raygen_noise: torch.Tensor | None = None) -> RayBundle:
    """The full scan's rays for the configured sensor.  The ray-generation
    buffer is drawn from a CPU generator seeded with ``seed + 1`` (seed
    defaults to ``cfg.seed``), so a seed gives the same rays on every
    device; ``raygen_noise`` overrides it.  Aerial modes plan the flight
    over ``scene``'s bounding box with ``np.random.default_rng(seed)``.  A
    span ``lbt.rays``."""
    with span("lbt.rays"):
        return _build_rays(cfg, scene, seed, device, raygen_noise)


def _build_rays(cfg, scene, seed, device, raygen_noise) -> RayBundle:
    dev = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    if raygen_noise is None:
        raygen_noise = noise_mod.make_raygen_noise(seed + 1)
    raygen_noise = raygen_noise.to(dev)
    if cfg.lidar_type == LiDARType.TERRESTRIAL_SPHERICAL:
        count = None
        if cfg.use_simulation_time:
            # time-based ray budget (`getNumSimulatedRays`)
            count = int(num_tls_pulses(cfg) * cfg.scan_frequency_hz
                        * cfg.simulation_time)
        return build_tls_rays(cfg, raygen_noise, count=count)
    if scene is None:
        raise ValueError("aerial scans need the scene to plan the flight")
    lo, hi = scene.aabb()
    plan = plan_flight(cfg, as_numpy(lo), as_numpy(hi),
                       np.random.default_rng(seed))
    return build_als_rays(cfg, plan, raygen_noise)


def simulate(scene: TriangleScene, cfg: SensorConfig,
             materials: MaterialTable | None = None, bvh: BVH | None = None,
             rays: RayBundle | None = None, device="cuda",
             stats: dict | None = None,
             noise_buf: torch.Tensor | None = None) -> PointCloud:
    """One-call simulation: rays -> traversal -> returns -> intensity, at
    the configured wavelength.  Returns a host PointCloud (on the card,
    compacted: see `Simulator`).  ``stats`` as in
    `Simulator.run`; ``noise_buf`` overrides the sim-noise buffer.  A span
    ``lbt.simulate`` over ``lbt.rays``, ``lbt.construct`` and ``lbt.run``."""
    with span("lbt.simulate"):
        dev = resolve_device(device)
        if materials is None:
            materials = MaterialLibrary.default().table_at(
                cfg.wavelength_nm[0])
        if bvh is None:
            bvh = build_scene_bvh(scene)
        if rays is None:
            rays = build_rays(cfg, scene, device=dev)
        sim = Simulator(scene=scene, bvh=bvh, materials=materials, cfg=cfg,
                        device=dev, noise_buf=noise_buf)
        return sim.run(rays, stats=stats)


def simulate_spectral(scene: TriangleScene, cfg: SensorConfig,
                      library: MaterialLibrary | None = None,
                      bvh: BVH | None = None, rays: RayBundle | None = None,
                      device="cuda", noise_buf: torch.Tensor | None = None
                      ) -> dict[int, PointCloud]:
    """Wavelength sweep: one simulation per nm in ``cfg.wavelength_nm``
    (the reference's per-wavelength loop, `LiDARSimulation.cpp:303`).

    As the reference re-binds only the per-wavelength material tables
    (`prepareMaterialData`, cpp:428-437), one `Simulator` serves every
    wavelength through ``run(materials=...)``; a change of the bathymetric
    flag (green aerial wavelengths, below 533 nm) takes a second one, since
    it changes the physics.  ``noise_buf`` overrides the sim-noise buffer.
    Returns host PointClouds by wavelength.
    """
    dev = resolve_device(device)
    library = library or MaterialLibrary.default()
    bvh = bvh if bvh is not None else build_scene_bvh(scene)
    if rays is None:
        rays = build_rays(cfg, scene, device=dev)
    out: dict[int, PointCloud] = {}
    sims: dict[bool, Simulator] = {}
    lo, hi = cfg.wavelength_nm
    for wl in range(int(lo), int(hi) + 1):
        materials = library.table_at(wl)
        bathy = bool(wl < 533
                     and cfg.lidar_type != LiDARType.TERRESTRIAL_SPHERICAL)
        if bathy not in sims:
            sims[bathy] = Simulator(scene=scene, bvh=bvh, materials=materials,
                                    cfg=cfg.with_(bathymetric=bathy),
                                    device=dev, noise_buf=noise_buf)
        out[wl] = sims[bathy].run(rays, materials=materials)
    return out


def tls_path_from_canvas(points_2d, canvas_size, scene: TriangleScene,
                         height: float,
                         douglas_peucker_epsilon: float = 3.0) -> np.ndarray:
    """User-drawn 2-D canvas path -> world-space TLS scan positions (host
    numpy; the scene's bounding box is read from its tensors).

    Reference `LiDARSimulation::getTLSPath` (LiDARSimulation.cpp:161-187):
    redundant-point removal + Douglas-Peucker, then canvas -> scene XZ
    mapping with constant height.
    """
    from .sensors.paths import douglas_peucker, remove_redundant_points
    lo, hi = (as_numpy(a) for a in scene.aabb())
    pts = remove_redundant_points(np.asarray(points_2d, np.float32))
    pts = douglas_peucker(pts, douglas_peucker_epsilon)
    scene_size = np.array([hi[0] - lo[0], hi[2] - lo[2]])
    scene_min = np.array([lo[0], lo[2]])
    world = pts * scene_size / np.asarray(canvas_size, np.float64) + scene_min
    return np.stack([world[:, 0], np.full(len(world), height),
                     world[:, 1]], axis=1).astype(np.float32)


def loss_curve(cfg: SensorConfig, num_samples: int = 256) -> tuple:
    """Per-return loss probability as a function of shininess (the GUI's
    ImPlot preview, `GUI.cpp:33-71,736-760`; host numpy): threshold below
    ``loss_threshold``, else mult*(s+add)^power clamped to [0,1]."""
    s = np.linspace(0.0, 1.0, num_samples)
    loss = np.where(
        s < cfg.loss_threshold, 0.0,
        cfg.loss_mult_coefficient
        * np.power(np.maximum(s + cfg.loss_add_coefficient, 0.0),
                   cfg.loss_power))
    return s, np.clip(loss, 0.0, 1.0)


def simulate_tls_path(scene: TriangleScene, cfg: SensorConfig,
                      positions: np.ndarray,
                      materials: MaterialTable | None = None,
                      bvh: BVH | None = None, out_dir: str | None = None,
                      device="cuda") -> list[PointCloud]:
    """TLS multi-position simulation along a path of scan positions.

    Reference `LiDARSimulation::launchMultipleSimulations`
    (LiDARSimulation.cpp:211-286): per waypoint, scan with position =
    waypoint and direction toward the next waypoint; one host cloud per
    position.  With ``out_dir``, each cloud is written to
    ``<out_dir>/<i>.ply`` on a background writer thread while the next
    waypoint simulates — the reference's detached-thread save
    (`Results/Paths/TLS/<i>.ply`, LiDARPointCloud.cpp:56-61).  A span
    ``lbt.path`` over each waypoint's ``lbt.rays``, ``lbt.construct`` and
    ``lbt.run``, and the writer thread's ``lbt.ply_write``.
    """
    with span("lbt.path"):
        return _simulate_tls_path(scene, cfg, positions, materials, bvh,
                                  out_dir, device)


def _simulate_tls_path(scene, cfg, positions, materials, bvh, out_dir,
                       device) -> list[PointCloud]:
    dev = resolve_device(device)
    positions = np.asarray(positions, np.float32)
    if materials is None:
        materials = MaterialLibrary.default().table_at(cfg.wavelength_nm[0])
    bvh = bvh if bvh is not None else build_scene_bvh(scene)
    writer = None
    if out_dir is not None:
        from .io.ply import AsyncPlyWriter
        os.makedirs(out_dir, exist_ok=True)
        writer = AsyncPlyWriter()
    clouds = []
    try:
        for i, pos in enumerate(positions):
            if i + 1 < len(positions):
                direction = positions[i + 1] - pos
            else:
                direction = np.zeros(3, np.float32)
            pos_cfg = cfg.with_(
                tls_position=tuple(float(x) for x in pos),
                tls_direction=tuple(float(x) for x in direction))
            rays = build_rays(pos_cfg, scene, device=dev)
            sim = Simulator(scene=scene, bvh=bvh, materials=materials,
                            cfg=pos_cfg, device=dev)
            cloud = sim.run(rays)
            clouds.append(cloud)
            if writer is not None:
                writer.submit(os.path.join(out_dir, f"{i}.ply"), cloud)
    finally:
        if writer is not None:
            writer.close()
    return clouds
