"""High-level user API (counterpart of `lidar_brdf_tpu/api.py`).

scene + config -> point cloud, plus builder helpers.  Every entry point
runs on ``device="cuda"`` unless the caller passes ``device="cpu"``; without
a card the default raises instead of quietly using the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.config import LiDARType, SensorConfig
from .core.types import (BVH, MaterialTable, PointCloud, RayBundle,
                         TriangleScene, as_numpy, resolve_device)
from .geom.bvh import build_bvh
from .io.materials import MaterialLibrary
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
    over ``scene``'s bounding box with ``np.random.default_rng(seed)``."""
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
    the configured wavelength.  Returns a host PointCloud.  ``stats`` as in
    `Simulator.run`; ``noise_buf`` overrides the sim-noise buffer."""
    dev = resolve_device(device)
    if materials is None:
        materials = MaterialLibrary.default().table_at(cfg.wavelength_nm[0])
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
