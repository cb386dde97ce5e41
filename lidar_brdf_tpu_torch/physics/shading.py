"""Reflectance + radar equation over recorded returns (counterpart of
`lidar_brdf_tpu/physics/shading.py`; `computeColor-comp.glsl:84-100`).

Measured-table, analytic (`reflectIrradiance`) or Lambertian reflectance,
then the radar equation, with the bathymetric intensity branch.
"""

from __future__ import annotations

import torch

from ..core.config import SensorConfig, ShadingMode
from ..core.types import MaterialTable, TriangleScene
from ..utils.safemath import abs_, dot3, safe_unit
from .brdf import analytic_brdf_factor, measured_brdf_factor
from .intensity import bathymetric_intensity, radar_intensity
from .returns import SimScalars
from .types import ReturnRecord


def shade_records(scene: TriangleScene, materials: MaterialTable,
                  records: ReturnRecord, final_winner_origin,
                  scalars: SimScalars, cfg: SensorConfig,
                  num_rays_pulse: int) -> torch.Tensor:
    """Intensity for each (return level, pulse) record slot.

    ``final_winner_origin`` is the winner ray's origin after the bounce
    loop (on the water-free path, the record's start point).  In
    bathymetric mode a return whose pulse hit water at its previous return
    takes the bathymetric intensity.
    """
    rec_shape = records.mask.shape
    fl = lambda a: a.reshape((-1,) + tuple(a.shape[len(rec_shape):]))
    comp = fl(records.comp)
    point = fl(records.point)
    mat = scene.comp_material[torch.clamp(comp, min=0).long()]
    L = safe_unit(fl(final_winner_origin) - point)
    N = safe_unit(fl(records.normal))

    if cfg.shading_mode == ShadingMode.MEASURED:
        brdf = measured_brdf_factor(materials, mat, L, N,
                                    hermite_t=cfg.hermite_t,
                                    mode=cfg.brdf_interpolation)
    elif cfg.shading_mode == ShadingMode.ANALYTIC:
        # the reference passes the ray direction as the tangent too
        direction = fl(records.direction)
        brdf = analytic_brdf_factor(materials, mat, N, prev_dir=direction,
                                    angle_deg=fl(records.angle),
                                    tangent=direction)
    else:  # LAMBERTIAN
        brdf = abs_(dot3(L, N))

    ray_power = scalars.peak_power / float(num_rays_pulse)
    intensity = radar_intensity(
        fl(records.distance), ray_power, fl(records.num_intersected), brdf,
        sensor_diameter=scalars.sensor_diameter,
        reflectance_weight=scalars.reflectance_weight,
        atmospheric_attenuation=scalars.atmospheric_attenuation,
        system_attenuation=scalars.system_attenuation)
    if cfg.bathymetric:
        bathy = bathymetric_intensity(
            fl(records.distance), ray_power, brdf,
            start_point=fl(records.start), hit_point=point,
            prev_hit_point=fl(records.prev_point),
            direction=fl(records.direction),
            sensor_diameter=scalars.sensor_diameter,
            reflectance_weight=scalars.reflectance_weight,
            atmospheric_attenuation=scalars.atmospheric_attenuation,
            water_height=scalars.water_height)
        intensity = torch.where(fl(records.prev_was_water), bathy, intensity)
    mask = fl(records.mask)
    return torch.where(mask, intensity,
                       torch.zeros_like(intensity)).reshape(rec_shape)
