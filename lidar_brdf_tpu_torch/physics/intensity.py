"""Radar-equation intensity (counterpart of
`lidar_brdf_tpu/physics/intensity.py`; `computeIntensity-comp.glsl:4-39`):

  I = P_pulse * D^2 * brdf * w_refl * atm(d) * att_sys / (4 d^2)
  atm(d) = 10^(-2 d a / 1e4)

plus the bathymetric variant, used when the previous return of the pulse
hit a water surface under a green (<533 nm) aerial scan: refraction
geometry through the interface with exponential depth decay.  All
differentiable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.safemath import maximum, safe_arccos, safe_unit

PI = float(np.float32(3.1415926535))
WATER_DIFFUSE_MAX = 0.5                       # max of vec3(0.45, 0.48, 0.5)
WATER_REFRACTIVE = float(np.float32(1.33))


def atmospheric_factor(distance, attenuation):
    """`getAttenuation`: 10^(-2 d a / 10^4)."""
    return torch.pow(10.0, -2.0 * distance * attenuation / 1.0e4)


def radar_intensity(distance, ray_power, num_intersected_rays, brdf_factor,
                    *, sensor_diameter, reflectance_weight,
                    atmospheric_attenuation, system_attenuation):
    """Standard (non-bathymetric) return intensity."""
    d2 = maximum(distance * distance, 1e-12)
    pulse_power = ray_power * num_intersected_rays.to(torch.float32)
    diam2 = sensor_diameter * sensor_diameter
    atm = atmospheric_factor(distance, atmospheric_attenuation)
    return (pulse_power * diam2 * brdf_factor * reflectance_weight
            * atm * system_attenuation) / (4.0 * d2)


def _away_from_zero(x, eps: float):
    """``x``, with ``eps`` where |x| < eps (the JAX package's guard)."""
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def bathymetric_intensity(distance, ray_power, brdf_factor, *,
                          start_point, hit_point, prev_hit_point, direction,
                          sensor_diameter, reflectance_weight,
                          atmospheric_attenuation, water_height):
    """`computeBathymetricIntensity`: underwater return through refraction.

    ``prev_hit_point`` is the water-surface collision of the same pulse;
    ``direction`` is the refracted in-water ray direction.
    """
    receiver_area = PI * (sensor_diameter / 2.0) ** 2
    altitude = start_point[..., 1] - water_height
    depth = water_height - hit_point[..., 1]
    tdir = safe_unit(prev_hit_point - start_point)
    transmit_cos = -tdir[..., 1]                      # dot(tdir, (0,-1,0))
    denom = WATER_REFRACTIVE * altitude + depth
    water_angle = safe_arccos(-direction[..., 1])
    hyp = depth / _away_from_zero(torch.cos(water_angle), 1e-6)
    sinus = torch.sin(water_angle) * hyp
    atm = atmospheric_factor(distance, atmospheric_attenuation)
    intensity = (ray_power * brdf_factor * receiver_area
                 * transmit_cos * transmit_cos * reflectance_weight
                 * atm * 100.0) / (PI * maximum(denom * denom, 1e-12))
    decay = torch.exp(-2.0 * WATER_DIFFUSE_MAX * depth * hyp
                      / _away_from_zero(sinus, 1e-6))
    return intensity * decay
