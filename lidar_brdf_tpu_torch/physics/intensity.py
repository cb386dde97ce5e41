"""Radar-equation intensity (counterpart of `radar_intensity` in
`lidar_brdf_tpu/physics/intensity.py`; `computeIntensity-comp.glsl:4-39`):

  I = P_pulse * D^2 * brdf * w_refl * atm(d) * att_sys / (4 d^2)
  atm(d) = 10^(-2 d a / 1e4)

The bathymetric variant is not ported yet.
"""

from __future__ import annotations

import torch

from ..utils.safemath import maximum


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
