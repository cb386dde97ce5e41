"""Frozen material inputs: the 15 LiDAR materials' synthetic 360 x 91
retro-reflectance tables (a copy of the port's `io/materials.py::
synthetic_brdf_table`) and their per-material constants at 1064 nm, read
from `materials_1064nm.json` beside this file.  A dict of numpy arrays
named as the fields of the port's `MaterialTable`.
"""

from __future__ import annotations

import json
import os

import numpy as np

PHI_BUCKETS, THETA_BUCKETS = 360, 91
_HERE = os.path.dirname(os.path.abspath(__file__))


def synthetic_table(rough: float, mat_id: int) -> np.ndarray:
    """Diffuse floor, a retro-reflective lobe sharpening with 1 - rough and
    a small azimuthal anisotropy, clipped to [0, 1]."""
    phi = np.arange(PHI_BUCKETS)[:, None] / PHI_BUCKETS * 2 * np.pi
    cos_inc = np.arange(THETA_BUCKETS)[None, :] / (THETA_BUCKETS - 1.0)
    diffuse = 0.25 + 0.5 * rough
    lobe = (1.0 - rough) * np.power(cos_inc, 1.0 + 24.0 * (1.0 - rough))
    aniso = 0.05 * np.sin(phi * (2 + mat_id % 3) + mat_id)
    table = diffuse * cos_inc + lobe + aniso * cos_inc
    return np.clip(table, 0.0, 1.0).astype(np.float32)


def make_materials(name: str = "materials_1064nm.json") -> dict:
    with open(os.path.join(_HERE, name)) as f:
        raw = json.load(f)
    # the tables are built from the roughness as the port's registry
    # holds it (python floats, not their float32 roundings)
    tables = np.stack([synthetic_table(r, i)
                       for i, r in enumerate(raw["roughness_decimal"])])
    return dict(
        refractive_index=np.asarray(raw["refractive_index"], np.float32),
        roughness=np.asarray(raw["roughness_decimal"], np.float32),
        brdf_table=tables,
        brdf_model=np.asarray(raw["brdf_model"], np.int32),
        reflectivity_f0=np.asarray(raw["reflectivity_f0"], np.float32))
