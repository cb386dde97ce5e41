"""Measured-BRDF table lookups (counterpart of the measured half of
`lidar_brdf_tpu/physics/brdf.py`).

Each material has a 360x91 retro-reflectance table f_r(phi, theta)
(`computeColor-comp.glsl:32-82`).  A lookup maps the surface-to-sensor
direction L and the normal N to (x = azimuth bucket, y = |cos(L,N)| * 90)
and interpolates raw, bilinear or cubic Hermite.  The JAX package routes
the neighbourhood reads through custom VJPs (`_bilinear_windows`,
`_hermite_windows`) because scatter is slow on a TPU; their backward
scatter-adds each element cotangent into the table.  Here the reads are
plain indexing, and autograd's index backward (an accumulating
`index_put_`) scatters the same cotangents into the same elements.
The analytic BRDF models are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import BRDFInterpolation
from ..core.types import MaterialTable
from ..utils.safemath import abs_, clip, dot3, safe_arctan2

PHI_BUCKETS = 360
THETA_BUCKETS = 91
# f32 constants exactly as the JAX package forms them (f32 arithmetic)
PI = np.float32(3.1415926535)
_HALF_PI = float(PI / np.float32(2.0))
_DEG = float(np.float32(180.0) / PI)


def table_angles(L, N):
    """(x, y) table coordinates (`computeColor-comp.glsl:72-82`):
    y = |dot(L, N)| * 90, x = (atan2(L.z, L.x) + pi/2) * 2 in degrees mod 360.
    """
    cos_ln = abs_(dot3(L, N))
    y = clip(cos_ln, 0.0, 1.0) * _HALF_PI * _DEG
    x = (safe_arctan2(L[..., 2], L[..., 0]) + _HALF_PI) * 2.0 * _DEG
    x = torch.remainder(x, 360.0)
    return x, y


def _flat_index(mat, xi, yi):
    return (mat.long() * (PHI_BUCKETS * THETA_BUCKETS)
            + xi.long() * THETA_BUCKETS + yi.long())


def lookup_raw(tables, mat_id, x, y):
    """Nearest-bucket lookup (`getRawInterpolation`)."""
    xi = torch.remainder(x.to(torch.int32), PHI_BUCKETS)
    yi = torch.clamp(y.to(torch.int32), 0, THETA_BUCKETS - 1)
    mat = torch.broadcast_to(torch.as_tensor(mat_id, device=xi.device), xi.shape)
    return tables.reshape(-1)[_flat_index(mat, xi, yi)]


def lookup_bilinear(tables, mat_id, x, y):
    """Bilinear lookup (`getLinearInterpolation`); the upper y neighbour
    clamps to 89, as the reference does (:41)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xf = x - x0
    yf = y - y0
    x0i = torch.remainder(x0.to(torch.int32), PHI_BUCKETS)
    y0i = torch.clamp(y0.to(torch.int32), 0, THETA_BUCKETS - 1)
    x1i = torch.remainder(x0i + 1, PHI_BUCKETS)
    y1i = torch.clamp(y0i + 1, 0, THETA_BUCKETS - 2)
    mat = torch.broadcast_to(torch.as_tensor(mat_id, device=x0i.device),
                             x0i.shape)
    flat = tables.reshape(-1)
    v00 = flat[_flat_index(mat, x0i, y0i)]
    v10 = flat[_flat_index(mat, x1i, y0i)]
    v01 = flat[_flat_index(mat, x0i, y1i)]
    v11 = flat[_flat_index(mat, x1i, y1i)]
    return (v00 * (1 - xf) * (1 - yf) + v10 * xf * (1 - yf)
            + v01 * (1 - xf) * yf + v11 * xf * yf)


def hermite_matrix(t: float, device="cpu") -> torch.Tensor:
    """Cardinal-spline basis with tension ``t`` (row-major 4x4,
    `LiDARSimulation.cpp:412-417`)."""
    return torch.tensor([
        [-t, 2.0 - t, t - 2.0, t],
        [2.0 * t, t - 3.0, 3.0 - 2.0 * t, -t],
        [-t, 0.0, t, 0.0],
        [0.0, 1.0, 0.0, 0.0],
    ], dtype=torch.float32, device=device)


def lookup_hermite(tables, mat_id, x, y, hermite):
    """Separable cubic-Hermite lookup (`getHermiteInterpolation`,
    `computeColor-comp.glsl:49-70`): a spline along x on row clip(yi-1),
    plus one along y on column (xi-1) mod 360, summed.  ``hermite`` is the
    4x4 basis, a tensor or nested lists of floats."""
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    xf = x - x0f
    yf = y - y0f
    xi = torch.remainder(x0f.to(torch.int32), PHI_BUCKETS)
    yi = torch.clamp(y0f.to(torch.int32), 0, THETA_BUCKETS - 1)
    mat = torch.broadcast_to(torch.as_tensor(mat_id, device=xi.device),
                             xi.shape)
    flat = tables.reshape(-1)
    y_row = torch.clamp(yi - 1, 0, THETA_BUCKETS - 1)
    x_col = torch.remainder(xi - 1, PHI_BUCKETS)
    rx = [flat[_flat_index(mat, torch.remainder(xi + k - 1, PHI_BUCKETS),
                           y_row)] for k in range(4)]
    ry = [flat[_flat_index(mat, x_col,
                           torch.clamp(yi + k - 1, 0, THETA_BUCKETS - 1))]
          for k in range(4)]

    # explicit multiply-adds, no matmul (the JAX package keeps the spline
    # off the matrix unit for the same full-f32 reason)
    def spline(r, f):
        c = [hermite[j][0] * r[0] + hermite[j][1] * r[1]
             + hermite[j][2] * r[2] + hermite[j][3] * r[3]
             for j in range(4)]
        return ((c[0] * f + c[1]) * f + c[2]) * f + c[3]

    return spline(rx, xf) + spline(ry, yf)


def measured_brdf_factor(materials: MaterialTable, mat_id, L, N,
                         hermite_t: float = 0.5,
                         mode: BRDFInterpolation = BRDFInterpolation.HERMITE):
    """BRDF factor from the measured tables, clamped to [0, 1]
    (`computeColor-comp.glsl:74-82`)."""
    x, y = table_angles(L, N)
    tables = materials.brdf_table
    if mode == BRDFInterpolation.RAW:
        val = lookup_raw(tables, mat_id, x, y)
    elif mode == BRDFInterpolation.BILINEAR:
        val = lookup_bilinear(tables, mat_id, x, y)
    else:
        # the basis as host floats: a device copy would sync every call
        val = lookup_hermite(tables, mat_id, x, y,
                             hermite_matrix(hermite_t).tolist())
    return clip(val, 0.0, 1.0)
