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

The analytic models of `reflectIrradiance-comp.glsl` (`analytic_brdf_factor`)
are plain element-wise PyTorch, as the JAX package computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import BRDFInterpolation
from ..core.types import MaterialTable
from ..utils.safemath import (abs_, clip, cross3, dot3, maximum, minimum,
                              safe_arccos, safe_arctan2)

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


# ---------------------------------------------------------------------------
# Analytic BRDF library (`reflectIrradiance-comp.glsl`), as in
# `lidar_brdf_tpu/physics/brdf.py:260-406`.  Shared conventions:
#   normal        N  = hit normal
#   prev_dir      I  = incoming ray direction (unit, pointing at surface)
#   reflect_dir   V  = normalize(-I)  (back toward sensor; retro-geometry)
#   angle         a  = collision scan angle in *degrees mapped to [0,90]*;
#                      the kernel calls cos(angle) on that value, quirky but
#                      reproduced for parity via the caller-provided `cos_a`.
# Every model is evaluated on every slot and one is picked per material, as
# the JAX package does, so both see the same values (and the same 0 * inf
# in a backward through a model that is not picked).
# ---------------------------------------------------------------------------

BLINN_PHONG_ROUGHNESS_MULTIPLIER = 100.0
MINNAERT_K = 1.5
WARD_ALPHA = (0.15, 0.75)
EPS = 1e-8
_PI = float(PI)


def _norm(v):
    """`jnp.linalg.norm(v, axis=-1, keepdims=True)`."""
    return torch.sqrt(dot3(v, v))[..., None]


def _half_vector(v, l):
    h = v + l
    return h / maximum(_norm(h), EPS)


def _nonzero(x):
    """x where |x| >= EPS, else EPS (the kernel's guarded divisors)."""
    return torch.where(torch.abs(x) < EPS, x.new_full((), EPS), x)


def ideal_specular(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    # `idealSpecular`: note the kernel reflects (normal, prev_dir) in that
    # argument order, i.e. reflect(N, I) = N - 2*dot(I,N)*I.
    perfect = N - 2.0 * dot3(I, N)[..., None] * I
    perfect = perfect / maximum(_norm(perfect), EPS)
    d = torch.abs(dot3(perfect, V))
    return torch.where(d < EPS, ks, torch.zeros_like(ks))


def ideal_diffuse(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    return kd * cos_a


def minnaert(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    d = dot3(N, V)
    return kd * torch.pow(maximum(cos_a * d, EPS), MINNAERT_K - 1.0)


def blinn_phong(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    h = _half_vector(V, -I)
    return (kd * cos_a
            + ks * torch.pow(maximum(dot3(N, h), EPS),
                             rough * BLINN_PHONG_ROUGHNESS_MULTIPLIER))


def cook_torrance(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    """`cookTorrance` (:96-112): Beckmann-style NDF, min-Smith geometry with
    roughness flip, Schlick Fresnel on max(F0) channel."""
    h = _half_vector(V, -I)
    dot_nh = dot3(h, N)
    nd_rough = maximum(rough, 1e-3)
    # normal distribution (uses material roughness)
    nh2 = maximum(dot_nh * dot_nh, 1e-6)
    r2 = nd_rough * nd_rough
    normal_dist = (1.0 / (r2 * nh2 * nh2)) * torch.exp((nh2 - 1.0)
                                                       / (r2 * nh2))
    # geometry term (uses 1 - roughness, per the kernel)
    dot_nl = dot3(N, -I)
    dot_nv = dot3(N, V)
    dot_hv = dot3(h, V)
    g1 = (2.0 * dot_nh * dot_nv) / _nonzero(dot_hv)
    g2 = (2.0 * dot_nh * dot_nl) / _nonzero(dot_hv)
    geom = minimum(torch.minimum(g1, g2), 1.0)
    # fresnel (jnp.max shares the gradient among equal channels, as amax)
    f = f0 + (1.0 - f0) * torch.pow(clip(1.0 - dot_nh, 0.0, 1.0),
                                    5.0)[..., None]
    fres = torch.amax(f, dim=-1)
    denom = _PI * _nonzero(cos_a) * _nonzero(dot_nv)
    return (kd * cos_a + ks / _PI
            + ks * (fres * geom * normal_dist) / denom)


def ward_anisotropic(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    h = _half_vector(V, -I)
    binormal = cross3(tangent, N)
    binormal = binormal / maximum(_norm(binormal), EPS)
    dot_ln = clip(dot3(-I, N), 0.0, 1.0)
    dot_nv = clip(dot3(N, V), 0.0, 1.0)
    dot_hx = dot3(h, tangent)
    dot_hy = dot3(h, binormal)
    dot_hn = dot3(h, N)
    ax, ay = WARD_ALPHA
    a_term = (dot_hx / ax) ** 2 + (dot_hy / ay) ** 2
    exp_factor = -2.0 * a_term / maximum(1.0 + dot_hn, EPS)
    spec = (1.0 / (4.0 * _PI * ax * ay
                   * torch.sqrt(maximum(dot_ln * dot_nv, 0.1))))
    return kd * cos_a + ks * spec * torch.exp(exp_factor)


def oren_nayar(kd, ks, N, I, V, rough, f0, cos_a, tangent):
    dot_ln = clip(dot3(-I, N), 0.0, 1.0)
    dot_nv = clip(dot3(N, V), 0.0, 1.0)
    beta = safe_arccos(dot_ln)
    alpha = safe_arccos(dot_nv)
    r2 = rough * rough
    A = 1.0 - 0.5 * (r2 / (r2 + 0.33))
    B = 0.45 * (r2 / (r2 + 0.09))
    return kd * (A + B * maximum(dot_nv - dot_ln, 0.0)
                 * torch.sin(torch.maximum(alpha, beta))
                 * torch.cos(torch.minimum(alpha, beta)))


_MODELS = [ideal_specular, ideal_diffuse, minnaert, blinn_phong,
           cook_torrance, ward_anisotropic, oren_nayar]


def analytic_brdf_factor(materials: MaterialTable, mat_id, N, prev_dir,
                         angle_deg, tangent, kd=1.0, ks=1.0):
    """Vectorized `reflectIrradiance`: evaluate all models, select by the
    per-material model id, clamp to [0, 1].

    ``angle_deg`` is the collision scan angle in the reference's [0, 90]
    convention; the kernel takes cos() of it directly (radians-of-degrees
    quirk preserved).  ZOHDI has no kernel implementation (switch falls
    through to 0), reproduced here by mapping it to zero.
    """
    I = prev_dir  # noqa: E741  (match GLSL naming)
    V = -I / maximum(_norm(I), EPS)
    mat_id = mat_id.long()
    rough = materials.roughness[mat_id]
    f0 = materials.reflectivity_f0[mat_id]
    model = materials.brdf_model[mat_id]
    cos_a = torch.cos(angle_deg)
    kd = torch.broadcast_to(torch.as_tensor(kd, dtype=torch.float32,
                                            device=cos_a.device), cos_a.shape)
    ks = torch.broadcast_to(torch.as_tensor(ks, dtype=torch.float32,
                                            device=cos_a.device), cos_a.shape)
    vals = torch.stack([fn(kd, ks, N, I, V, rough, f0, cos_a, tangent)
                        for fn in _MODELS], dim=-1)
    n = len(_MODELS)
    sel = torch.clamp(model, 0, n)          # ZOHDI (7) -> out of range
    picked = torch.gather(vals, -1, torch.clamp(sel, max=n - 1)
                          .long()[..., None])[..., 0]
    picked = torch.where(sel >= n, torch.zeros_like(cos_a), picked)
    return clip(picked, 0.0, 1.0)
