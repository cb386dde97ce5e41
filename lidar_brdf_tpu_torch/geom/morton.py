"""30-bit Morton codes for BVH construction.

Math parity with the reference kernel
`Assets/Shaders/Compute/BVHGeneration/computeMortonCodes-comp.glsl:17-55`
(expand 10 bits per axis, interleave x:y:z as 4x+2y+z over normalized scene
coordinates).  Host numpy, copied from `lidar_brdf_tpu/geom/morton.py`, and
the same codes on tensors (`morton3d_torch`, the counterpart of JAX's
`morton3d_jnp`).
"""

from __future__ import annotations

import numpy as np
import torch

_MASKS = (0xFF0000FF, 0x0F00F00F, 0xC30C30C3, 0x49249249)
_MULTS = (0x00010001, 0x00000101, 0x00000011, 0x00000005)


def expand_bits_np(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    for mult, mask in zip(_MULTS, _MASKS):
        v = (v * mult) & mask
    return v.astype(np.uint32)


def morton3d_np(points: np.ndarray, scene_min: np.ndarray,
                scene_max: np.ndarray) -> np.ndarray:
    """Morton code of points normalized to the scene AABB (numpy, uint32)."""
    extent = np.maximum(scene_max - scene_min, 1e-12)
    norm = (points - scene_min) / extent
    q = np.clip((norm * 1024.0).astype(np.uint32), 0, 1023)
    xx = expand_bits_np(q[..., 0]).astype(np.uint64)
    yy = expand_bits_np(q[..., 1]).astype(np.uint64)
    zz = expand_bits_np(q[..., 2]).astype(np.uint64)
    return (xx * 4 + yy * 2 + zz).astype(np.uint32)


def expand_bits_torch(v: torch.Tensor) -> torch.Tensor:
    """`expand_bits_np` on an integer tensor of 10-bit values, in int64 (the
    counterpart of JAX's `expand_bits_jnp`): each product stays below 2^49,
    and the masks keep only the low 32 bits that uint32 arithmetic would."""
    v = v.to(torch.int64)
    for mult, mask in zip(_MULTS, _MASKS):
        v = (v * mult) & mask
    return v


def morton3d_torch(points: torch.Tensor, scene_min: torch.Tensor,
                   scene_max: torch.Tensor) -> torch.Tensor:
    """Morton code of f32 points normalized to the scene AABB, as int64 (the
    counterpart of JAX's `morton3d_jnp`: the same f32 steps, truncation
    toward zero, clip to [0, 1023])."""
    extent = torch.clamp(scene_max - scene_min, min=1e-12)
    norm = (points - scene_min) / extent
    q = torch.clamp((norm * 1024.0).to(torch.int32), 0, 1023)
    xx = expand_bits_torch(q[..., 0])
    yy = expand_bits_torch(q[..., 1])
    zz = expand_bits_torch(q[..., 2])
    return xx * 4 + yy * 2 + zz
