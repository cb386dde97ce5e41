"""Arrays from the JAX package -> the port's dataclasses, and back.

The JAX package's scene, BVH, material table, rays, scalars and noise
buffers are handed over as numpy: a dict keyed by field name (`np.asarray`
of each field), or one array for a noise buffer.  These are the "weights" of this
system: with them both packages compute on identical inputs.  The port
never imports the JAX package; callers do the `np.asarray`.  The
inverse is `.numpy()` on any of the port's dataclasses, and on a gradient
(`tensor.grad.numpy()`).

A `MaterialLibrary` needs no converter: both packages keep it as a host
dataclass of numpy arrays with the same fields (spectral tables included),
so ``MaterialLibrary(**vars(jax_library))`` is the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import BVH, MaterialTable, PointCloud, RayBundle, TriangleScene


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _from_dict(cls, arrays: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = arrays.get(f.name)
        if v is None:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"{cls.__name__} needs field {f.name!r}")
            continue
        kw[f.name] = _tensor(v, device)
    return cls(**kw)


def scene_from_numpy(arrays: dict, device="cpu") -> TriangleScene:
    return _from_dict(TriangleScene, arrays, device)


def bvh_from_numpy(arrays: dict) -> BVH:
    """BVHs stay on the host (the beam cull walks them there)."""
    return _from_dict(BVH, arrays, "cpu")


def materials_from_numpy(arrays: dict, device="cpu") -> MaterialTable:
    return _from_dict(MaterialTable, arrays, device)


def rays_from_numpy(arrays: dict, device="cpu") -> RayBundle:
    return _from_dict(RayBundle, arrays, device)


def pointcloud_from_numpy(arrays: dict, device="cpu") -> PointCloud:
    """A JAX `PointCloud` (dense or compacted) as the port's, e.g. to write
    it with the port's `write_ply`."""
    return _from_dict(PointCloud, arrays, device)


def noise_from_numpy(buffer, device="cpu") -> torch.Tensor:
    """A noise buffer (sim or ray generation) as an f32 tensor."""
    return _tensor(np.asarray(buffer, np.float32), device)


def scalars_from_numpy(arrays: dict, device="cpu"):
    """The JAX package's `SimScalars` -> the port's, so that a test can
    differentiate a scalar such as ``peak_power`` on identical inputs."""
    from ..physics.returns import SimScalars
    return _from_dict(SimScalars, arrays, device)
