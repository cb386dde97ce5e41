"""Packet (ray-tile) BVH traversal over the whole scene (counterpart of
`lidar_brdf_tpu/geom/packet.py`).

The traversal that needs no host cull: rays are tiled in order, T = 128
consecutive rays a tile, and each tile walks the threaded tree once,
descending into a node when any of its rays hits the node's box (classic
packet tracing).  The `Simulator` takes it for refracted bounce rays on
water scenes, for chunks whose tile beams or pulse cones are too wide to
cull, and for ``use_culled=False``.  The walk itself is
`kernels/packet.py::packet_traverse`: the CUDA kernel K4 on the card, its
plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import BVH, Hit, TriangleScene, as_numpy
from ..kernels.packet import TILE, packet_traverse


class PackedScene(NamedTuple):
    """Traversal-ready arrays on the compute device."""

    node_box: torch.Tensor    # (N, 6) f32 [min.xyz max.xyz]
    node_skip: torch.Tensor   # (N,)  i32
    node_face: torch.Tensor   # (N,)  i32 (leaf face id, -1 internal)
    tri_rows: torch.Tensor    # (F, 9) f32 [v0 e1 e2]


def triangle_rows(vertices: torch.Tensor,
                  faces: torch.Tensor) -> torch.Tensor:
    """(F, 9) f32 rows [v0 e1 e2] from detached vertices (the walk is
    forward-only).  A caller that moves the vertices (a geometry fit)
    builds them again and walks them over the same node arrays
    (``packed._replace(tri_rows=...)``), as the JAX package packs inside
    every traced call; the node boxes stay the BVH's."""
    with torch.no_grad():
        v = vertices.detach().float()
        f = faces.long()
        v0 = v[f[:, 0]]
        return torch.cat([v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0],
                         dim=1).contiguous()


def pack_scene(scene: TriangleScene, bvh: BVH) -> PackedScene:
    """The scene's triangle rows and the BVH's node arrays, on the scene's
    device.  Raises ValueError unless every skip link points forward (what
    bounds a walk's length)."""
    dev = scene.vertices.device
    skip = np.asarray(as_numpy(bvh.node_skip), np.int32)
    if (skip <= np.arange(skip.shape[0])).any():
        raise ValueError("a BVH skip link does not point forward")
    put = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(as_numpy(a), dt)).to(dev)
    node_box = torch.cat([put(bvh.node_min, np.float32),
                          put(bvh.node_max, np.float32)], dim=1)
    return PackedScene(node_box=node_box.contiguous(),
                       node_skip=torch.from_numpy(skip).to(dev),
                       node_face=put(bvh.node_face, np.int32),
                       tri_rows=triangle_rows(scene.vertices, scene.faces))


def intersect_packed_scene(packed: PackedScene, origin, direction, *,
                           steps=None) -> Hit:
    """Nearest-hit intersection by the packet walk.

    ``origin``/``direction``: (..., 3).  Rays are flattened and tiled in
    order (callers should pass coherent rays); the last tile is padded with
    rays at 1e10 of zero direction, which never hit.  ``steps``: see
    `packet_traverse` (one row per tile).  Forward-only: the rays are
    detached.
    """
    shape = origin.shape[:-1]
    o = origin.detach().reshape(-1, 3).float()
    d = direction.detach().reshape(-1, 3).float()
    n_rays = o.shape[0]
    pad = (-n_rays) % TILE
    if pad:
        o = torch.cat([o, o.new_full((pad, 3), 1e10)])
        d = torch.cat([d, d.new_zeros((pad, 3))])
    t, f = packet_traverse(*packed, o.contiguous(), d.contiguous(), steps)
    return Hit(t=t[:n_rays].reshape(shape), face=f[:n_rays].reshape(shape))


def make_packet_traverser(scene: TriangleScene, bvh: BVH):
    """Pack once; returns ``traverse(origin, direction) -> Hit``."""
    packed = pack_scene(scene, bvh)

    def traverse(origin, direction):
        return intersect_packed_scene(packed, origin, direction)

    return traverse
