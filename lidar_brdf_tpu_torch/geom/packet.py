"""Packet BVH traversal over the whole scene (counterpart of
`lidar_brdf_tpu/geom/packet.py`).

The traversal that needs no host cull: rays are cut in order into packets
of consecutive rays (`kernels/packet.py::PACKET`; the JAX package tiles
128), and each packet walks the threaded tree once, descending into a node
when any of its rays hits the node's box (classic packet tracing).  The
`Simulator` takes it for refracted bounce rays on water scenes, for chunks
whose tile beams or pulse cones are too wide to cull, and for
``use_culled=False``.  The walk itself is `kernels/packet.py::
packet_traverse`: the CUDA kernel K4 on the card, its plain version on the
CPU.  The walk also takes the rays' ``active`` mask, which the bounce
levels of `physics/returns.py` hand it: only those rays walk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import BVH, Hit, TriangleScene, as_numpy
from ..kernels.packet import PACKET, node_records, packet_traverse
from ..runtime.metrics import upload

DEFAULT_TILE = 128   # the JAX package's tile, one of K4's `WIDTHS`


class PackedScene(NamedTuple):
    """Traversal-ready arrays on the compute device.  Each field holds the
    JAX package's values; the three node arrays are views of one (N, 8)
    record and the rows a view of (F, 12) rows, the layouts K4 reads
    (`kernels/packet.py::node_records`, `triangle_rows`)."""

    node_box: torch.Tensor    # (N, 6) f32 [min.xyz max.xyz]
    node_skip: torch.Tensor   # (N,)  i32
    node_face: torch.Tensor   # (N,)  i32 (leaf face id, -1 internal)
    tri_rows: torch.Tensor    # (F, 9) f32 [v0 e1 e2]


def triangle_rows(vertices: torch.Tensor,
                  faces: torch.Tensor) -> torch.Tensor:
    """(F, 9) f32 rows [v0 e1 e2] from detached vertices (the walk is
    forward-only), a view of (F, 12) rows padded with zeros (48 bytes a
    row: three 16-byte loads in K4).  A caller that moves the vertices (a
    geometry fit) builds them again and walks them over the same node
    arrays (``packed._replace(tri_rows=...)``), as the JAX package packs
    inside every traced call; the node boxes stay the BVH's."""
    with torch.no_grad():
        v = vertices.detach().float()
        f = faces.long()
        v0 = v[f[:, 0]]
        rows = v.new_zeros((f.shape[0], 12))
        rows[:, 0:3] = v0
        rows[:, 3:6] = v[f[:, 1]] - v0
        rows[:, 6:9] = v[f[:, 2]] - v0
        return rows[:, :9]


def pack_bvh(bvh: BVH, device=None):
    """(node_box (N, 6) f32, node_skip (N,) i32, node_face (N,) i32), the
    JAX package's values, as views of one (N, 8) record
    (`kernels/packet.py::node_records`), on ``device`` (None: the BVH's
    own).  Raises ValueError unless every skip link points forward (what
    bounds a walk's length)."""
    if device is None:
        device = bvh.node_min.device if isinstance(bvh.node_min,
                                                   torch.Tensor) else "cpu"
    skip = np.asarray(as_numpy(bvh.node_skip), np.int32)
    if (skip <= np.arange(skip.shape[0])).any():
        raise ValueError("a BVH skip link does not point forward")
    host = lambda a, dt: torch.from_numpy(np.ascontiguousarray(as_numpy(a),
                                                               dt))
    nodes = upload(dict(node_min=host(bvh.node_min, np.float32),
                        node_max=host(bvh.node_max, np.float32),
                        node_skip=torch.from_numpy(skip),
                        node_face=host(bvh.node_face, np.int32)), device)
    box = torch.cat([nodes["node_min"], nodes["node_max"]], dim=1)
    return node_records(box, nodes["node_skip"], nodes["node_face"])


def pack_triangles(scene: TriangleScene) -> torch.Tensor:
    """(F, 9) f32 rows [v0 e1 e2] of the scene, on its device
    (`triangle_rows`)."""
    return triangle_rows(scene.vertices, scene.faces)


def pack_scene(scene: TriangleScene, bvh: BVH) -> PackedScene:
    """The scene's triangle rows and the BVH's node records, on the
    scene's device (`pack_triangles`, `pack_bvh`)."""
    return PackedScene(*pack_bvh(bvh, scene.vertices.device),
                       tri_rows=pack_triangles(scene))


def intersect_packed_scene(packed: PackedScene, origin, direction, *,
                           steps=None, active=None,
                           width: int = PACKET) -> Hit:
    """Nearest-hit intersection by the packet walk.

    ``origin``/``direction``: (..., 3).  Rays are flattened and cut into
    packets of ``width`` in order (callers should pass coherent rays).
    ``active``: None (every ray walks) or a bool mask of the rays' leading
    shape; an inactive ray's hit is the miss (t BIG, face -1).  ``steps``:
    see `packet_traverse` (one row per packet).  Forward-only: the rays
    are detached.
    """
    shape = origin.shape[:-1]
    o = origin.detach().reshape(-1, 3).float().contiguous()
    d = direction.detach().reshape(-1, 3).float().contiguous()
    a = None if active is None else active.reshape(-1).contiguous()
    t, f = packet_traverse(*packed, o, d, steps, active=a, width=width)
    return Hit(t=t.reshape(shape), face=f.reshape(shape))


def intersect_packed(nodes, tris, origin, direction, *,
                     tile: int = DEFAULT_TILE) -> Hit:
    """The walk over the (node_box, node_skip, node_face) triple of
    `pack_bvh` and the rows of `pack_triangles`, in packets of ``tile``
    rays (one of `kernels/packet.py::WIDTHS`; another raises ValueError).
    The default is the JAX tile; `make_packet_traverser` walks one ray a
    packet."""
    return intersect_packed_scene(PackedScene(*nodes, tri_rows=tris), origin,
                                  direction, width=tile)


def make_packet_traverser(scene: TriangleScene, bvh: BVH, nodes=None):
    """Pack once; returns ``traverse(origin, direction, active=None) ->
    Hit`` (`intersect_packed_scene`), the ``packet_fn`` contract of
    `physics/returns.py::simulate_returns`.  ``nodes``: the BVH's node
    records already on the scene's device (`pack_bvh`), to share one pack
    with the cull; None packs them here."""
    packed = (pack_scene(scene, bvh) if nodes is None else
              PackedScene(*nodes, tri_rows=pack_triangles(scene)))

    def traverse(origin, direction, active=None):
        return intersect_packed_scene(packed, origin, direction,
                                      active=active)

    return traverse
