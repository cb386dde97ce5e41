"""Core dataclasses of the PyTorch port: plain dataclasses of tensors.

Counterpart of `lidar_brdf_tpu/core/types.py`.  Every field is a separate
dense tensor (structure of arrays); validity is a mask.  A cloud is
compacted only on its way off the device (`pack_compact`) or to a file
(`PointCloud.compact_host`).
Host-built structures (scenes, BVHs, material tables) start on the CPU and
move to the compute device with `.to(device)`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

Array = torch.Tensor

# Sentinel for "no face" / "no hit" (`findBVHCollision-comp.glsl:105-107`).
NO_HIT = np.int32(-1)

# Surface flags (reference: `reduceCollisions-comp.glsl:8-9`).
SURFACE_TERRAIN = 1 << 0
SURFACE_WATER = 1 << 1


def resolve_device(device) -> torch.device:
    """The compute device an entry point runs on.

    ``"cuda"`` (the default of every entry point) raises when no card is
    present: the port never drops to the CPU unless the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


class _TensorFields:
    """`.to(device)` over every tensor field (None fields pass through)."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if isinstance(v, torch.Tensor) else v
        return type(self)(**kw)

    def numpy(self) -> dict:
        """Field name -> numpy array (None fields omitted)."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


@dataclass
class TriangleScene(_TensorFields):
    """Aggregated triangle soup (see `lidar_brdf_tpu.core.types`)."""

    vertices: torch.Tensor          # (V, 3) f32
    faces: torch.Tensor             # (F, 3) i32
    face_normals: torch.Tensor      # (F, 3) f32
    face_comp: torch.Tensor         # (F,)  i32
    vertex_ks: torch.Tensor         # (V,)  f32
    vertex_ns: torch.Tensor         # (V,)  f32
    vertex_uv: torch.Tensor         # (V, 2) f32
    vertex_kad: torch.Tensor        # (V, 3) f32
    comp_material: torch.Tensor     # (C,) i32
    comp_surface: torch.Tensor      # (C,) i32
    comp_semantic: torch.Tensor     # (C,) i32
    comp_asprs: torch.Tensor        # (C,) i32
    face_neighbors: torch.Tensor | None = None   # (F, MAXN) i32, -1 padded

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_components(self) -> int:
        return self.comp_material.shape[0]

    def aabb(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.vertices.amin(dim=0), self.vertices.amax(dim=0)


@dataclass
class BVH(_TensorFields):
    """Stackless (threaded) BVH in DFS pre-order; host-side (the beam cull
    walks it on the CPU)."""

    node_min: torch.Tensor    # (N, 3) f32
    node_max: torch.Tensor    # (N, 3) f32
    node_face: torch.Tensor   # (N,)  i32 face id for leaves, -1 internal
    node_skip: torch.Tensor   # (N,)  i32 DFS index to jump to on miss

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


@dataclass
class MaterialTable(_TensorFields):
    """Per-material parameters at one wavelength."""

    refractive_index: torch.Tensor   # (M,)  f32
    roughness: torch.Tensor          # (M,)  f32
    brdf_table: torch.Tensor         # (M, 360, 91) f32
    brdf_model: torch.Tensor         # (M,)  i32
    reflectivity_f0: torch.Tensor    # (M, 3) f32

    @property
    def num_materials(self) -> int:
        return self.roughness.shape[0]


@dataclass
class RayBundle(_TensorFields):
    """P pulses x R rays per pulse."""

    origin: torch.Tensor      # (P, R, 3) f32
    direction: torch.Tensor   # (P, R, 3) f32 (unit)
    gps_time: torch.Tensor    # (P,) f32

    @property
    def num_pulses(self) -> int:
        return self.origin.shape[0]

    @property
    def rays_per_pulse(self) -> int:
        return self.origin.shape[1]


@dataclass
class Hit(_TensorFields):
    """Per-ray nearest intersection: ``t`` (BIG when none), ``face``
    (-1 when none)."""

    t: torch.Tensor
    face: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.face >= 0


@dataclass
class PointCloud(_TensorFields):
    """Dense LAS-style output, one slot per (return level, pulse)."""

    position: torch.Tensor         # (K, 3) f32
    normal: torch.Tensor           # (K, 3) f32
    uv: torch.Tensor               # (K, 2) f32
    intensity: torch.Tensor        # (K,)  f32
    distance: torch.Tensor         # (K,)  f32
    return_number: torch.Tensor    # (K,)  i32
    num_returns: torch.Tensor      # (K,)  i32
    scan_angle_rank: torch.Tensor  # (K,)  f32
    scan_direction: torch.Tensor   # (K, 3) f32
    gps_time: torch.Tensor         # (K,)  f32
    comp_id: torch.Tensor          # (K,)  i32
    semantic: torch.Tensor         # (K,)  i32
    asprs: torch.Tensor            # (K,)  i32
    mask: torch.Tensor             # (K,)  bool

    @property
    def capacity(self) -> int:
        return self.intensity.shape[0]

    def num_points(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def compact_host(self) -> "PointCloud":
        """Host-side compaction: the valid slots, in slot order, as CPU
        tensors (mask all True)."""
        mask = self.mask.detach().cpu()
        take = lambda a: a.detach().cpu()[mask]
        return PointCloud(**{f.name: take(getattr(self, f.name))
                             for f in dataclasses.fields(self)
                             if f.name != "mask"},
                          mask=torch.ones(int(mask.sum()), dtype=torch.bool))


def concat_pointclouds(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate chunk results along the slot axis (on the clouds'
    device)."""
    return PointCloud(**{
        f.name: torch.cat([getattr(c, f.name) for c in clouds])
        for f in dataclasses.fields(PointCloud)})


def as_numpy(x) -> np.ndarray:
    """Tensor or array-like -> numpy array (host copy for tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Device-side compaction (`lidar_brdf_tpu/core/types.py:240-274`).
#
# The reference reads back a compacted collision buffer (atomic compaction in
# `reduceCollisions-comp.glsl:147`, bulk readback `LiDARSimulation.cpp:
# 603-614`).  `pack_compact` packs every field of a chunk's cloud into ONE
# (K, 20) f32 matrix with the valid rows first (a stable partition, in slot
# order), so the host fetches the count and then one contiguous prefix of
# `count` rows instead of every dense slot of 14 fields.
# ---------------------------------------------------------------------------

# column layout of the packed matrix (all exact in f32: the int fields are
# ids below 2^24)
COMPACT_COLS = 20


def pack_compact(cloud: PointCloud) -> tuple[torch.Tensor, torch.Tensor]:
    """(matrix (K, 20) f32 with the valid rows first, count i32), on the
    cloud's device; no host sync."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), stable=True)
    f = lambda a: a.to(torch.float32)[:, None]
    cols = torch.cat([
        cloud.position, cloud.normal, cloud.uv,
        f(cloud.intensity), f(cloud.distance),
        f(cloud.return_number), f(cloud.num_returns),
        f(cloud.scan_angle_rank), cloud.scan_direction,
        f(cloud.gps_time), f(cloud.comp_id),
        f(cloud.semantic), f(cloud.asprs),
    ], dim=1)
    return cols[order], cloud.num_points()


def unpack_compact(rows) -> PointCloud:
    """Inverse of `pack_compact` for the fetched prefix (a tensor or an
    array of rows); a PointCloud on the rows' device, mask all True."""
    rows = torch.as_tensor(rows)
    i32 = lambda c: rows[:, c].to(torch.int32)
    return PointCloud(
        position=rows[:, 0:3], normal=rows[:, 3:6], uv=rows[:, 6:8],
        intensity=rows[:, 8], distance=rows[:, 9],
        return_number=i32(10), num_returns=i32(11),
        scan_angle_rank=rows[:, 12], scan_direction=rows[:, 13:16],
        gps_time=rows[:, 16], comp_id=i32(17),
        semantic=i32(18), asprs=i32(19),
        mask=torch.ones(rows.shape[0], dtype=torch.bool,
                        device=rows.device),
    )
