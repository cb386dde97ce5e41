"""Synthetic scene constructors for tests and benchmarks.

The reference ships demo OBJ scenes ("Conference", "Bedroom"...) that are not
redistributable; these procedural builders provide deterministic stand-ins
with the same TriangleScene structure.  Host numpy, copied from
`lidar_brdf_tpu/io/synthetic.py`; scenes come back as CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import SURFACE_TERRAIN, SURFACE_WATER, TriangleScene


def scene_from_arrays(vertices, faces, *, comp_of_face=None, num_components=1,
                      comp_material=None, comp_surface=None,
                      comp_semantic=None, comp_asprs=None,
                      vertex_ks=None, vertex_ns=None,
                      vertex_uv=None, vertex_kad=None) -> TriangleScene:
    """Assemble a TriangleScene from raw arrays with sensible defaults."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    nv, nf = len(vertices), len(faces)
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)

    def default(x, shape, fill, dtype=np.float32):
        if x is None:
            return torch.from_numpy(np.full(shape, fill, dtype))
        return torch.from_numpy(np.array(x, dtype))

    return TriangleScene(
        vertices=torch.from_numpy(vertices.copy()),
        faces=torch.from_numpy(faces.copy()),
        face_normals=torch.from_numpy(n.astype(np.float32)),
        face_comp=default(comp_of_face, (nf,), 0, np.int32),
        vertex_ks=default(vertex_ks, (nv,), 0.0),
        vertex_ns=default(vertex_ns, (nv,), 1.0),
        vertex_uv=default(vertex_uv, (nv, 2), 0.0),
        vertex_kad=default(vertex_kad, (nv, 3), 0.7),
        comp_material=default(comp_material, (num_components,), 0, np.int32),
        comp_surface=default(comp_surface, (num_components,), 0, np.int32),
        comp_semantic=default(comp_semantic, (num_components,), 0, np.int32),
        comp_asprs=default(comp_asprs, (num_components,), 1, np.int32),
    )


def random_triangles(rng, num_tris=64, spread=10.0, size=0.8) -> TriangleScene:
    """A soup of randomly placed/oriented triangles in a cube of ``spread``."""
    centers = rng.uniform(-spread / 2, spread / 2, (num_tris, 1, 3))
    offsets = rng.normal(0.0, size, (num_tris, 3, 3))
    vertices = (centers + offsets).reshape(-1, 3).astype(np.float32)
    faces = np.arange(num_tris * 3, dtype=np.int32).reshape(-1, 3)
    return scene_from_arrays(vertices, faces)


def ground_plane(half=50.0, y=0.0, cells=1) -> tuple[np.ndarray, np.ndarray]:
    """A subdivided quad in the XZ plane (two triangles per cell)."""
    xs = np.linspace(-half, half, cells + 1)
    zs = np.linspace(-half, half, cells + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, y), gz], axis=-1).reshape(-1, 3)
    idx = np.arange((cells + 1) * (cells + 1)).reshape(cells + 1, cells + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    # winding chosen so face normals point up (+y)
    faces = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)])
    return verts.astype(np.float32), faces.astype(np.int32)


def box(center, half_extent) -> tuple[np.ndarray, np.ndarray]:
    """12-triangle axis-aligned box."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half_extent, np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                        for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    verts = c + corners * h
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for q in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
    return verts, np.asarray(faces, np.int32)


def city_scene(rng, num_buildings=64, half=None, ground_cells=8) -> TriangleScene:
    """Structured benchmark scene: ground + buildings on a jittered grid.

    Unlike ``terrain_with_boxes`` (random overlapping boxes — a worst case
    for any BVH), buildings sit on disjoint grid cells like the reference's
    demo scenes, so traversal behaviour is representative.
    """
    import math
    side = int(math.ceil(math.sqrt(num_buildings)))
    cell = 8.0
    half = half or (side * cell / 2 + 10.0)
    parts_v, parts_f, comp_of_face = [], [], []
    comp_surface, comp_material, comp_asprs = [], [], []
    voff = 0

    def add(v, f, comp, surface, material, asprs):
        nonlocal voff
        parts_v.append(v)
        parts_f.append(f + voff)
        comp_of_face.append(np.full(len(f), comp, np.int32))
        comp_surface.append(surface)
        comp_material.append(material)
        comp_asprs.append(asprs)
        voff += len(v)

    gv, gf = ground_plane(half=half, y=0.0, cells=ground_cells)
    add(gv, gf, 0, SURFACE_TERRAIN, 7, 2)
    comp = 1
    for b in range(num_buildings):
        gx, gz = b % side, b // side
        cx = (gx - side / 2 + 0.5) * cell + rng.uniform(-1.0, 1.0)
        cz = (gz - side / 2 + 0.5) * cell + rng.uniform(-1.0, 1.0)
        h = rng.uniform(2.0, 12.0)
        wx, wz = rng.uniform(1.5, 3.0, 2)
        bv, bf = box((cx, h / 2, cz), (wx, h / 2, wz))
        add(bv, bf, comp, 0, 7, 6)          # STONE buildings
        comp += 1
    vertices = np.concatenate(parts_v)
    faces = np.concatenate(parts_f)
    return scene_from_arrays(
        vertices, faces,
        comp_of_face=np.concatenate(comp_of_face),
        num_components=comp,
        comp_material=np.asarray(comp_material, np.int32),
        comp_surface=np.asarray(comp_surface, np.int32),
        comp_semantic=np.arange(comp, dtype=np.int32),
        comp_asprs=np.asarray(comp_asprs, np.int32))


def rough_terrain(rng, num_tris=5_000_000, half=500.0,
                  amp=6.0) -> TriangleScene:
    """Displaced-heightfield terrain with ~``num_tris`` triangles.

    Multi-octave sinusoidal relief (random phases) — a BVH-meaningful
    stand-in for the reference's large ALS terrain scenes without
    redistributable assets (the `als` workload's scene).
    """
    import math
    cells = max(int(math.sqrt(num_tris / 2)), 1)
    xs = np.linspace(-half, half, cells + 1, dtype=np.float32)
    zs = np.linspace(-half, half, cells + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(gx)
    for freq, a in ((0.008, 1.0), (0.023, 0.55), (0.061, 0.3), (0.17, 0.12)):
        px, pz = rng.uniform(0.0, 2.0 * np.pi, 2)
        y += a * np.sin(gx * freq * 2 * np.pi + px) \
            * np.cos(gz * freq * 2 * np.pi + pz)
    y *= amp / max(float(np.abs(y).max()), 1e-6)
    verts = np.stack([gx, y, gz], axis=-1).reshape(-1, 3)
    idx = np.arange((cells + 1) ** 2,
                    dtype=np.int64).reshape(cells + 1, cells + 1)
    a_ = idx[:-1, :-1].ravel()
    b_ = idx[1:, :-1].ravel()
    c_ = idx[:-1, 1:].ravel()
    d_ = idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a_, c_, b_], -1),
                            np.stack([b_, c_, d_], -1)]).astype(np.int32)
    return scene_from_arrays(
        verts, faces,
        comp_surface=np.array([SURFACE_TERRAIN], np.int32),
        comp_material=np.array([7], np.int32),          # STONE
        comp_asprs=np.array([2], np.int32))             # GROUND


def terrain_with_boxes(rng, num_boxes=8, half=40.0,
                       water_patch=False) -> TriangleScene:
    """Ground plane + scattered boxes, with component/material structure.

    Component 0 = terrain ground, optional component 1 = water patch, then
    one component per box.  Useful for ALS tests and multi-return scenes.
    """
    parts_v, parts_f, comp_of_face = [], [], []
    comp_surface, comp_material, comp_asprs = [], [], []
    voff = 0

    def add(v, f, comp, surface, material, asprs):
        nonlocal voff
        parts_v.append(v)
        parts_f.append(f + voff)
        comp_of_face.append(np.full(len(f), comp, np.int32))
        comp_surface.append(surface)
        comp_material.append(material)
        comp_asprs.append(asprs)
        voff += len(v)

    gv, gf = ground_plane(half=half, y=0.0, cells=4)
    add(gv, gf, 0, SURFACE_TERRAIN, 7, 2)     # STONE ground, ASPRS GROUND
    comp = 1
    if water_patch:
        wv, wf = ground_plane(half=half / 4, y=0.05, cells=1)
        add(wv, wf, comp, SURFACE_WATER, 6, 9)  # WATER material, ASPRS WATER
        comp += 1
    for _ in range(num_boxes):
        centre = rng.uniform(-half * 0.8, half * 0.8, 3)
        centre[1] = rng.uniform(1.0, 6.0)
        bv, bf = box(centre, rng.uniform(0.5, 3.0, 3))
        add(bv, bf, comp, 0, 8, 6)            # WOOD boxes, ASPRS BUILDING
        comp += 1

    vertices = np.concatenate(parts_v)
    faces = np.concatenate(parts_f)
    return scene_from_arrays(
        vertices, faces,
        comp_of_face=np.concatenate(comp_of_face),
        num_components=comp,
        comp_material=np.asarray(comp_material, np.int32),
        comp_surface=np.asarray(comp_surface, np.int32),
        comp_semantic=np.arange(comp, dtype=np.int32),
        comp_asprs=np.asarray(comp_asprs, np.int32))
