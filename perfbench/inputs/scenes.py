"""Frozen scene generators of the benchmark (host numpy).

Copies of the port's `io/synthetic.py::city_scene`, `rough_terrain` and
`scene_from_arrays`, kept here so that a change to the program never
changes the benchmark's inputs.  A scene is a dict of numpy arrays named
as the fields of the port's `TriangleScene`; the harness wraps it for the
program and the reference reads it as it is.
"""

from __future__ import annotations

import math

import numpy as np

SURFACE_TERRAIN = 1 << 0


def scene_from_arrays(vertices, faces, *, comp_of_face=None, num_components=1,
                      comp_material=None, comp_surface=None,
                      comp_semantic=None, comp_asprs=None) -> dict:
    """The scene's arrays, with the defaults of the port's builder (ks 0,
    ns 1, uv 0, kad 0.7; one component unless given)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    nv, nf = len(vertices), len(faces)
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    def default(x, shape, fill, dtype=np.float32):
        return np.full(shape, fill, dtype) if x is None \
            else np.array(x, dtype)

    return dict(
        vertices=vertices.copy(), faces=faces.copy(),
        face_normals=n.astype(np.float32),
        face_comp=default(comp_of_face, (nf,), 0, np.int32),
        vertex_ks=default(None, (nv,), 0.0),
        vertex_ns=default(None, (nv,), 1.0),
        vertex_uv=default(None, (nv, 2), 0.0),
        vertex_kad=default(None, (nv, 3), 0.7),
        comp_material=default(comp_material, (num_components,), 0, np.int32),
        comp_surface=default(comp_surface, (num_components,), 0, np.int32),
        comp_semantic=default(comp_semantic, (num_components,), 0, np.int32),
        comp_asprs=default(comp_asprs, (num_components,), 1, np.int32))


def ground_plane(half, y=0.0, cells=1):
    """A subdivided quad in the XZ plane, normals up."""
    xs = np.linspace(-half, half, cells + 1)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, y), gz], axis=-1).reshape(-1, 3)
    idx = np.arange((cells + 1) ** 2).reshape(cells + 1, cells + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)])
    return verts.astype(np.float32), faces.astype(np.int32)


def box(center, half_extent):
    """12-triangle axis-aligned box."""
    c = np.asarray(center, np.float32)
    h = np.asarray(half_extent, np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1)
                        for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [f for q in quads
             for f in ([q[0], q[1], q[2]], [q[0], q[2], q[3]])]
    return c + corners * h, np.asarray(faces, np.int32)


def city_scene(rng, num_buildings, cell=8.0, ground_cells=8) -> dict:
    """Ground plane (STONE, terrain) and box buildings (STONE) on a
    jittered grid of ``cell`` metre cells, as the port's `city_scene`."""
    side = int(math.ceil(math.sqrt(num_buildings)))
    half = side * cell / 2 + 10.0
    parts_v, parts_f, comp_of_face = [], [], []
    surface, material, asprs = [], [], []
    voff = 0

    def add(v, f, comp, surf, mat, cls):
        nonlocal voff
        parts_v.append(v)
        parts_f.append(f + voff)
        comp_of_face.append(np.full(len(f), comp, np.int32))
        surface.append(surf)
        material.append(mat)
        asprs.append(cls)
        voff += len(v)

    gv, gf = ground_plane(half, 0.0, ground_cells)
    add(gv, gf, 0, SURFACE_TERRAIN, 7, 2)
    for b in range(num_buildings):
        gx, gz = b % side, b // side
        cx = (gx - side / 2 + 0.5) * cell + rng.uniform(-1.0, 1.0)
        cz = (gz - side / 2 + 0.5) * cell + rng.uniform(-1.0, 1.0)
        h = rng.uniform(2.0, 12.0)
        wx, wz = rng.uniform(1.5, 3.0, 2)
        bv, bf = box((cx, h / 2, cz), (wx, h / 2, wz))
        add(bv, bf, b + 1, 0, 7, 6)
    comp = num_buildings + 1
    return scene_from_arrays(
        np.concatenate(parts_v), np.concatenate(parts_f),
        comp_of_face=np.concatenate(comp_of_face), num_components=comp,
        comp_material=np.asarray(material, np.int32),
        comp_surface=np.asarray(surface, np.int32),
        comp_semantic=np.arange(comp, dtype=np.int32),
        comp_asprs=np.asarray(asprs, np.int32))


def city_streets(num_buildings, cell=8.0) -> np.ndarray:
    """Coordinates of the street lines between the city's building cells
    (the same on x and z)."""
    side = int(math.ceil(math.sqrt(num_buildings)))
    return (np.arange(side + 1) - side / 2) * cell


def rough_terrain(rng, num_tris, half=500.0, amp=6.0) -> dict:
    """Multi-octave sinusoidal height field of ~``num_tris`` faces, one
    STONE terrain component, as the port's `rough_terrain`."""
    cells = max(int(math.sqrt(num_tris / 2)), 1)
    xs = np.linspace(-half, half, cells + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    y = np.zeros_like(gx)
    for freq, a in ((0.008, 1.0), (0.023, 0.55), (0.061, 0.3), (0.17, 0.12)):
        px, pz = rng.uniform(0.0, 2.0 * np.pi, 2)
        y += a * np.sin(gx * freq * 2 * np.pi + px) \
            * np.cos(gz * freq * 2 * np.pi + pz)
    y *= amp / max(float(np.abs(y).max()), 1e-6)
    verts = np.stack([gx, y, gz], axis=-1).reshape(-1, 3)
    idx = np.arange((cells + 1) ** 2, dtype=np.int64).reshape(cells + 1,
                                                            cells + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, c, b], -1),
                            np.stack([b, c, d], -1)]).astype(np.int32)
    return scene_from_arrays(
        verts, faces, comp_surface=np.array([SURFACE_TERRAIN], np.int32),
        comp_material=np.array([7], np.int32),
        comp_asprs=np.array([2], np.int32))


def make_scene(spec: dict) -> dict:
    """The configuration's scene (``spec`` = its ``scene`` entry), drawn
    from the entry's own ``seed``: every run of a configuration meets the
    same scene, so its work does not change with the run's seed."""
    rng = np.random.default_rng(spec["seed"])
    if spec["kind"] == "city":
        return city_scene(rng, spec["num_buildings"], spec["cell"],
                          spec["ground_cells"])
    if spec["kind"] == "terrain":
        return rough_terrain(rng, spec["num_tris"], spec["half"], spec["amp"])
    raise ValueError(f"unknown scene kind {spec['kind']!r}")
