"""Wavefront OBJ scene loading with binary caching and sidecar configs.

Host numpy, copied from `lidar_brdf_tpu/io/obj.py` (the port imports
nothing of the JAX package); scenes come back as CPU tensors.
Equivalent of `CADModel` (CADModel.cpp:37-592): parse .obj files
into TriangleScene components, cache the parsed arrays as .npz next to the
source (the reference's `.bin` round-trip, cpp:371-480), and honour the
per-model sidecar files:

* ``<model>.LiDARMaterial``   — keyword -> LiDAR material name
* ``<model>.semanticASPRS``   — keyword -> ASPRS class name
* ``<model>.semanticCustom``  — keyword -> custom semantic group name

matched against object/group names by longest-substring (`readClassFile`,
cpp:466-540).  A directory loader mirrors `CADScene::loadModels`
(CADScene.cpp:131-154): recursively load every .obj under a scene root.

The cache keeps the JAX package's file suffix and array names (the two
`TriangleScene`s have the same fields), so a cache written by either
package loads in the other.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.config import ASPRSClass
from ..core.types import SURFACE_TERRAIN, SURFACE_WATER, TriangleScene
from .materials import MATERIAL_ID, match_keyword
from .synthetic import scene_from_arrays

CACHE_SUFFIX = ".lidar_cache.npz"


@dataclass
class ObjComponent:
    """One parsed object/group: the unit that maps to a ModelComponent."""

    name: str
    vertices: np.ndarray      # (V, 3)
    faces: np.ndarray         # (F, 3) into local vertices
    normals: np.ndarray | None = None
    uvs: np.ndarray | None = None
    material_name: str | None = None


@dataclass
class MtlMaterial:
    """Rendering material from a .mtl file: constants + texture maps.

    The reference bakes texture albedo into vertex kad via a compute pass
    before BVH build (`Model3D::retrieveColorsGPU`, Model3D.cpp:292-330;
    `retrieveColors-comp.glsl:33-47`): kad = bilinear map_Kd sample at the
    vertex UV.  NOTE the RELEASED kernel hardcodes ks = ns = 1 (the
    map_Ks/map_Ns sampling lines are commented out, :42-45); here the
    intended texture sampling is implemented and the .mtl constants remain
    the fallback — strictly richer, with shininess still
    clip(ks^ns * roughness) (`reduceCollisions:140-142`).
    """

    kd: tuple = (0.7, 0.7, 0.7)
    ks: float = 0.0
    ns: float = 1.0
    map_kd: str | None = None
    map_ks: str | None = None
    map_ns: str | None = None


def parse_mtl(path: str) -> dict[str, MtlMaterial]:
    mats: dict[str, MtlMaterial] = {}
    cur: MtlMaterial | None = None
    if not os.path.exists(path):
        return mats
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0].lower()
            if tag == "newmtl" and len(parts) > 1:
                cur = MtlMaterial()
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif tag == "kd" and len(parts) >= 4:
                cur.kd = (float(parts[1]), float(parts[2]), float(parts[3]))
            elif tag == "ks" and len(parts) >= 4:
                cur.ks = max(float(parts[1]), float(parts[2]),
                             float(parts[3]))
            elif tag == "ns" and len(parts) >= 2:
                cur.ns = float(parts[1])
            elif tag in ("map_kd", "map_ks", "map_ns") and len(parts) >= 2:
                # options (-s, -o, ...) may precede the filename
                setattr(cur, tag, os.path.join(base, parts[-1]))
    return mats


def _texture_cache_get(cache: dict, path: str):
    """Decode a texture image once per scene load (PNG only; other formats
    fall back to the .mtl constants with a warning)."""
    if path not in cache:
        try:
            from .png import read_png
            cache[path] = read_png(path)
        except (OSError, ValueError) as exc:
            import sys
            print(f"warning: texture {path!r} unreadable ({exc}); "
                  f"falling back to .mtl constants", file=sys.stderr)
            cache[path] = None
    return cache[path]


def parse_obj(path: str, mtl_out: list | None = None) -> list[ObjComponent]:
    """Minimal robust OBJ parser: v/vt/vn, f (triangulated by fanning),
    o/g component splits, usemtl tracking.  ``mtl_out`` (optional list)
    collects referenced mtllib paths."""
    positions: list[list[float]] = []
    uvs: list[list[float]] = []
    normals: list[list[float]] = []
    comps: list[ObjComponent] = []

    cur_name = os.path.splitext(os.path.basename(path))[0]
    cur_mtl: str | None = None
    cur_faces: list[tuple] = []

    def flush():
        nonlocal cur_faces
        if not cur_faces:
            return
        # remap used vertices to a local compact index space
        vmap: dict[tuple, int] = {}
        local_v, local_uv, local_n, faces = [], [], [], []
        for tri in cur_faces:
            idx = []
            for (vi, ti, ni) in tri:
                key = (vi, ti, ni)
                if key not in vmap:
                    vmap[key] = len(local_v)
                    local_v.append(positions[vi])
                    local_uv.append(uvs[ti] if ti is not None else [0.0, 0.0])
                    local_n.append(normals[ni] if ni is not None
                                   else [0.0, 0.0, 0.0])
                idx.append(vmap[key])
            faces.append(idx)
        comps.append(ObjComponent(
            name=cur_name,
            vertices=np.asarray(local_v, np.float32),
            faces=np.asarray(faces, np.int32),
            normals=np.asarray(local_n, np.float32),
            uvs=np.asarray(local_uv, np.float32),
            material_name=cur_mtl))
        cur_faces = []

    def parse_index(tok: str, count: int):
        if not tok:
            return None
        i = int(tok)
        return i - 1 if i > 0 else count + i

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                positions.append([float(parts[1]), float(parts[2]),
                                  float(parts[3])])
            elif tag == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif tag == "vn" and len(parts) >= 4:
                normals.append([float(parts[1]), float(parts[2]),
                                float(parts[3])])
            elif tag in ("o", "g"):
                flush()
                if len(parts) > 1:
                    cur_name = " ".join(parts[1:])
            elif tag == "usemtl":
                if cur_faces and parts[1:] and parts[1] != cur_mtl:
                    flush()   # material change splits the component
                cur_mtl = parts[1] if len(parts) > 1 else None
            elif tag == "mtllib" and len(parts) > 1 and mtl_out is not None:
                mtl_out.append(os.path.join(os.path.dirname(path), parts[1]))
            elif tag == "f" and len(parts) >= 4:
                verts = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = parse_index(sub[0], len(positions))
                    ti = parse_index(sub[1], len(uvs)) if len(sub) > 1 else None
                    ni = parse_index(sub[2], len(normals)) if len(sub) > 2 else None
                    verts.append((vi, ti, ni))
                for k in range(1, len(verts) - 1):   # fan triangulation
                    cur_faces.append((verts[0], verts[k], verts[k + 1]))
    flush()
    return comps


def read_sidecar(path: str) -> dict[str, str]:
    """Parse a keyword->value sidecar file (one pair per line)."""
    mapping: dict[str, str] = {}
    if not os.path.exists(path):
        return mapping
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 2:
                mapping[parts[0]] = parts[1]
    return mapping


# Substring fallbacks used when no sidecar matches; terrain/water flags are
# derived from the resolved semantics (`Model3D.h` surface masks).
_DEFAULT_MATERIAL_HINTS = {
    "water": "WATER", "ground": "STONE", "terrain": "STONE",
    "floor": "STONE", "wall": "STONE", "road": "STONE", "leaf": "LEAF",
    "tree": "WOOD", "wood": "WOOD", "metal": "IRON", "glass": "CRYSTAL_GLASS",
    "plastic": "PLASTIC", "fabric": "FABRIC", "cloth": "FABRIC",
}
_DEFAULT_ASPRS_HINTS = {
    "water": "WATER", "ground": "GROUND", "terrain": "GROUND",
    "floor": "GROUND", "road": "ROAD_SURFACE", "building": "BUILDING",
    "wall": "BUILDING", "roof": "BUILDING", "tree": "HIGH_VEGETATION",
    "bush": "MEDIUM_VEGETATION", "grass": "LOW_VEGETATION",
    "wire": "WIRE", "rail": "RAIL", "bridge": "BRIDGE_DECK",
}


@dataclass
class SceneBuilder:
    """Accumulates components from one or more models into a TriangleScene."""

    vertices: list = field(default_factory=list)
    faces: list = field(default_factory=list)
    uvs: list = field(default_factory=list)
    ks: list = field(default_factory=list)
    ns: list = field(default_factory=list)
    kad: list = field(default_factory=list)
    comp_of_face: list = field(default_factory=list)
    comp_material: list = field(default_factory=list)
    comp_surface: list = field(default_factory=list)
    comp_semantic: list = field(default_factory=list)
    comp_asprs: list = field(default_factory=list)
    comp_names: list = field(default_factory=list)
    semantic_names: dict = field(default_factory=dict)
    _voff: int = 0

    def add_component(self, comp: ObjComponent,
                      material_map: dict[str, str] | None = None,
                      asprs_map: dict[str, str] | None = None,
                      semantic_map: dict[str, str] | None = None,
                      mtl: "MtlMaterial | None" = None,
                      texture_cache: dict | None = None) -> int:
        cid = len(self.comp_material)
        name_keys = [comp.name or ""]
        if comp.material_name:
            name_keys.append(comp.material_name)

        def resolve(mapping, fallback_hints):
            for key in name_keys:
                if mapping:
                    got = match_keyword(key, mapping)
                    if got:
                        return got
            for key in name_keys:
                got = match_keyword(key, fallback_hints)
                if got:
                    return got
            return None

        mat_name = resolve(material_map, _DEFAULT_MATERIAL_HINTS) or "STONE"
        asprs_name = resolve(asprs_map, _DEFAULT_ASPRS_HINTS) or "UNCLASSIFIED"
        sem_name = None
        for key in name_keys:
            if semantic_map:
                sem_name = match_keyword(key, semantic_map) or sem_name
        sem_name = sem_name or (comp.name or "default")
        sem_id = self.semantic_names.setdefault(sem_name,
                                                len(self.semantic_names))

        surface = 0
        asprs = ASPRSClass[asprs_name] if asprs_name in ASPRSClass.__members__ \
            else ASPRSClass.UNCLASSIFIED
        if asprs in (ASPRSClass.GROUND, ASPRSClass.ROAD_SURFACE):
            surface |= int(SURFACE_TERRAIN)
        if asprs == ASPRSClass.WATER or mat_name == "WATER":
            surface |= int(SURFACE_WATER)

        self.vertices.append(comp.vertices)
        self.faces.append(comp.faces + self._voff)
        self.uvs.append(comp.uvs if comp.uvs is not None
                        else np.zeros((len(comp.vertices), 2), np.float32))
        nv = len(comp.vertices)
        mtl = mtl or MtlMaterial()
        uvs = (comp.uvs if comp.uvs is not None
               else np.zeros((nv, 2), np.float32))
        texture_cache = texture_cache if texture_cache is not None else {}

        def bake(map_path, constant, channels):
            """Sample a texture at the vertex UVs (`retrieveColorsGPU`,
            baked once at load) or broadcast the .mtl constant."""
            img = (_texture_cache_get(texture_cache, map_path)
                   if map_path else None)
            if img is None:
                if channels == 1:
                    return np.full(nv, constant, np.float32)
                return np.tile(np.asarray(constant, np.float32), (nv, 1))
            from .png import sample_bilinear
            vals = sample_bilinear(img, uvs)
            if channels == 1:
                return vals[:, 0]
            if vals.shape[1] < 3:
                vals = np.repeat(vals[:, :1], 3, axis=1)
            return vals[:, :3]

        self.ks.append(bake(mtl.map_ks, mtl.ks, 1))
        self.ns.append(bake(mtl.map_ns, mtl.ns, 1))
        self.kad.append(bake(mtl.map_kd, mtl.kd, 3))
        self.comp_of_face.append(np.full(len(comp.faces), cid, np.int32))
        self.comp_material.append(MATERIAL_ID.get(mat_name, MATERIAL_ID["STONE"]))
        self.comp_surface.append(surface)
        self.comp_semantic.append(sem_id)
        self.comp_asprs.append(int(asprs))
        self.comp_names.append(comp.name)
        self._voff += len(comp.vertices)
        return cid

    def build(self) -> TriangleScene:
        if not self.vertices:
            raise ValueError("no components added")
        return scene_from_arrays(
            np.concatenate(self.vertices),
            np.concatenate(self.faces),
            comp_of_face=np.concatenate(self.comp_of_face),
            num_components=len(self.comp_material),
            comp_material=np.asarray(self.comp_material, np.int32),
            comp_surface=np.asarray(self.comp_surface, np.int32),
            comp_semantic=np.asarray(self.comp_semantic, np.int32),
            comp_asprs=np.asarray(self.comp_asprs, np.int32),
            vertex_uv=np.concatenate(self.uvs),
            vertex_ks=np.concatenate(self.ks),
            vertex_ns=np.concatenate(self.ns),
            vertex_kad=np.concatenate(self.kad))


def load_obj_scene(path: str, *, use_cache: bool = True) -> TriangleScene:
    """Load one .obj (+sidecars) into a TriangleScene, with .npz caching."""
    cache = path + CACHE_SUFFIX
    if use_cache and os.path.exists(cache) \
            and os.path.getmtime(cache) >= os.path.getmtime(path):
        data = np.load(cache, allow_pickle=False)
        return TriangleScene(**{k: torch.from_numpy(data[k])
                                for k in data.files})
    scene = load_obj_scenes([path])
    if use_cache:
        try:
            np.savez_compressed(cache, **scene.numpy())
        except OSError:
            pass
    return scene


def load_obj_scenes(paths: list[str]) -> TriangleScene:
    builder = SceneBuilder()
    texture_cache: dict = {}
    for path in paths:
        base = os.path.splitext(path)[0]
        material_map = read_sidecar(base + ".LiDARMaterial")
        asprs_map = read_sidecar(base + ".semanticASPRS")
        semantic_map = read_sidecar(base + ".semanticCustom")
        mtl_paths: list[str] = []
        comps = parse_obj(path, mtl_out=mtl_paths)
        mtls: dict[str, MtlMaterial] = {}
        for mp in mtl_paths:
            mtls.update(parse_mtl(mp))
        for comp in comps:
            builder.add_component(
                comp, material_map, asprs_map, semantic_map,
                mtl=mtls.get(comp.material_name or ""),
                texture_cache=texture_cache)
    return builder.build()


def load_scene_dir(root: str) -> TriangleScene:
    """Recursively load every .obj under ``root``
    (parity with `CADScene::loadModels`)."""
    paths = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name.lower().endswith(".obj"):
                paths.append(os.path.join(dirpath, name))
    if not paths:
        raise FileNotFoundError(f"no .obj files under {root}")
    return load_obj_scenes(paths)
