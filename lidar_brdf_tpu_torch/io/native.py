"""ctypes binding to the port's native C++ host runtime
(`lidar_brdf_tpu_torch/native/lidar_native.cpp`, the port's own copy of
the JAX package's `native/lidar_native.cpp`).

Modelled on `lidar_brdf_tpu/io/native.py`, with two differences: the
library is compiled with g++ from the port's copy into the git-ignored
`build/native/` directory and loaded from there, and with
``-ffp-contract=off``: no multiply-add is fused, so `lbt_cull`'s near
distances, and with them the order of its lists, are those of the beam
cull on the device (`kernels/cull.py`, K5, built with ``--fmad=false``)
bit for bit, whatever CPU built the library.  The JAX package builds its
own with contraction on.  Every entry point returns None when no
toolchain is available; callers then take their numpy path.  The BVH
build and the OBJ parse run here.  `Simulator`, the bench and the
traversers cull on the device; only `cull_candidates_native` and the
host functions that take ``use_native`` still run `lbt_cull`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..core.types import BVH

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "lidar_native.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_LIB = os.path.join(BUILD_DIR, "liblidar_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _compile() -> bool:
    """g++ into a temporary file, then an atomic rename: concurrent test
    workers never load a half-written library."""
    if not os.path.exists(_SRC):
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
           "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        for attempt in (cmd, [c for c in cmd if c != "-fopenmp"]):
            try:
                subprocess.run(attempt, check=True, capture_output=True,
                               timeout=300)
            except (subprocess.SubprocessError, FileNotFoundError):
                continue
            os.replace(tmp, _LIB)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_LIB)):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.lbt_build_bvh.argtypes = [f32p, i64, i32p, i64, f32p, f32p,
                                      i32p, i32p]
        lib.lbt_build_bvh.restype = ctypes.c_int
        lib.lbt_cull.argtypes = [f32p, f32p, i32p, i32p, i64,
                                 f32p, f32p, f32p, f32p, u8p, i64,
                                 ctypes.c_float, i32p, i32p, f32p, i64]
        lib.lbt_cull.restype = i64
        i64p = ctypes.POINTER(i64)
        lib.lbt_parse_obj_sizes.argtypes = [ctypes.c_char_p, i64p, i64p,
                                            i64p]
        lib.lbt_parse_obj_sizes.restype = ctypes.c_int
        lib.lbt_parse_obj_fill.argtypes = [
            f32p, i32p, np.ctypeslib.ndpointer(np.int64,
                                               flags="C_CONTIGUOUS")]
        lib.lbt_parse_obj_fill.restype = ctypes.c_int
        _lib = lib
        return _lib


def build_bvh_native(vertices: np.ndarray, faces: np.ndarray) -> BVH | None:
    """Native LBVH build; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    n = len(faces)
    total = 2 * n - 1 if n > 1 else 1
    node_min = np.empty((total, 3), np.float32)
    node_max = np.empty((total, 3), np.float32)
    node_face = np.empty(total, np.int32)
    node_skip = np.empty(total, np.int32)
    rc = lib.lbt_build_bvh(vertices.reshape(-1), len(vertices),
                           faces.reshape(-1), n,
                           node_min.reshape(-1), node_max.reshape(-1),
                           node_face, node_skip)
    if rc != 0:
        return None
    from ..geom.bvh import _bvh
    return _bvh(node_min, node_max, node_face, node_skip)


def parse_obj_native(path: str):
    """Fast positions + faces OBJ parse: (verts (V, 3) f32 global positions,
    faces (F, 3) i32 fan-triangulated position ids, comp_start (C,) i64 the
    face where each ``o``/``g`` component starts), or None when the library
    is unavailable or the file cannot be read.  Attribute and material
    resolution stay in `io/obj.py`.

    The C side keeps the parse in one global between its two calls, so the
    module's lock is held across both: two threads never read each other's
    file."""
    lib = get_lib()
    if lib is None:
        return None
    nv, nf, nc = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    with _lock:
        if lib.lbt_parse_obj_sizes(os.fsencode(path), ctypes.byref(nv),
                                   ctypes.byref(nf), ctypes.byref(nc)) != 0:
            return None
        verts = np.empty((nv.value, 3), np.float32)
        faces = np.empty((nf.value, 3), np.int32)
        comp_start = np.empty(nc.value, np.int64)
        if lib.lbt_parse_obj_fill(verts.reshape(-1), faces.reshape(-1),
                                  comp_start) != 0:
            return None
    return verts, faces, comp_start


def cull_candidates_native(bvh: BVH, center, axis, tan_half, radius, valid,
                           t_max: float):
    """Native per-tile beam cull: (tiles, faces, dnear, counts) in per-tile
    near-to-far order, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    as_f32 = lambda a: np.ascontiguousarray(np.asarray(a), np.float32)
    as_i32 = lambda a: np.ascontiguousarray(np.asarray(a), np.int32)
    node_min = as_f32(bvh.node_min)
    node_max = as_f32(bvh.node_max)
    node_face = as_i32(bvh.node_face)
    node_skip = as_i32(bvh.node_skip)
    center, axis = as_f32(center), as_f32(axis)
    tan_half, radius = as_f32(tan_half), as_f32(radius)
    valid = np.ascontiguousarray(valid, np.uint8)
    T = center.shape[0]
    counts = np.empty(T, np.int32)
    args = (node_min.reshape(-1), node_max.reshape(-1), node_face, node_skip,
            len(node_face), center.reshape(-1), axis.reshape(-1), tan_half,
            radius, valid, T, float(t_max), counts)
    total = lib.lbt_cull(*args, np.empty(1, np.int32),
                         np.empty(1, np.float32), 0)
    if total < 0:
        return None
    faces = np.empty(max(int(total), 1), np.int32)
    dnear = np.empty(max(int(total), 1), np.float32)
    if lib.lbt_cull(*args, faces, dnear, int(total)) != total:
        return None
    counts64 = counts.astype(np.int64)
    tiles = np.repeat(np.arange(T, dtype=np.int64), counts64)
    return tiles, faces[:total].astype(np.int64), dnear[:total], counts64
