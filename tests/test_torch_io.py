"""The port's file IO against the JAX package's on the same files and
arrays: PNG (`io/png.py`), OBJ/MTL/sidecar loading and its cache
(`io/obj.py`), RGL measured BRDFs (`io/rgl_bsdf.py`) and the measured
tables of `MaterialLibrary.with_measured`, and PLY output (`io/ply.py`).

Tolerances: PNG pixels, OBJ arrays, measured tables built from the same
files, and PLY bytes are exact; `Marginal2D`, `RGLBrdf.eval` and
`retro_table` are compared at rtol 1e-6 (both are the same float64 numpy
code).
"""

import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu.io import materials as jmats
from lidar_brdf_tpu.io import obj as jobj
from lidar_brdf_tpu.io import ply as jply
from lidar_brdf_tpu.io import png as jpng
from lidar_brdf_tpu.io import rgl_bsdf as jrgl
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core.types import PointCloud
from lidar_brdf_tpu_torch.io import materials as tmats
from lidar_brdf_tpu_torch.io import obj as tobj
from lidar_brdf_tpu_torch.io import ply as tply
from lidar_brdf_tpu_torch.io import png as tpng
from lidar_brdf_tpu_torch.io import rgl_bsdf as trgl
from lidar_brdf_tpu_torch.io import synthetic as tsyn

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _filtered_png(path, img, ftypes):
    """Encode ``img`` (H, W, C) uint8 with scanline filter ``ftypes[y]``."""
    h, w, ch = img.shape
    stride = w * ch

    def paeth(a, b, c):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)

    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        ftype = ftypes[y]
        raw.append(ftype)
        for x in range(stride):
            a = int(cur[x - ch]) if x >= ch else 0
            b = int(prev[x])
            c = int(prev[x - ch]) if x >= ch else 0
            pred = (0, a, b, (a + b) >> 1, paeth(a, b, c))[ftype]
            raw.append((int(cur[x]) - pred) & 0xFF)
        prev = cur

    def chunk(ctype, payload):
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", crc))

    colortype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colortype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(bytes(raw)))
                 + chunk(b"IEND", b""))


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_png_round_trip_and_every_filter_match_jax(tmp_path, ch):
    """The port's encoder writes the JAX encoder's bytes; both decoders
    read every filter type (None, Sub, Up, Average, Paeth) to the same
    pixels, and the round trip is exact."""
    rng = np.random.default_rng(ch)
    img = rng.integers(0, 256, (10, 7, ch), dtype=np.uint8)
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tpng.write_png(pt, img)
    jpng.write_png(pj, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back = tpng.read_png(pt)
    np.testing.assert_array_equal(back, jpng.read_png(pt))
    want = img.astype(np.float32) / 255.0
    if ch == 2:                           # gray+alpha reads as gray
        want = want[:, :, :1]
    np.testing.assert_array_equal(back, want)
    pf = str(tmp_path / "filters.png")
    _filtered_png(pf, img, [y % 5 for y in range(img.shape[0])])
    np.testing.assert_array_equal(tpng.read_png(pf), jpng.read_png(pf))
    np.testing.assert_array_equal(tpng.read_png(pf), want)


def test_sample_bilinear_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.random((9, 13, 3)).astype(np.float32)
    uv = rng.uniform(-2.0, 3.0, (500, 2))
    np.testing.assert_array_equal(tpng.sample_bilinear(img, uv),
                                  jpng.sample_bilinear(img, uv))


# ---------------------------------------------------------------------------
# OBJ
# ---------------------------------------------------------------------------

OBJ_TEXT = """\
# quads, negative indices, o/g/usemtl splits, textured and untextured parts
mtllib scene.mtl
o ground_floor
usemtl painted
v -10 0 -10
v 10 0 -10
v 10 0 10
v -10 0 10
vt 0.25 0.25
vt 0.75 0.25
vt 0.75 0.75
vt 0.25 0.75
vn 0 1 0
f 1/1/1 2/2/1 3/3/1 4/4/1
o water_pool
v -4 0.5 -4
v 4 0.5 -4
v 0 0.5 4
f -3 -2 -1
g tree_trunk
usemtl bark
v 2 0 2
v 3 0 2
v 3 4 2
v 2 4 2
v 2.5 5 2.5
f 8 9 10 11
usemtl leafy
f -5 -3 -1
usemtl bark
f 8 10 -1
"""


def _write_scene(tmp_path, sidecars=True):
    rng = np.random.default_rng(7)
    jpng.write_png(str(tmp_path / "kd.png"),
                   rng.random((4, 8, 3)).astype(np.float32))
    jpng.write_png(str(tmp_path / "ks.png"),
                   rng.random((4, 8, 1)).astype(np.float32))
    (tmp_path / "scene.mtl").write_text(
        "newmtl painted\nKd 0.2 0.2 0.2\nKs 0.0 0.0 0.0\nNs 1.0\n"
        "map_Kd kd.png\nmap_Ks ks.png\n"
        "newmtl bark\nKd 0.4 0.3 0.1\nKs 0.2 0.1 0.3\nNs 5\n"
        "newmtl leafy\nKd 0.1 0.6 0.1\n")
    (tmp_path / "scene.obj").write_text(OBJ_TEXT)
    if sidecars:
        (tmp_path / "scene.LiDARMaterial").write_text(
            "# keyword -> material\ntrunk WOOD\nleafy LEAF\n")
        (tmp_path / "scene.semanticASPRS").write_text("trunk HIGH_VEGETATION\n")
        (tmp_path / "scene.semanticCustom").write_text("tree vegetation\n")
    return str(tmp_path / "scene.obj")


def _assert_scenes_equal(t, j):
    jn = {f.name: np.asarray(getattr(j, f.name))
          for f in dataclasses.fields(j) if getattr(j, f.name) is not None}
    tn = t.numpy()
    assert tn.keys() == jn.keys()
    for k in jn:
        assert tn[k].dtype == jn[k].dtype, k
        np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)


def test_parse_obj_matches_jax(tmp_path):
    path = _write_scene(tmp_path)
    mt, mj = [], []
    ct, cj = tobj.parse_obj(path, mtl_out=mt), jobj.parse_obj(path,
                                                             mtl_out=mj)
    assert mt == mj and len(ct) == len(cj) == 5
    assert [c.name for c in ct] == ["ground_floor", "water_pool",
                                    "tree_trunk", "tree_trunk",
                                    "tree_trunk"]
    assert [c.material_name for c in ct] == ["painted", "painted", "bark",
                                             "leafy", "bark"]
    for a, b in zip(ct, cj):
        for f in ("vertices", "faces", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert len(ct[0].faces) == 2 and len(ct[2].faces) == 2   # quads fanned
    as_dicts = lambda m: {k: vars(v) for k, v in m.items()}
    assert as_dicts(tobj.parse_mtl(mt[0])) == as_dicts(jobj.parse_mtl(mj[0]))
    side = str(tmp_path / "scene.LiDARMaterial")
    assert tobj.read_sidecar(side) == jobj.read_sidecar(side)


@pytest.mark.parametrize("sidecars", [True, False])
def test_load_obj_scene_matches_jax(tmp_path, sidecars):
    """Textured and untextured components, sidecar and hint semantics,
    water and terrain flags: every array of the scene equal."""
    path = _write_scene(tmp_path, sidecars)
    t = tobj.load_obj_scene(path, use_cache=False)
    j = jobj.load_obj_scene(path, use_cache=False)
    _assert_scenes_equal(t, j)
    mat = t.comp_material.numpy()
    surf = t.comp_surface.numpy()
    assert surf[0] & 1 and surf[1] & 2          # ground terrain, pool water
    assert mat[1] == tmats.MATERIAL_ID["WATER"]
    if sidecars:
        # the object name is matched before the material name
        assert mat[2] == mat[3] == tmats.MATERIAL_ID["WOOD"]
    kad = t.vertex_kad.numpy()
    assert np.unique(kad[:4], axis=0).shape[0] > 1     # texture baked


def test_load_scene_dir_matches_jax(tmp_path):
    """The `tls` city at a small size and the water scene as files
    (`chip_smoke.py`'s writers), through both loaders."""
    city = tsyn.city_scene(np.random.default_rng(0), num_buildings=12)
    for root in (chip_smoke.city_scene_dir(city, str(tmp_path / "city")),
                 chip_smoke.water_scene_dir(str(tmp_path / "water"))):
        t, j = tobj.load_scene_dir(root), jobj.load_scene_dir(root)
        _assert_scenes_equal(t, j)
    assert t.num_components == 4 and (t.comp_surface.numpy() & 2).any()
    loaded = tobj.load_scene_dir(str(tmp_path / "city"))
    assert loaded.num_faces == city.num_faces
    assert loaded.num_components == city.num_components
    # every face is one of the city's triangles, in place
    tri = lambda s: np.sort(s.vertices.numpy()[s.faces.numpy()].reshape(
        -1, 9), axis=0)
    np.testing.assert_array_equal(tri(loaded), tri(city))
    # files load in name order: the buildings, then the ground
    asprs = loaded.comp_asprs.numpy()
    assert asprs[-1] == 2 and (asprs[:-1] == 6).all()  # tower sidecar too
    mat = loaded.comp_material.numpy()
    assert set(mat[:-1]) == {tmats.MATERIAL_ID[m] for m in
                            ("STONE", "ALUMINIUM", "CRYSTAL_GLASS")}


def test_obj_cache_round_trips_and_crosses_packages(tmp_path):
    """The port's cache reloads the same arrays without parsing; a cache
    the JAX package wrote loads in the port (same suffix and names), and
    the port's loads in the JAX package."""
    path = _write_scene(tmp_path)
    first = tobj.load_obj_scene(path)
    cache = path + tobj.CACHE_SUFFIX
    assert tobj.CACHE_SUFFIX == jobj.CACHE_SUFFIX and os.path.exists(cache)
    parse = tobj.parse_obj
    try:
        tobj.parse_obj = None                  # a parse would raise
        again = tobj.load_obj_scene(path)
        _assert_scenes_equal(again, jobj.load_obj_scene(path))
    finally:
        tobj.parse_obj = parse
    assert again.numpy().keys() == first.numpy().keys()
    for k, v in first.numpy().items():
        np.testing.assert_array_equal(again.numpy()[k], v)
    os.remove(cache)
    jscene = jobj.load_obj_scene(path)         # JAX writes the cache
    assert os.path.exists(cache)
    _assert_scenes_equal(tobj.load_obj_scene(path), jscene)


# ---------------------------------------------------------------------------
# RGL measured BRDFs
# ---------------------------------------------------------------------------

def test_tensor_file_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    fields = {"a": rng.random((3, 4)).astype(np.float32),
              "b": np.arange(5, dtype=np.int64),
              "c": np.frombuffer(b"xyz", np.uint8).copy()}
    pt, pj = str(tmp_path / "t.bsdf"), str(tmp_path / "j.bsdf")
    trgl.write_tensor_file(pt, fields)
    jrgl.write_tensor_file(pj, fields)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back = trgl.read_tensor_file(pt)
    assert list(back) == list(fields)
    for k in fields:
        np.testing.assert_array_equal(back[k], fields[k])
        assert back[k].dtype == fields[k].dtype


def test_marginal2d_matches_jax():
    rng = np.random.default_rng(1)
    data = rng.random((3, 4, 6, 5)) + 0.1
    params = ([0.0, 1.0, 2.0], [0.0, 0.3, 0.6, 0.9])
    pos = rng.random((400, 2))
    par = np.stack([rng.uniform(0, 2, 400), rng.uniform(0, 0.9, 400)], 1)
    for kw in (dict(build_cdf=True), dict(build_cdf=False),
               dict(build_cdf=False, normalize=False)):
        t = trgl.Marginal2D(data, params, **kw)
        j = jrgl.Marginal2D(data, params, **kw)
        np.testing.assert_allclose(t.eval(pos, par), j.eval(pos, par),
                                   rtol=1e-6)
        if kw["build_cdf"]:
            (st, pt), (sj, pj) = t.invert(pos, par), j.invert(pos, par)
            np.testing.assert_allclose(st, sj, rtol=1e-6)
            np.testing.assert_allclose(pt, pj, rtol=1e-6)


def test_rgl_eval_and_retro_table_match_jax(tmp_path):
    path = str(tmp_path / "m.bsdf")
    trgl.synthetic_tensor_file(path, n_wl=4, seed=5, diffuse=0.3)
    t, j = trgl.RGLBrdf(path), jrgl.RGLBrdf(path)
    rng = np.random.default_rng(2)
    wi = rng.normal(size=(300, 3))
    wo = rng.normal(size=(300, 3))
    wi[:, 2], wo[:, 2] = np.abs(wi[:, 2]), np.abs(wo[:, 2])
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    ft = t.eval(wi, wo)
    assert ft.shape == (300, 4) and (ft > 0).any()
    np.testing.assert_allclose(ft, j.eval(wi, wo), rtol=1e-6)
    rt = t.retro_table()
    assert rt.shape == (4, 360, 91)
    np.testing.assert_allclose(rt, j.retro_table(), rtol=1e-6)


def test_with_measured_tables_match_jax(tmp_path):
    """`with_measured` over a directory of `.bsdf` files named for the
    reflectivity map (the first build writes `database.npz`, the second
    reads it): spectral tables, wavelengths and `table_at` equal to the
    JAX library's, the nearest wavelength's slice taken; the port's
    library takes the JAX one's arrays as they are."""
    bdir = chip_smoke.brdf_dir(str(tmp_path / "brdf"))
    t = tmats.MaterialLibrary.default().with_measured(bdir)
    assert os.path.exists(os.path.join(bdir, "database.npz"))
    jdir = str(tmp_path / "brdf_j")
    shutil.copytree(bdir, jdir)
    os.remove(os.path.join(jdir, "database.npz"))
    j = jmats.MaterialLibrary.default().with_measured(jdir)
    again = tmats.MaterialLibrary.default().with_measured(jdir)
    for lib in (t, again):
        np.testing.assert_array_equal(lib.table_wavelengths,
                                      j.table_wavelengths)
        np.testing.assert_array_equal(lib.spectral_tables,
                                      j.spectral_tables)
    leaf = tmats.MATERIAL_ID["LEAF"]
    assert not np.array_equal(t.spectral_tables[0, leaf], t.tables[leaf])
    crossed = tmats.MaterialLibrary(**vars(j))
    for wl in (400, 700, 760, 1064, 1600):
        jt = j.table_at(wl)
        for lib in (t, crossed):
            mt = lib.table_at(wl)
            for f in dataclasses.fields(jt):
                np.testing.assert_array_equal(
                    getattr(mt, f.name).numpy(),
                    np.asarray(getattr(jt, f.name)), err_msg=f.name)
    idx = int(np.argmin(np.abs(t.table_wavelengths - 1064)))
    np.testing.assert_array_equal(t.table_at(1064).brdf_table.numpy(),
                                  t.spectral_tables[idx])
    assert tmats.REFLECTIVITY_MEASURED_MAP == jmats.REFLECTIVITY_MEASURED_MAP


def test_match_keyword_and_npz_tables_match_jax(tmp_path):
    kw = {"wall": "STONE", "glass_wall": "CRYSTAL_GLASS", "Tree": "WOOD"}
    for name in ("north_glass_wall_3", "WALL", "big_tree", "roof", ""):
        assert tmats.match_keyword(name, kw) == jmats.match_keyword(name, kw)
    p = str(tmp_path / "tables.npz")
    rng = np.random.default_rng(0)
    np.savez(p, wavelengths=np.array([905.0, 1550.0]),
             tables=rng.random((2, 3, 360, 91)).astype(np.float32))
    for a, b in zip(tmats.load_brdf_tables_npz(p),
                    jmats.load_brdf_tables_npz(p)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def _jax_cloud(rng, **kw):
    from lidar_brdf_tpu.api import simulate
    from lidar_brdf_tpu.core.config import (LiDARType, SensorConfig,
                                            ShadingMode)
    scene = jsyn.terrain_with_boxes(rng, num_boxes=2)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 8.0, 0.0),
        tls_resolution_horizontal=24, tls_resolution_vertical=12,
        tls_fov_vertical=80.0, tls_middle_angle_vertical=-40.0,
        rays_per_pulse=1, max_returns=2, chunk_pulses=512,
        shading_mode=ShadingMode.LAMBERTIAN,
        include_shiny_surface_error=False, include_outliers=True, **kw)
    return simulate(scene, cfg)


def _np_cloud(cloud) -> dict:
    return {f.name: np.asarray(getattr(cloud, f.name))
            for f in dataclasses.fields(cloud)}


def test_write_ply_bytes_match_jax(tmp_path):
    """The same cloud (a JAX cloud handed over by `pointcloud_from_numpy`,
    with outliers, so labels of -1 and 7 occur) writes the same bytes in
    both packages, compacted by `write_ply` and already compacted; the
    port's cloud may sit on any device and be dense."""
    jc = _jax_cloud(np.random.default_rng(0))
    tc = convert.pointcloud_from_numpy(_np_cloud(jc))
    assert isinstance(tc, PointCloud) and not bool(tc.mask.all())
    cases = ((tc, jc, True),
             (tc.compact_host(), jc.compact_host(), False))
    for i, (t, j, compact) in enumerate(cases):
        pt, pj = str(tmp_path / f"t{i}.ply"), str(tmp_path / f"j{i}.ply")
        nt = tply.write_ply(pt, t, compact=compact)
        nj = jply.write_ply(pj, j, compact=compact)
        assert nt == nj == int(np.asarray(jc.mask).sum()) > 50
        assert open(pt, "rb").read() == open(pj, "rb").read()
    back = tply.read_ply(pt)
    jb = jply.read_ply(pt)
    assert back.keys() == jb.keys()
    for k in back:
        np.testing.assert_array_equal(back[k], jb[k])
    compact = tc.compact_host()
    np.testing.assert_array_equal(back["x"], compact.position[:, 0].numpy())
    np.testing.assert_array_equal(back["intensity"],
                                  compact.intensity.numpy())
    assert (back["numReturns"] >= 1).all()
    assert (back["asprsSemanticGroup"] == 7).any()


def test_ply_round_trip_of_a_port_scan(tmp_path):
    """`tests/test_io.py::test_ply_roundtrip` on the port's own scan."""
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    scene = tsyn.terrain_with_boxes(np.random.default_rng(0), num_boxes=2)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 8.0, 0.0),
        tls_resolution_horizontal=24, tls_resolution_vertical=12,
        tls_fov_vertical=80.0, tls_middle_angle_vertical=-40.0,
        rays_per_pulse=1, max_returns=1, chunk_pulses=512,
        shading_mode=ShadingMode.LAMBERTIAN,
        include_shiny_surface_error=False)
    cloud = api.simulate(scene, cfg, device="cpu")
    out = str(tmp_path / "cloud.ply")
    n = tply.write_ply(out, cloud)
    assert n == int(cloud.mask.sum()) > 0
    back = tply.read_ply(out)
    compact = cloud.compact_host()
    np.testing.assert_array_equal(back["x"], compact.position[:, 0].numpy())
    np.testing.assert_array_equal(back["intensity"],
                                  compact.intensity.numpy())


def test_async_ply_writer(tmp_path):
    """`tests/test_io.py::test_async_ply_writer` for the port: byte-equal
    to `write_ply`, every write joined, writer errors raised at join."""
    jc = _jax_cloud(np.random.default_rng(1))
    cloud = convert.pointcloud_from_numpy(_np_cloud(jc))
    n_sync = tply.write_ply(str(tmp_path / "sync.ply"), cloud)
    with tply.AsyncPlyWriter() as w:
        f0 = w.submit(str(tmp_path / "async0.ply"), cloud)
        w.submit(str(tmp_path / "async1.ply"), cloud)
        counts = w.join()
    assert counts == [n_sync, n_sync] and f0.result() == n_sync
    assert (tmp_path / "sync.ply").read_bytes() == \
        (tmp_path / "async0.ply").read_bytes()
    w2 = tply.AsyncPlyWriter()
    w2.submit(str(tmp_path / "no_such_dir" / "x.ply"), cloud)
    with pytest.raises(OSError):
        w2.join()
    w2._pool.shutdown(wait=False)


# two objects, a group, quads, a pentagon, v/vt/vn and negative ids
_OBJ_TEXT = """# an OBJ scene for the native parser
mtllib none.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
o first
usemtl a
f 1/1/1 2/2/1 3/3/1 4
f -4 -2 -1
g second
v 0 0 1.5
v 2 0 1.5
v 2 2 1.5
v 1 3 1.5
v 0 2 1.5
usemtl a
f 5 6 7 8 9
f -5//1 -4//1 -3//1
o third
f 2 6 7
"""


def _obj_files(root, n):
    """``n`` OBJ files of the text above, each with its positions shifted
    by its index."""
    paths = []
    for k in range(n):
        text = "\n".join(
            "v " + " ".join(str(float(x) + k) for x in line.split()[1:])
            if line.startswith("v ") else line
            for line in _OBJ_TEXT.splitlines())
        path = os.path.join(root, f"s{k}.obj")
        with open(path, "w") as fh:
            fh.write(text + "\n")
        paths.append(path)
    return paths


def _python_parse(path):
    """The JAX package's Python parser re-expressed as the native parse's
    arrays: (triangle corner positions (F, 3, 3), component starts)."""
    comps = jobj.parse_obj(path)
    tris = np.concatenate([c.vertices[c.faces] for c in comps])
    starts = np.cumsum([0] + [len(c.faces) for c in comps])[:-1]
    return tris, starts


def test_parse_obj_native_matches_the_python_parser(tmp_path):
    """Positions exact, fan triangulation and component starts equal to
    `lidar_brdf_tpu/io/obj.py::parse_obj`'s; None for a missing file."""
    from lidar_brdf_tpu_torch.io import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain to build the native helper")
    path = _obj_files(str(tmp_path), 1)[0]
    verts, faces, starts = native.parse_obj_native(path)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    assert starts.dtype == np.int64 and verts.shape == (9, 3)
    tris, want_starts = _python_parse(path)
    assert faces.shape == (len(tris), 3) == (8, 3)
    np.testing.assert_array_equal(verts[faces], tris)
    np.testing.assert_array_equal(starts, want_starts)
    assert native.parse_obj_native(str(tmp_path / "missing.obj")) is None


def test_parse_obj_native_threads_get_their_own_files(tmp_path):
    """The C side keeps one parse between its two calls: two threads
    parsing two files at once each get their own arrays."""
    import sys
    import threading
    from lidar_brdf_tpu_torch.io import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain to build the native helper")
    paths = _obj_files(str(tmp_path), 2)
    want = [native.parse_obj_native(p) for p in paths]
    assert not np.array_equal(want[0][0], want[1][0])
    bad, start = [], threading.Barrier(2)

    def parse(k):
        start.wait()
        for _ in range(300):
            got = native.parse_obj_native(paths[k])
            if not all(np.array_equal(a, b) for a, b in zip(got, want[k])):
                bad.append(k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=parse, args=(k,)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
