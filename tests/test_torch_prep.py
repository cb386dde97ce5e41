"""Host preparation of the PyTorch port vs the JAX package.

Config, BVH, Morton codes, adjacency, synthetic scenes, material tables and
the beam-cull host half are numpy on both sides, so they must be
bit-equal.  `core/convert.py` must round-trip the JAX arrays exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_brdf_tpu.core import config as jcfg
from lidar_brdf_tpu.geom import adjacency as jadj
from lidar_brdf_tpu.geom import beamcull as jcull
from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.geom import morton as jmorton
from lidar_brdf_tpu.io import materials as jmat
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.kernels.traverse_pallas import PallasCulledTraverser
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom import adjacency as tadj
from lidar_brdf_tpu_torch.geom import beamcull as tcull
from lidar_brdf_tpu_torch.geom import bvh as tbvh
from lidar_brdf_tpu_torch.geom import morton as tmorton
from lidar_brdf_tpu_torch.io import materials as tmat
from lidar_brdf_tpu_torch.io import synthetic as tsyn
from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _fan_rays(n_side=16):
    o0 = np.array([0.0, 9.0, 0.0], np.float32)
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(-1.2, -0.2, n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


@pytest.mark.parametrize("name", sorted(jcfg.SENSOR_PRESETS) + ["default"])
def test_config_json_roundtrip_and_presets(name):
    cj = jcfg.SensorConfig() if name == "default" else jcfg.get_preset(name)
    ct = tcfg.SensorConfig() if name == "default" else tcfg.get_preset(name)
    assert cj.to_json() == ct.to_json()
    back = tcfg.SensorConfig.from_json(cj.to_json())
    assert back == ct
    assert tcfg.tls_vertical_angles(ct) == jcfg.tls_vertical_angles(cj)


def test_city_scene_and_adjacency_bit_equal():
    sj = jsyn.city_scene(np.random.default_rng(0), num_buildings=30)
    st = tsyn.city_scene(np.random.default_rng(0), num_buildings=30)
    _assert_same(_np(sj), st.numpy())
    np.testing.assert_array_equal(
        jadj.build_face_neighbors(sj.faces, sj.face_comp),
        tadj.build_face_neighbors(st.faces.numpy(), st.face_comp.numpy()))
    for kind in ("terrain_with_boxes", "random_triangles"):
        a = getattr(jsyn, kind)(np.random.default_rng(3))
        b = getattr(tsyn, kind)(np.random.default_rng(3))
        _assert_same(_np(a), b.numpy())


@pytest.mark.parametrize("native", [True, False])
def test_bvh_and_morton_bit_equal(native):
    scene = jsyn.city_scene(np.random.default_rng(0), num_buildings=40)
    v, f = np.asarray(scene.vertices), np.asarray(scene.faces)
    _assert_same(_np(jbvh.build_bvh(v, f, use_native=native)),
                 tbvh.build_bvh(v, f, use_native=native).numpy())
    pts = np.random.default_rng(1).uniform(-5, 5, (500, 3))
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(jmorton.morton3d_np(pts, lo, hi),
                                  tmorton.morton3d_np(pts, lo, hi))


def test_material_table_bit_equal():
    a = jmat.MaterialLibrary.default().table_at(1064)
    b = tmat.MaterialLibrary.default().table_at(1064)
    _assert_same(_np(a), b.numpy())
    assert tmat.MATERIAL_NAMES == jmat.MATERIAL_NAMES


def _beamcull_host_half(rng, use_native):
    """Wald rows, tile beams, BSP order, buckets and bounds from both
    packages' host halves on the same scene and fan of rays.

    The JAX traverser's `prepare` is held against two things of the port:
    its host functions (`build_bucketed_candidates` with ``use_native`` as
    given, and `TileTraverser.bucket_bounds`), bit for bit, and its
    traverser's `prepare`, which culls on the device (here the plain
    version of K5).  Through the native culler that one is bit-equal too;
    the numpy culler orders a tile's list by centroid projection where the
    native and device culls order it by near distance, so then the same
    tiles must get the same face sets."""
    scene = jsyn.terrain_with_boxes(rng, num_boxes=6)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    ttree = convert.bvh_from_numpy(_np(tree))
    o, d = _fan_rays()
    np.testing.assert_array_equal(
        jcull.wald_rows_np(scene.vertices, scene.faces),
        tcull.wald_rows_np(scene.vertices, scene.faces))
    bj = jcull.tile_beams(o, d, 128)
    bt = tcull.tile_beams(o, d, 128)
    for f in dataclasses.fields(bj):
        np.testing.assert_array_equal(getattr(bj, f.name),
                                      getattr(bt, f.name))
    assert jcull.beams_are_narrow(bj) == tcull.beams_are_narrow(bt)
    feat = np.concatenate([d, o], axis=1)
    np.testing.assert_array_equal(jcull.bsp_order_np(feat, 32),
                                  tcull.bsp_order_np(feat, 32))

    # buckets + bounds through the JAX traverser's prepare() and the
    # port's host functions
    jt = PallasCulledTraverser(scene, tile_rays=128, interpret=True)
    tt = TileTraverser(convert.scene_from_numpy(_np(scene)), tile_rays=128,
                       device="cpu")
    jdata = jt.prepare(tree, o, d, t_max=500.0)
    buckets = tcull.build_bucketed_candidates(
        ttree, *tt._pad_np(o, d), tile_rays=128, t_max=500.0, pad_to=8,
        use_native=use_native)
    bounds = tt.bucket_bounds(ttree, buckets, o, d)
    host = [tuple(torch.from_numpy(x) for x in (t, c, b))
            for (t, c), b in zip(buckets, bounds)]
    assert len(jdata) == len(host) >= 1
    for (jt_, jc, jb), (tt_, tc, tb) in zip(jdata, host):
        np.testing.assert_array_equal(np.asarray(jt_), tt_.numpy())
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())

    # the port traverser's prepare(): its cull on the device
    tdata = tt.prepare(ttree, o, d, t_max=500.0)
    assert len(jdata) == len(tdata)
    for (jt_, jc, jb), (tt_, tc, tb) in zip(jdata, tdata):
        np.testing.assert_array_equal(np.asarray(jt_), tt_.numpy())
        if use_native:
            np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
            np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        else:
            assert tc.shape == jc.shape and tb.shape == jb.shape
            np.testing.assert_array_equal(np.sort(np.asarray(jc), axis=1),
                                          np.sort(tc.numpy(), axis=1))
    assert jt.t_max == tt.t_max


def test_beamcull_host_half_bit_equal(rng, monkeypatch):
    """Both host halves with the native culler off (numpy BVH and frontier
    cull on both sides).

    The native culler orders a tile's equidistant candidates differently
    from the numpy one, so the two sides must take the same culler.  The
    JAX package rebuilds its tracked `native/liblidar_native.so` in place
    whenever the source is newer (as after a fresh checkout), and a
    parallel test worker that loads it mid-rebuild quietly falls back to
    numpy; so this test keeps the JAX package's library out of it
    altogether."""
    from lidar_brdf_tpu_torch.io import native as tnative
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    _beamcull_host_half(rng, use_native=False)


def test_beamcull_host_half_native_bit_equal(rng, monkeypatch):
    """Both host halves through the native culler, one library for both:
    the port's build (`build/native/`, compiled to a temporary file and
    renamed into place), handed to the JAX package's binding too, so that
    its in-place rebuild of `native/liblidar_native.so` plays no part."""
    from lidar_brdf_tpu.io import native as jnative
    from lidar_brdf_tpu_torch.io import native as tnative
    monkeypatch.delenv("LIDAR_BRDF_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_lib", tnative.get_lib())
    monkeypatch.setattr(jnative, "_tried", True)
    _beamcull_host_half(rng, use_native=True)


def test_numpy_cull_bit_equal(rng, monkeypatch):
    """The numpy frontier culler (used without a toolchain) matches too."""
    scene = jsyn.terrain_with_boxes(rng, num_boxes=6)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    o, d = _fan_rays()
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    jres = jcull._collect_candidates(tree, jcull.tile_beams(o, d, 128), 500.0)
    tres = tcull._collect_candidates(convert.bvh_from_numpy(_np(tree)),
                                     tcull.tile_beams(o, d, 128), 500.0,
                                     use_native=False)
    for x, y in zip(jres, tres):
        np.testing.assert_array_equal(x, y)


def test_convert_round_trip(rng):
    from lidar_brdf_tpu.api import attach_face_neighbors, build_rays
    from lidar_brdf_tpu.utils import noise as jnoise
    import jax
    scene = attach_face_neighbors(jsyn.terrain_with_boxes(rng, num_boxes=3))
    mats = jmat.MaterialLibrary.default().table_at(905)
    cfg = jcfg.SensorConfig(tls_resolution_horizontal=8,
                            tls_resolution_vertical=4, rays_per_pulse=3)
    rays = build_rays(cfg, scene)
    noise = np.asarray(jnoise.make_sim_noise(jax.random.PRNGKey(0), 4096))
    ts = convert.scene_from_numpy(_np(scene))
    assert ts.face_neighbors is not None and ts.num_faces == scene.num_faces
    _assert_same(_np(scene), ts.numpy())
    _assert_same(_np(mats), convert.materials_from_numpy(_np(mats)).numpy())
    _assert_same(_np(rays), convert.rays_from_numpy(_np(rays)).numpy())
    tn = convert.noise_from_numpy(noise)
    assert tn.dtype == torch.float32
    np.testing.assert_array_equal(tn.numpy(), noise)
