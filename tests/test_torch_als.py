"""Flight paths, flight plans, ALS rays and the `als` terrain: the PyTorch
port vs the JAX package.

Paths, plans and terrain are host numpy on both sides and must be
bit-equal.  Rays are built from the same (JAX) ray-generation buffer:
directions to atol 1e-6 (sin/cos/sqrt may differ by an ulp between XLA and
PyTorch), origins to rtol 1e-6 with atol 1e-4 (the disc offsets ride on a
sensor height of tens of metres, where an ulp of the direction's rounding
moves an offset by ~1e-5 m), gps_time exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lidar_brdf_tpu import api as japi
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, get_preset
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.sensors import als as jals
from lidar_brdf_tpu.sensors import paths as jpaths
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch import api as tapi
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.io import synthetic as tsyn
from lidar_brdf_tpu_torch.sensors import als as tals
from lidar_brdf_tpu_torch.sensors import paths as tpaths

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

AABB = (np.array([-40.0, -1.0, -30.0]), np.array([40.0, 8.0, 30.0]))

MODES = {
    "linear": dict(lidar_type=LiDARType.AERIAL_LINEAR,
                   als_position=(0.0, 50.0, 0.0), als_fov_horizontal=60.0,
                   als_speed=10.0, als_scan_frequency=5,
                   als_pulse_frequency=100, rays_per_pulse=3),
    "zigzag": dict(lidar_type=LiDARType.AERIAL_ZIGZAG,
                   als_position=(0.0, 120.0, 0.0), als_fov_horizontal=70.0,
                   als_fov_vertical=4.5, als_speed=30.0,
                   als_scan_frequency=40, als_pulse_frequency=2560,
                   rays_per_pulse=10, pulse_radius=0.05),
    "elliptical": dict(lidar_type=LiDARType.AERIAL_ELLIPTICAL,
                       als_position=(0.0, 50.0, 0.0), als_fov_horizontal=40.0,
                       als_elliptical_scale=0.5, als_speed=20.0,
                       als_scan_frequency=5, als_pulse_frequency=50,
                       rays_per_pulse=4, pulse_radius=0.02),
    "manual": dict(lidar_type=LiDARType.AERIAL_ZIGZAG,
                   als_position=(0.0, 40.0, 0.0), als_fov_horizontal=30.0,
                   als_scan_frequency=10, als_pulse_frequency=320,
                   als_speed=4.0, rays_per_pulse=2,
                   als_manual_path=((1.0, 2.0), (3.5, 4.0), (10.0, 2.0),
                                    (12.0, 9.0)),
                   als_manual_canvas_size=(16.0, 12.0),
                   douglas_peucker_epsilon=0.5),
}


def _pair(name):
    cj = SensorConfig(**MODES[name])
    return cj, tcfg.SensorConfig.from_json(cj.to_json())


def _raygen():
    buf = jnoise.make_raygen_noise(jax.random.PRNGKey(11))
    return buf, torch.from_numpy(np.array(buf))


def test_path_functions_bit_equal():
    pts = np.random.default_rng(5).uniform(0, 10, (40, 2)).astype(np.float32)
    pts[7] = pts[6]                                     # a redundant point
    np.testing.assert_array_equal(jpaths.remove_redundant_points(pts),
                                  tpaths.remove_redundant_points(pts))
    for eps in (0.1, 1.0, 4.0):
        np.testing.assert_array_equal(jpaths.douglas_peucker(pts, eps),
                                      tpaths.douglas_peucker(pts, eps))
    assert jpaths.perpendicular_distance(pts[3], pts[0], pts[9]) \
        == tpaths.perpendicular_distance(pts[3], pts[0], pts[9])
    w = np.random.default_rng(6).uniform(-5, 5, (6, 4))
    keys = [0.0, 0.1, 0.35, 0.5, 0.8, 0.95]
    for jp, tp in ((jpaths.LinearPath(w), tpaths.LinearPath(w)),
                   (jpaths.CatmullRomPath(w), tpaths.CatmullRomPath(w)),
                   (jpaths.CatmullRomPath(w, keys),
                    tpaths.CatmullRomPath(w, keys)),
                   (jpaths.BezierPath(w), tpaths.BezierPath(w))):
        for t in (0.0, 1e-8, 0.05, 0.33, 0.5, 0.77, 0.999, 1.0, 1.5):
            np.testing.assert_array_equal(jp.position(t), tp.position(t))
    lo, hi = AABB
    assert jpaths.sweep_width(70.0, 110.0) == tpaths.sweep_width(70.0, 110.0)
    assert jpaths.num_sweeps(60.0, 50.0, lo, hi, 0.5) \
        == tpaths.num_sweeps(60.0, 50.0, lo, hi, 0.5)
    for sweeps in (1, 200):
        pj = jpaths.auto_sweep_paths(lo, hi, 50.0, 60.0, 0.5, sweeps)
        pt = tpaths.auto_sweep_paths(lo, hi, 50.0, 60.0, 0.5, sweeps)
        assert len(pj) == len(pt) >= 1
        np.testing.assert_array_equal(
            jpaths.retrieve_waypoints(pj, 0.013, np.random.default_rng(2)),
            tpaths.retrieve_waypoints(pt, 0.013, np.random.default_rng(2)))
    for cr in (True, False):
        mj = jpaths.manual_path(pts, (10.0, 10.0), lo, hi, 40.0, 0.5, cr)
        mt = tpaths.manual_path(pts, (10.0, 10.0), lo, hi, 40.0, 0.5, cr)
        assert [type(p).__name__ for p in mj] \
            == [type(p).__name__ for p in mt]
        np.testing.assert_array_equal(
            jpaths.retrieve_waypoints(mj, 0.01),
            tpaths.retrieve_waypoints(mt, 0.01))


@pytest.mark.parametrize("name", sorted(MODES))
def test_plan_flight_bit_equal(name):
    cj, ct = _pair(name)
    pj = jals.plan_flight(cj, *AABB, np.random.default_rng(3))
    pt = tals.plan_flight(ct, *AABB, np.random.default_rng(3))
    for f in dataclasses.fields(pj):
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert pj.num_pulses == pt.num_pulses > 0


def test_rough_terrain_bit_equal():
    a = jsyn.rough_terrain(np.random.default_rng(0), num_tris=2_000,
                           half=30.0)
    b = tsyn.rough_terrain(np.random.default_rng(0), num_tris=2_000,
                           half=30.0)
    assert b.num_faces == a.num_faces > 1500
    got = b.numpy()
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        if v is not None:
            assert np.asarray(v).dtype == got[f.name].dtype, f.name
            np.testing.assert_array_equal(np.asarray(v), got[f.name],
                                          err_msg=f.name)


def _assert_rays_match(rj, rt):
    oj, ot = np.asarray(rj.origin), rt.origin.numpy()
    dj, dt = np.asarray(rj.direction), rt.direction.numpy()
    assert ot.shape == oj.shape and ot.dtype == np.float32
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ot, oj, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(rt.gps_time.numpy(),
                                  np.asarray(rj.gps_time))


@pytest.mark.parametrize("name", sorted(MODES))
def test_als_rays_match(name):
    cj, ct = _pair(name)
    plan_j = jals.plan_flight(cj, *AABB, np.random.default_rng(3))
    plan_t = tals.plan_flight(ct, *AABB, np.random.default_rng(3))
    bj, bt = _raygen()
    count = min(plan_j.num_pulses - 7, 3000)
    rj = jals.build_als_rays(cj, plan_j, bj, start=7, count=count)
    rt = tals.build_als_rays(ct, plan_t, bt, start=7, count=count)
    assert rt.num_pulses == count
    _assert_rays_match(rj, rt)


def test_api_build_rays_aerial_preset():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(4), num_boxes=3)
    cj = get_preset("zenmuse_l1").with_(als_speed=30.0, rays_per_pulse=2,
                                        als_position=(0.0, 60.0, 0.0))
    ct = tcfg.SensorConfig.from_json(cj.to_json())
    rj = japi.build_rays(cj, scene)
    buf = jnoise.make_raygen_noise(jax.random.PRNGKey(cj.seed + 1))
    ts = convert.scene_from_numpy(
        {f.name: np.asarray(getattr(scene, f.name))
         for f in dataclasses.fields(scene)
         if getattr(scene, f.name) is not None})
    rt = tapi.build_rays(ct, ts, device="cpu",
                         raygen_noise=torch.from_numpy(np.array(buf)))
    assert rt.num_pulses == rj.num_pulses > 1000
    _assert_rays_match(rj, rt)
    with pytest.raises(ValueError, match="scene"):
        tapi.build_rays(ct, None, device="cpu")
