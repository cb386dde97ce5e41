"""Physics of the slice: the PyTorch port vs the JAX package.

BRDF lookups, the radar equation, shading and the water-free return
extraction (`_returns_noretraverse`, L = 1 and 2), the refraction scan of
water scenes and bathymetric mode and the bathymetric intensity get
identical numpy inputs — the same level-0 hits and the same noise buffer — and must agree:
discrete fields (mask, face, ids, counts) exactly, floats to rtol 1e-5,
atol 1e-6 (vectors relative to their largest component, see
`_assert_records`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import attach_face_neighbors, build_rays
from lidar_brdf_tpu.core.config import (BRDFInterpolation, LiDARType,
                                        SensorConfig, ShadingMode)
from lidar_brdf_tpu.geom.intersect import intersect_brute
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.physics import brdf as jbrdf
from lidar_brdf_tpu.physics import intensity as jint
from lidar_brdf_tpu.physics import returns as jret
from lidar_brdf_tpu.physics.returns import SimScalars, simulate_returns
from lidar_brdf_tpu.physics.shading import shade_records
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core.types import Hit as THit
from lidar_brdf_tpu_torch.geom.intersect import \
    intersect_brute as tintersect_brute
from lidar_brdf_tpu_torch.physics import brdf as tbrdf
from lidar_brdf_tpu_torch.physics import intensity as tint
from lidar_brdf_tpu_torch.physics import returns as tret
from lidar_brdf_tpu_torch.physics import shading as tshade
from lidar_brdf_tpu_torch.physics.types import ReturnRecord as TRecord

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
DISCRETE = {"mask", "face", "comp", "material", "num_intersected",
            "return_number", "winner_ray", "prev_was_water"}
VECTORS = {"point", "normal", "uv", "start", "direction", "prev_point"}


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _mats():
    m = MaterialLibrary.default().table_at(1064)
    return m, convert.materials_from_numpy(_np(m))


@pytest.mark.parametrize("mode", list(BRDFInterpolation))
def test_measured_brdf_factor_matches(mode):
    g = np.random.default_rng(int(mode))
    L = _unit(g.normal(0, 1, (3000, 3)))
    N = _unit(g.normal(0, 1, (3000, 3)))
    L[:5] = [[0, 1, 0]] * 5                 # vertical: no azimuth
    mat = g.integers(0, 15, 3000).astype(np.int32)
    mj, mt = _mats()
    a = jbrdf.measured_brdf_factor(mj, jnp.asarray(mat), jnp.asarray(L),
                                   jnp.asarray(N), mode=mode)
    b = tbrdf.measured_brdf_factor(mt, torch.from_numpy(mat),
                                   torch.from_numpy(L), torch.from_numpy(N),
                                   mode=mode)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    xa, ya = jbrdf.table_angles(jnp.asarray(L), jnp.asarray(N))
    xb, yb = tbrdf.table_angles(torch.from_numpy(L), torch.from_numpy(N))
    np.testing.assert_allclose(xb.numpy(), np.asarray(xa), rtol=RTOL)
    np.testing.assert_allclose(yb.numpy(), np.asarray(ya), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.asarray(jbrdf.hermite_matrix(0.3)),
                                  tbrdf.hermite_matrix(0.3).numpy())


def test_radar_intensity_matches():
    g = np.random.default_rng(0)
    dist = g.uniform(0.5, 150.0, 500).astype(np.float32)
    brdf = g.uniform(0.0, 1.0, 500).astype(np.float32)
    nint = g.integers(0, 10, 500).astype(np.int32)
    kw = dict(sensor_diameter=np.float32(0.215), reflectance_weight=1.0,
              atmospheric_attenuation=np.float32(3.9),
              system_attenuation=1.0)
    a = jint.radar_intensity(jnp.asarray(dist), np.float32(6.5),
                             jnp.asarray(nint), jnp.asarray(brdf), **kw)
    tkw = {k: torch.tensor(float(v)) for k, v in kw.items()}
    b = tint.radar_intensity(torch.from_numpy(dist), torch.tensor(6.5),
                             torch.from_numpy(nint), torch.from_numpy(brdf),
                             **tkw)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)


def _case(L, neighbors=True, outliers=False):
    """Small TLS scan over boxes with wide pulses (so second returns
    occur), its brute-force level-0 hits, and the JAX noise buffer."""
    rng = np.random.default_rng(1234)
    scene = jsyn.terrain_with_boxes(rng, num_boxes=8, half=20.0)
    if neighbors:
        scene = attach_face_neighbors(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=60.0, tls_middle_angle_vertical=-40.0,
        tls_resolution_horizontal=48, tls_resolution_vertical=16,
        rays_per_pulse=6, pulse_radius=0.03, max_returns=L,
        include_outliers=outliers, include_terrain_induced_error=outliers,
        shading_mode=ShadingMode.MEASURED)
    rays = build_rays(cfg, scene)
    hits = intersect_brute(scene, rays.origin, rays.direction)
    noise = jnoise.make_sim_noise(jax.random.PRNGKey(0))
    return scene, cfg, rays, hits, noise


def _run_both(scene, cfg, rays, hits, noise):
    mj, mt = _mats()
    sj = SimScalars.from_config(cfg, 0.0)
    rec_j, out_j, nr_j, _ = simulate_returns(
        scene, None, mj, rays, noise, sj, cfg,
        traverse_fn=lambda o, d: hits, scene_has_water=False)
    ts = convert.scene_from_numpy(_np(scene))
    th = THit(t=torch.from_numpy(np.array(hits.t)),
              face=torch.from_numpy(np.array(hits.face)))
    rec_t, out_t, nr_t, _ = tret.simulate_returns(
        ts, mt, convert.rays_from_numpy(_np(rays)),
        convert.noise_from_numpy(noise), tret.SimScalars.from_config(cfg),
        cfg, traverse_fn=lambda o, d: th, scene_has_water=False)
    return (rec_j, out_j, nr_j), (rec_t, out_t, nr_t)


def _assert_records(a, b):
    """Discrete fields exact; scalars to rtol/atol per element; points,
    normals and uvs to rtol of each vector's largest component (a point
    10 m out with one coordinate near 0 carries the ulp of 10 m in that
    coordinate: XLA contracts `o + d * t` into an FMA, PyTorch does not)."""
    for k, va in _np(a).items():
        vb = getattr(b, k).numpy()
        assert va.shape == vb.shape, k
        if k in DISCRETE or va.dtype == bool:
            np.testing.assert_array_equal(vb, va, err_msg=k)
        elif k in VECTORS:
            # a refraction scan on fixed hits can miss its refined face
            # from a moved origin (t = BIG): such slots are inf on both
            fin = np.isfinite(va)
            np.testing.assert_array_equal(np.isfinite(vb), fin, err_msg=k)
            va, vb = np.where(fin, va, 0), np.where(fin, vb, 0)
            scale = np.abs(va).max(axis=-1, keepdims=True)
            bad = np.abs(vb - va) > ATOL + RTOL * scale
            assert not bad.any(), (k, va[bad.any(-1)], vb[bad.any(-1)])
        else:
            np.testing.assert_allclose(vb, va, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("L,neighbors,outliers",
                         [(1, True, False), (2, True, True),
                          (2, False, False)])
def test_returns_noretraverse_matches(L, neighbors, outliers):
    (rec_j, out_j, nr_j), (rec_t, out_t, nr_t) = _run_both(
        *_case(L, neighbors, outliers))
    assert int(np.asarray(rec_j.mask).sum()) > 300
    if L == 2:    # the scene really produces second returns
        assert int(np.asarray(rec_j.mask)[1].sum()) > 10
    _assert_records(rec_j, rec_t)
    _assert_records(out_j, out_t)
    np.testing.assert_array_equal(np.asarray(nr_j), nr_t.numpy())


@pytest.mark.parametrize("mode", [ShadingMode.MEASURED,
                                  ShadingMode.LAMBERTIAN])
def test_shade_records_matches(mode):
    scene, cfg, rays, hits, noise = _case(2)
    cfg = cfg.with_(shading_mode=mode)
    (rec_j, _, _), _ = _run_both(scene, cfg, rays, hits, noise)
    mj, mt = _mats()
    a = shade_records(scene, mj, rec_j, rec_j.start,
                      SimScalars.from_config(cfg, 0.0), cfg, 6)
    rec_t = TRecord(**{k: torch.from_numpy(np.array(v))
                       for k, v in _np(rec_j).items()})
    b = tshade.shade_records(convert.scene_from_numpy(_np(scene)), mt, rec_t,
                             rec_t.start, tret.SimScalars.from_config(cfg),
                             cfg, 6)
    assert float(np.asarray(a).max()) > 0
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                               atol=ATOL)


def _water_case(L, bathymetric):
    """`_case`'s scan over boxes with the water patch (a WATER component at
    y = 0.05), its brute-force hits and the JAX noise buffer.  Bathymetric
    cases leave out the terrain-induced error: it can lift a bottom
    return above the water, where the bathymetric decay's exponent turns
    positive and the intensity overflows (in both packages alike)."""
    scene = attach_face_neighbors(jsyn.terrain_with_boxes(
        np.random.default_rng(1234), num_boxes=8, half=20.0,
        water_patch=True))
    # device arrays: the JAX scan indexes them with traced winners
    scene = jax.tree.map(jnp.asarray, scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=60.0, tls_middle_angle_vertical=-50.0,
        tls_resolution_horizontal=48, tls_resolution_vertical=16,
        rays_per_pulse=6, pulse_radius=0.03, max_returns=L,
        include_outliers=True,
        include_terrain_induced_error=not bathymetric,
        include_shiny_surface_error=True, bathymetric=bathymetric,
        water_height=0.05, shading_mode=ShadingMode.MEASURED)
    rays = build_rays(cfg, scene)
    hits = intersect_brute(scene, rays.origin, rays.direction)
    noise = jnoise.make_sim_noise(jax.random.PRNGKey(0))
    return scene, cfg, rays, hits, noise


def _first_then(first, later):
    """A traverser that answers its first call (level 0) with ``first``
    and every later one (the bounce levels) with ``later(o, d)``."""
    calls = []

    def traverse(o, d):
        calls.append(None)
        return first if len(calls) == 1 else later(o, d)
    return traverse


def _retraverse_both(scene, cfg, rays, hits, noise, face_pack=None,
                     brute=False):
    """The refraction scan (`scene_has_water=True`) on both sides, level 0
    on the same hits.  A traverser without candidate data serves the
    bounce levels too, in both packages: the same fixed hits again, or
    (``brute``) each package's brute force."""
    mj, mt = _mats()
    ts = convert.scene_from_numpy(_np(scene))
    th = THit(t=torch.from_numpy(np.array(hits.t)),
              face=torch.from_numpy(np.array(hits.face)))
    jt = _first_then(hits, (lambda o, d: intersect_brute(scene, o, d))
                     if brute else (lambda o, d: hits))
    tt = _first_then(th, (lambda o, d: tintersect_brute(ts, o, d))
                     if brute else (lambda o, d: th))
    rec_j, out_j, nr_j, fo_j = simulate_returns(
        scene, None, mj, rays, noise, SimScalars.from_config(cfg, 0.0), cfg,
        traverse_fn=jt, scene_has_water=True, face_pack=face_pack)
    rec_t, out_t, nr_t, fo_t = tret.simulate_returns(
        ts, mt, convert.rays_from_numpy(_np(rays)),
        convert.noise_from_numpy(noise), tret.SimScalars.from_config(cfg),
        cfg, traverse_fn=tt, scene_has_water=True, face_pack=face_pack)
    return (rec_j, out_j, nr_j, fo_j), (rec_t, out_t, nr_t, fo_t)


def test_unported_branches_raise():
    """What was unported (the refraction scan) is held against JAX on the
    same inputs; a chunk that needs the packet walk without one raises."""
    scene, cfg, rays, hits, noise = _water_case(2, True)
    ts = convert.scene_from_numpy(_np(scene))
    _, mt = _mats()
    args = (ts, mt, convert.rays_from_numpy(_np(rays)),
            convert.noise_from_numpy(noise), tret.SimScalars.from_config(cfg),
            cfg)
    with pytest.raises(ValueError, match="packet_fn"):
        tret.simulate_returns(*args, traverse_fn=None, scene_has_water=False)
    with pytest.raises(ValueError, match="packet_fn"):
        tret.simulate_returns(*args, traverse_fn=lambda o, d, x: None,
                              traverse_data=(), scene_has_water=True)
    (rec_j, out_j, nr_j, fo_j), (rec_t, out_t, nr_t, fo_t) = \
        _retraverse_both(scene, cfg, rays, hits, noise)
    assert bool(np.asarray(rec_j.prev_was_water).any())
    _assert_records(rec_j, rec_t)
    _assert_records(out_j, out_t)
    np.testing.assert_array_equal(np.asarray(nr_j), nr_t.numpy())
    np.testing.assert_allclose(fo_t.numpy(), np.asarray(fo_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("L,bathymetric,face_pack",
                         [(1, False, None), (3, True, None), (3, True, False),
                          (2, False, False)])
def test_returns_retraverse_matches(L, bathymetric, face_pack):
    """The refraction scan, with the face pack and without, in bathymetric
    mode and not, the bounce levels on each package's brute force:
    records, outliers, return counts and final origins, discrete fields
    exact and floats to `_assert_records`' tolerances; then the winner
    origins and bathymetric shading on those records."""
    scene, cfg, rays, hits, noise = _water_case(L, bathymetric)
    (rec_j, out_j, nr_j, fo_j), (rec_t, out_t, nr_t, fo_t) = \
        _retraverse_both(scene, cfg, rays, hits, noise, face_pack,
                         brute=True)
    mask = np.asarray(rec_j.mask)
    assert mask.sum() > 300
    if L > 1:
        assert mask[1].sum() > 10
    _assert_records(rec_j, rec_t)
    _assert_records(out_j, out_t)
    np.testing.assert_array_equal(np.asarray(nr_j), nr_t.numpy())
    np.testing.assert_allclose(fo_t.numpy(), np.asarray(fo_j), rtol=RTOL,
                               atol=ATOL)
    wj = jret.final_winner_origins(rec_j, fo_j)
    wt = tret.final_winner_origins(rec_t, fo_t)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=RTOL,
                               atol=ATOL)
    mj, mt = _mats()
    a = shade_records(scene, mj, rec_j, wj, SimScalars.from_config(cfg, 0.0),
                      cfg, 6)
    rec_jt = TRecord(**{k: torch.from_numpy(np.array(v))
                        for k, v in _np(rec_j).items()})
    b = tshade.shade_records(convert.scene_from_numpy(_np(scene)), mt,
                             rec_jt, torch.from_numpy(np.array(wj)),
                             tret.SimScalars.from_config(cfg), cfg, 6)
    if bathymetric:
        assert bool(np.asarray(rec_j.prev_was_water)[mask].any())
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                               atol=ATOL)


def test_bathymetric_intensity_matches():
    """`bathymetric_intensity` on seeded geometry: sensor 10-40 m above
    the water, returns 0.5-5 m deep along refracted rays 0-40 degrees off
    the vertical.  rtol 1e-5: away from the vertical the decay's exponent
    is well conditioned (near it, sin(angle) and the 1e-6 guards make both
    packages' cos/sin/arccos differ by more; the pipeline tests cover it)."""
    g = np.random.default_rng(5)
    n = 400
    water = np.float32(0.5)
    start = np.stack([g.uniform(-5, 5, n), water + g.uniform(10, 40, n),
                      g.uniform(-5, 5, n)], -1).astype(np.float32)
    surf = np.stack([g.uniform(-9, 9, n), np.full(n, water),
                     g.uniform(-9, 9, n)], -1).astype(np.float32)
    ang = g.uniform(0.1, 0.7, n)
    az = g.uniform(0, 2 * np.pi, n)
    dirn = np.stack([np.sin(ang) * np.cos(az), -np.cos(ang),
                     np.sin(ang) * np.sin(az)], -1).astype(np.float32)
    hit = (surf + dirn * g.uniform(0.5, 5, n)[:, None]).astype(np.float32)
    dist = np.linalg.norm(hit - start, axis=1).astype(np.float32)
    brdf = g.uniform(0.0, 1.0, n).astype(np.float32)
    kw = dict(sensor_diameter=np.float32(0.215), reflectance_weight=1.0,
              atmospheric_attenuation=np.float32(3.9), water_height=water)
    a = jint.bathymetric_intensity(
        jnp.asarray(dist), np.float32(6.5), jnp.asarray(brdf),
        start_point=jnp.asarray(start), hit_point=jnp.asarray(hit),
        prev_hit_point=jnp.asarray(surf), direction=jnp.asarray(dirn), **kw)
    tkw = {k: torch.tensor(float(v)) for k, v in kw.items()}
    b = tint.bathymetric_intensity(
        torch.from_numpy(dist), torch.tensor(6.5), torch.from_numpy(brdf),
        start_point=torch.from_numpy(start), hit_point=torch.from_numpy(hit),
        prev_hit_point=torch.from_numpy(surf),
        direction=torch.from_numpy(dirn), **tkw)
    assert float(np.asarray(a).max()) > 0
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=0)
