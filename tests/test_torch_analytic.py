"""Analytic BRDF shading and device compaction, the port against the JAX
package on the CPU.

* `physics/brdf.py::analytic_brdf_factor` for all eight model ids (ideal
  specular ... Oren-Nayar, and ZOHDI, which gives 0) on random normals,
  directions, angles and tangents, at rtol 1e-5 / atol 1e-6.  The ideal
  specular indicator `|dot(reflect(N, I), V)| < 1e-8` is decided on a value
  that cancels; XLA contracts its multiply-adds into FMAs and PyTorch does
  not (ROADMAP.md section C), so an element whose indicator differs must
  sit on the threshold in float64.
* A full ANALYTIC scan through the port's `Simulator` against the JAX
  `Simulator`, slot by slot, on a scene whose materials take every model
  id (`chip_smoke.all_models_case`), at `tests/test_torch_simulate.py`'s
  tolerances: discrete fields exact, positions atol 1e-4, intensity rtol
  1e-4.  The models take cos() of the scan angle in degrees (the
  reference's quirk), so an angle a few ulps off (the FMA contraction
  again; up to 3 ulps here) moves the intensity by |tan(a)| times that
  difference: where the port's angle differs from JAX's, that first-order
  term is added to the tolerance.
* `core/types.py::pack_compact` / `unpack_compact` against JAX's (exact),
  and `Simulator(compact_readback=True)` against the dense run's
  `compact_host()`, row for row (exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core import types as jtypes
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.io import materials as jmats
from lidar_brdf_tpu.physics import brdf as jbrdf
from lidar_brdf_tpu.runtime.simulate import Simulator
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core import types as ttypes
from lidar_brdf_tpu_torch.io import materials as tmats
from lidar_brdf_tpu_torch.physics import brdf as tbrdf
from lidar_brdf_tpu_torch.runtime.simulate import Simulator as TSim

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed, n=4096):
    """Random unit normals and directions, angles in [0, 90], tangents
    (the caller passes the direction; half the rows here a random unit
    vector), material ids 0-7; the last rows graze (I exactly or nearly
    perpendicular to N), where the ideal specular indicator fires."""
    rng = np.random.default_rng(seed)
    N, I = _unit(rng, n), _unit(rng, n)
    tangent = np.where(rng.random((n, 1)) < 0.5, I, _unit(rng, n))
    g = n // 8
    N[-g:] = np.float32([0.0, 1.0, 0.0])
    I[-g:] = _unit(rng, g) * np.float32([1.0, 0.0, 1.0])
    I[-g:] /= np.linalg.norm(I[-g:], axis=1, keepdims=True)
    I[-g // 2:, 1] = rng.normal(0.0, 1e-8, g // 2)
    angle = rng.uniform(0.0, 90.0, n).astype(np.float32)
    mat = rng.integers(0, 8, n).astype(np.int32)
    return N, I.astype(np.float32), angle, tangent.astype(np.float32), mat


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analytic_factor_matches_jax_for_every_model(seed):
    _, lib = chip_smoke.all_models_case(tmats.MaterialLibrary.default())
    tm = lib.table_at(1064)
    jm = jtypes.MaterialTable(**{k: jnp.asarray(v)
                                 for k, v in tm.numpy().items()})
    N, I, angle, tangent, mat = _inputs(seed)
    ft = tbrdf.analytic_brdf_factor(
        tm, torch.from_numpy(mat), torch.from_numpy(N),
        prev_dir=torch.from_numpy(I), angle_deg=torch.from_numpy(angle),
        tangent=torch.from_numpy(tangent)).numpy()
    fj = np.asarray(jbrdf.analytic_brdf_factor(
        jm, jnp.asarray(mat), jnp.asarray(N), prev_dir=jnp.asarray(I),
        angle_deg=jnp.asarray(angle), tangent=jnp.asarray(tangent)))
    assert ft.dtype == np.float32 and fj.shape == ft.shape
    for model in range(8):
        on = mat == model
        assert on.sum() > 100
        if model == 7:
            assert (ft[on] == 0).all() and (fj[on] == 0).all()
    spec = mat == 0
    # the ideal specular indicator: decided in float64 where they differ
    I64, N64 = I.astype(np.float64), N.astype(np.float64)
    d64 = np.abs(np.sum(I64 * N64, axis=1))
    flip = spec & (ft != fj)
    assert (np.abs(d64[flip] - jbrdf.EPS) < 1e-6).all(), d64[flip]
    assert (spec & (ft == 1.0)).sum() > 10        # the indicator fires
    for model in range(8):
        on = (mat == model) & ~flip
        np.testing.assert_allclose(ft[on], fj[on], rtol=1e-5, atol=1e-6,
                                   err_msg=f"model {model}")
    assert ((ft > 0) & (ft < 1)).sum() > 1000


def test_analytic_factor_differentiates():
    """Gradients w.r.t. normals and directions are finite on rays that
    do not graze (the tangent is the direction, as in shading)."""
    _, lib = chip_smoke.all_models_case(tmats.MaterialLibrary.default())
    tm = lib.table_at(1064)
    N, I, angle, _, mat = _inputs(3, 512)
    N, I, angle, mat = N[:400], I[:400], angle[:400], mat[:400]
    Nt = torch.from_numpy(N).requires_grad_(True)
    It = torch.from_numpy(I).requires_grad_(True)
    f = tbrdf.analytic_brdf_factor(tm, torch.from_numpy(mat), Nt,
                                   prev_dir=It,
                                   angle_deg=torch.from_numpy(angle),
                                   tangent=It)
    f.sum().backward()
    for g in (Nt.grad, It.grad):
        assert torch.isfinite(g).all() and (g != 0).any()


def _all_models_scan():
    """`chip_smoke.all_models_case` in both packages' types, with the
    90 x 40 degree TLS scan of `tests/test_torch_simulate.py` (L = 2)."""
    tscene, tlib = chip_smoke.all_models_case(
        tmats.MaterialLibrary.default())
    jscene = jtypes.TriangleScene(**{k: jnp.asarray(v)
                                     for k, v in tscene.numpy().items()})
    jlib = jmats.MaterialLibrary(**vars(tlib))
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
        tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=2, pulse_radius=0.1, max_returns=2,
        chunk_pulses=512, shading_mode=ShadingMode.ANALYTIC)
    return jscene, jlib.table_at(1064), cfg


def _port_sim(scene, bvh, mats, cfg, noise, **kw):
    return TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=tcfg.SensorConfig.from_json(cfg.to_json()),
                device="cpu", noise_buf=convert.noise_from_numpy(noise), **kw)


def test_analytic_scan_matches_jax_slot_by_slot():
    scene, mats, cfg = _all_models_scan()
    bvh = build_scene_bvh(scene)
    rays = build_rays(cfg, scene)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pallas=True, compact_readback=False)
    cj = sim.run(rays)
    ct = _port_sim(scene, bvh, mats, cfg, sim.noise_buf).run(
        convert.rays_from_numpy(_np(rays)))
    for k in ("mask", "comp_id", "return_number", "num_returns", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    m = ct.mask.numpy()
    models = np.asarray(mats.brdf_model)[
        np.asarray(scene.comp_material)[ct.comp_id.numpy()[m]]]
    assert set(models) == set(range(8))
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=0, atol=1e-4)
    at = ct.scan_angle_rank.numpy()
    da = np.abs(at - np.asarray(cj.scan_angle_rank))
    assert da.max() <= 4 * np.spacing(np.float32(90.0))
    it, ij = ct.intensity.numpy(), np.asarray(cj.intensity)
    tol = np.abs(ij) * (1e-4 + 2.0 * np.abs(np.tan(at.astype(np.float64)))
                        * da)
    assert (np.abs(it - ij) <= tol).all()
    np.testing.assert_allclose(it[da == 0], ij[da == 0], rtol=1e-4, atol=0)
    inten = ct.intensity.numpy()[m]
    assert (inten > 0).sum() > 100 and np.isfinite(inten).all()


def _dense_cloud(seed=0):
    """A JAX cloud with invalid slots, ids of -1 (outliers) and ASPRS
    noise labels, from a TLS scan with outliers on."""
    from lidar_brdf_tpu.api import simulate
    from lidar_brdf_tpu.io import synthetic as jsyn
    scene = jsyn.terrain_with_boxes(np.random.default_rng(seed), num_boxes=3)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 8.0, 0.0), tls_resolution_horizontal=24,
        tls_resolution_vertical=12, tls_fov_vertical=80.0,
        tls_middle_angle_vertical=-40.0, rays_per_pulse=2, max_returns=2,
        chunk_pulses=512, include_outliers=True)
    return simulate(scene, cfg)


def test_pack_compact_matches_jax():
    jc = _dense_cloud()
    tc = convert.pointcloud_from_numpy(_np(jc))
    rows_t, n_t = ttypes.pack_compact(tc)
    rows_j, n_j = jtypes.pack_compact(jc)
    assert rows_t.shape == (tc.capacity, ttypes.COMPACT_COLS)
    assert n_t.dtype == torch.int32 and int(n_t) == int(n_j)
    assert 0 < int(n_t) < tc.capacity
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    n = int(n_t)
    ut = ttypes.unpack_compact(rows_t[:n])
    uj = jtypes.unpack_compact(np.asarray(rows_j)[:n])
    ref = tc.compact_host()
    for f in dataclasses.fields(ut):
        a = getattr(ut, f.name).numpy()
        np.testing.assert_array_equal(a, np.asarray(getattr(uj, f.name)),
                                      err_msg=f.name)
        np.testing.assert_array_equal(a, getattr(ref, f.name).numpy(),
                                      err_msg=f.name)
        assert a.dtype == getattr(ref, f.name).numpy().dtype, f.name
    assert int(ref.num_points()) == n and (ut.comp_id.numpy() == -1).any()


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_compact_readback_equals_dense_compacted(kind):
    """`Simulator(compact_readback=True)` on the CPU gives the dense run's
    `compact_host()` row for row, over several chunks, and reads back
    fewer bytes; the CPU default is dense."""
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.io import synthetic as tsyn
    if kind == "tile":
        scene = tsyn.city_scene(np.random.default_rng(0), num_buildings=16)
        cfg = tcfg.SensorConfig(
            tls_position=(0.0, 10.0, 0.0), tls_fov_horizontal=360.0,
            tls_fov_vertical=100.0, tls_middle_angle_vertical=-35.0,
            tls_resolution_horizontal=128, tls_resolution_vertical=16,
            rays_per_pulse=2, max_returns=2, chunk_pulses=512)
        kw = {}
    else:
        scene = tsyn.rough_terrain(np.random.default_rng(0), num_tris=4000,
                                   half=30.0)
        cfg = tcfg.SensorConfig(
            lidar_type=tcfg.LiDARType.AERIAL_ZIGZAG,
            als_position=(0.0, 40.0, 0.0), als_fov_horizontal=70.0,
            als_scan_frequency=40, als_pulse_frequency=2560,
            als_speed=30.0, rays_per_pulse=4, max_returns=2,
            chunk_pulses=512)
        kw = dict(use_pulse=True)
    bvh = api.build_scene_bvh(scene)
    mats = tmats.MaterialLibrary.default().table_at(1064)
    rays = api.build_rays(cfg, scene, device="cpu")
    out = {}
    for compact in (None, False, True):
        stats = {}
        sim = TSim(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                   device="cpu", compact_readback=compact, **kw)
        out[compact] = (sim.run(rays, stats=stats), stats)
        assert sim.compact_readback is bool(compact)
    dense, ds = out[False]
    packed, ps = out[True]
    assert rays.num_pulses > 2 * cfg.chunk_pulses
    assert bool(packed.mask.all()) and not bool(dense.mask.all())
    ref = dense.compact_host()
    assert packed.capacity == ref.capacity > 0
    for f in dataclasses.fields(ref):
        assert torch.equal(getattr(packed, f.name), getattr(ref, f.name)), \
            f.name
    assert torch.equal(out[None][0].mask, dense.mask)
    assert 0 < ps["readback_bytes"] < ds["readback_bytes"]
