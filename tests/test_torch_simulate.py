"""The slice end to end: the port's `Simulator(device="cpu").run` vs the JAX
package's `Simulator(use_pallas=True, compact_readback=False).run`, slot by
slot, on the scene of `tests/test_pallas.py::
test_simulator_use_pallas_interpret` with the JAX rays and noise passed in.
Both BSP-order the pulses the same way, so slots line up: mask, comp_id
and return_number exact; positions atol 1e-4; intensity rtol 1e-4.

The field of view is narrower than in that test (90 x 40 degrees instead
of 360 x 60), so that the tile beams cull; the 360 x 60 scan, whose beams
are too wide and which both packages send through the packet walk, and a
water scene are in `test_unported_paths_raise`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.runtime.simulate import Simulator
from lidar_brdf_tpu_torch import api as tapi
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.io import synthetic as tsyn
from lidar_brdf_tpu_torch.runtime.simulate import Simulator as TSim

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _cfg(**kw):
    base = dict(lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
                tls_position=(0.0, 9.0, 0.0),
                tls_fov_horizontal=90.0, tls_fov_vertical=40.0,
                tls_middle_angle_vertical=-45.0,
                tls_resolution_horizontal=32, tls_resolution_vertical=16,
                rays_per_pulse=2, max_returns=1, chunk_pulses=512,
                shading_mode=ShadingMode.MEASURED)
    base.update(kw)
    return SensorConfig(**base)


@pytest.mark.parametrize("L,pulse_radius,rpp", [(1, 0.001, 2), (2, 0.1, 6)])
def test_simulator_matches_jax_slot_by_slot(L, pulse_radius, rpp):
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=4)
    bvh = build_scene_bvh(scene)
    cfg = _cfg(max_returns=L, pulse_radius=pulse_radius, rays_per_pulse=rpp)
    mats = MaterialLibrary.default().table_at(1064)
    rays = build_rays(cfg, scene)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pallas=True, compact_readback=False)
    assert sim._culler.beams_ok(np.asarray(rays.origin),
                                np.asarray(rays.direction))
    cj = sim.run(rays)
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=tcfg.SensorConfig.from_json(cfg.to_json()),
                device="cpu",
                noise_buf=convert.noise_from_numpy(sim.noise_buf))
    assert tsim.block_pulses == sim.block_pulses
    ct = tsim.run(convert.rays_from_numpy(_np(rays)))
    for k in ("mask", "comp_id", "return_number", "num_returns", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    m = ct.mask.numpy()
    assert m.sum() > 300
    if L == 2:
        assert (ct.return_number.numpy()[m] == 1).sum() > 5
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.intensity.numpy(), np.asarray(cj.intensity),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(ct.distance.numpy(), np.asarray(cj.distance),
                               rtol=1e-5, atol=1e-6)


def test_api_simulate_on_cpu():
    scene = tsyn.city_scene(np.random.default_rng(0), num_buildings=16)
    cfg = tcfg.SensorConfig(
        tls_position=(0.0, 10.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=100.0, tls_middle_angle_vertical=-35.0,
        tls_resolution_horizontal=128, tls_resolution_vertical=16,
        rays_per_pulse=4, chunk_pulses=2048)
    stats = {}
    cloud = tapi.simulate(scene, cfg, device="cpu", stats=stats)
    m = cloud.mask
    assert cloud.capacity == 2048 and int(m.sum()) > 500
    assert torch.isfinite(cloud.position[m]).all()
    assert (cloud.intensity[m] >= 0).all() and (cloud.intensity[m] > 0).any()
    assert set(stats) == {"order_s", "cull_s", "device_s", "readback_s",
                          "readback_bytes"}


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = tsyn.terrain_with_boxes(np.random.default_rng(0), num_boxes=1)
    cfg = tcfg.SensorConfig(tls_resolution_horizontal=8,
                            tls_resolution_vertical=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build_rays(cfg, scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.simulate(scene, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.simulate_spectral(scene, cfg)
    mats = tapi.MaterialLibrary.default().table_at(1064)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSim(scene=scene, bvh=tapi.build_scene_bvh(scene), materials=mats,
             cfg=cfg)
    rays = tapi.build_rays(cfg, scene, device="cpu")
    assert rays.origin.device.type == "cpu"


def _port_run(scene, bvh, mats, cfg, rays, noise, **kw):
    """The port's `Simulator(device="cpu").run` on the JAX inputs."""
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=tcfg.SensorConfig.from_json(cfg.to_json()),
                device="cpu", noise_buf=convert.noise_from_numpy(noise), **kw)
    return tsim, tsim.run(convert.rays_from_numpy(_np(rays)))


def test_unported_paths_raise():
    """The paths that raised before they were ported now match the JAX
    `Simulator` slot by slot: ANALYTIC shading (on a narrow scan that
    culls fine, through the tile path), a water scene (the hybrid: culled
    level 0, packet-walk bounces) and the 360 x 60 degree scan of
    `tests/test_pallas.py:93-120`, whose tile beams are too wide to cull
    (level 0 on the packet walk).  Discrete fields exact; positions atol
    1e-4, intensity rtol 1e-4."""
    mats = MaterialLibrary.default().table_at(1064)
    wide = _cfg(tls_fov_horizontal=360.0, tls_fov_vertical=60.0)
    analytic = _cfg(shading_mode=ShadingMode.ANALYTIC)
    for water, beams_ok, cfg in (
            (False, True, analytic),
            (True, True, _cfg(max_returns=2, pulse_radius=0.1)),
            (False, False, wide)):
        scene = jsyn.terrain_with_boxes(np.random.default_rng(1234),
                                        num_boxes=4, water_patch=water)
        bvh = build_scene_bvh(scene)
        rays = build_rays(cfg, scene)
        sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        use_pallas=True, compact_readback=False)
        beams = sim._culler.beams_ok(np.asarray(rays.origin),
                                     np.asarray(rays.direction))
        assert beams == beams_ok and sim.scene_has_water == water
        cj = sim.run(rays)
        tsim, ct = _port_run(scene, bvh, mats, cfg, rays, sim.noise_buf)
        assert tsim.scene_has_water == water
        assert tsim.block_pulses == sim.block_pulses
        for k in ("mask", "comp_id", "return_number", "num_returns",
                  "asprs"):
            np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                          np.asarray(getattr(cj, k)),
                                          err_msg=k)
        m = ct.mask.numpy()
        assert m.sum() > 300
        if water:
            assert (ct.asprs.numpy()[m] == 9).sum() > 10
        np.testing.assert_allclose(ct.position.numpy(),
                                   np.asarray(cj.position), rtol=0, atol=1e-4)
        np.testing.assert_allclose(ct.intensity.numpy(),
                                   np.asarray(cj.intensity), rtol=1e-4,
                                   atol=0)
