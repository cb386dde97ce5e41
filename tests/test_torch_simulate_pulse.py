"""The pulse path end to end: the port's `Simulator(device="cpu",
use_pulse=True).run` vs the JAX package's `Simulator(use_pulse=True,
compact_readback=False).run`, slot by slot, with the JAX rays and noise
passed in.

Both sides cull the same ladders and put each chunk's pulses in the same
bucket-contiguous order (`permute_pulse_ladders`), so every pulse sits in
the same slot and draws the same noise, shiny-surface error included:
mask, comp_id and return_number exact; positions atol 1e-4; intensity rtol
1e-4.  Scenes: an ALS zig-zag scan of `rough_terrain(20_000, half=30)` and
the TLS config of `tests/test_pallas.py:257-297` (360 x 60 degrees), whose
per-pulse cones stay narrow where that config's 640-ray tiles do not.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.runtime.simulate import Simulator
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.kernels import pulse as tpp
from lidar_brdf_tpu_torch.kernels.pulse import PulseLadderTraverser
from lidar_brdf_tpu_torch.runtime.simulate import Simulator as TSim

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _als_cfg(L):
    return SensorConfig(
        lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 40.0, 0.0),
        als_fov_horizontal=70.0, als_fov_vertical=4.5,
        als_scan_frequency=40, als_pulse_frequency=2560, als_speed=30.0,
        max_range=400.0, rays_per_pulse=4, pulse_radius=0.3, max_returns=L,
        chunk_pulses=2048, shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=True)


def _tls_cfg(**kw):
    base = dict(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0),
        tls_fov_horizontal=360.0, tls_fov_vertical=60.0,
        tls_middle_angle_vertical=-45.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=2, max_returns=2, chunk_pulses=512,
        include_shiny_surface_error=True,
        shading_mode=ShadingMode.MEASURED)
    base.update(kw)
    return SensorConfig(**base)


def _run_both(scene, cfg, pulses=None):
    bvh = build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(1064)
    rays = build_rays(cfg, scene)
    if pulses is not None:
        rays = jax.tree.map(lambda a: np.asarray(a)[:pulses], rays)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pulse=True, compact_readback=False)
    cj = sim.run(rays)
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=tcfg.SensorConfig.from_json(cfg.to_json()),
                device="cpu", use_pulse=True,
                noise_buf=convert.noise_from_numpy(sim.noise_buf))
    assert isinstance(tsim.traverser, PulseLadderTraverser)
    assert (tsim.block_pulses, tsim.pulse_group) \
        == (sim.block_pulses, sim.pulse_group)
    stats = {}
    ct = tsim.run(convert.rays_from_numpy(_np(rays)), stats=stats)
    assert set(stats) == {"order_s", "cull_s", "device_s", "readback_s",
                          "readback_bytes"}
    for k in ("mask", "comp_id", "return_number", "num_returns", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.intensity.numpy(), np.asarray(cj.intensity),
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(ct.distance.numpy(), np.asarray(cj.distance),
                               rtol=1e-5, atol=1e-6)
    return ct


@pytest.mark.parametrize("L", [1, 2])
def test_als_pulse_path_matches_jax_slot_by_slot(L):
    scene = jsyn.rough_terrain(np.random.default_rng(0), num_tris=20_000,
                               half=30.0)
    ct = _run_both(scene, _als_cfg(L), pulses=2048)
    assert ct.mask.numpy()[:2048].sum() > 1500


# the config of test_pallas.py, and the same with a wide beam of 6 rays,
# which gives second returns off the box edges
@pytest.mark.parametrize("beam", [{}, dict(rays_per_pulse=6,
                                           pulse_radius=0.1)])
def test_tls_pulse_path_matches_jax_slot_by_slot(beam):
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=4)
    ct = _run_both(scene, _tls_cfg(**beam))
    m = ct.mask.numpy()
    assert m.sum() > 200
    if beam:
        assert (ct.return_number.numpy()[m] == 1).sum() > 5


def test_wide_pulse_cones_raise():
    """A pulse group whose rays spread wider than the cull's cone limit
    takes the packet walk for level 0, in scan order (no ladders, no
    permutation), as the JAX `Simulator` does: slot by slot equal to it."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(0), num_boxes=2)
    cfg = SensorConfig(tls_position=(0.0, 9.0, 0.0),
                       tls_resolution_horizontal=16,
                       tls_resolution_vertical=8, rays_per_pulse=2,
                       chunk_pulses=128, max_returns=2, pulse_radius=0.1,
                       shading_mode=ShadingMode.MEASURED)
    bvh = build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(1064)
    rays = build_rays(cfg, scene)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pulse=True, pulse_group=64, compact_readback=False)
    assert sim.pulse_group == 64
    assert not sim._culler.beams_ok(np.asarray(rays.origin),
                                    np.asarray(rays.direction))
    cj = sim.run(rays)
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=tcfg.SensorConfig.from_json(cfg.to_json()), device="cpu",
                use_pulse=True, pulse_group=64,
                noise_buf=convert.noise_from_numpy(sim.noise_buf))
    assert tsim.pulse_group == 64 and not tsim.reorder
    launches = tpp.KERNEL.launches
    ct = tsim.run(convert.rays_from_numpy(_np(rays)))
    assert tpp.KERNEL.launches == launches
    for k in ("mask", "comp_id", "return_number", "num_returns", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    assert ct.mask.numpy().sum() > 40
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.intensity.numpy(), np.asarray(cj.intensity),
                               rtol=1e-4, atol=0)


def test_pulse_group_is_a_power_of_two_dividing_the_chunk():
    scene = convert.scene_from_numpy(_np(jsyn.terrain_with_boxes(
        np.random.default_rng(0), num_boxes=1)))
    bvh = convert.bvh_from_numpy(_np(build_scene_bvh(
        jsyn.terrain_with_boxes(np.random.default_rng(0), num_boxes=1))))
    mats = convert.materials_from_numpy(_np(
        MaterialLibrary.default().table_at(1064)))
    for group, chunk, want in ((6, 512, 4), (8, 12, 4), (3, 1000, 2),
                               (None, 512, 1)):
        sim = TSim(scene=scene, bvh=bvh, materials=mats,
                   cfg=tcfg.SensorConfig(chunk_pulses=chunk), device="cpu",
                   use_pulse=True, pulse_group=group)
        assert sim.pulse_group == want, (group, chunk)
        assert sim.traverser.kernel_rays == want * 10
    tile = TSim(scene=scene, bvh=bvh, materials=mats,
                cfg=tcfg.SensorConfig(), device="cpu")
    assert not tile.use_pulse            # 100k faces or fewer: tiles
