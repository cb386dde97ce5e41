"""Tile traversal: the port's plain PyTorch version of the CUDA tile kernel
(K1) vs the JAX package's Pallas kernel in interpret mode, mirroring
`tests/test_pallas.py`.  K1 itself is held against the plain version on the
card by `tests/test_torch_cuda.py`.

Faces are compared exactly and t to rtol 1e-6 where a face is hit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.geom.intersect import intersect_brute
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.kernels.traverse_pallas import (CAND_BLOCK, LANES,
                                                    PallasCulledTraverser)
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.kernels import traverse as ttrav
from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _fan_rays(n_side=16):
    o0 = np.array([0.0, 9.0, 0.0], np.float32)
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(-1.2, -0.2, n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


def _both(scene, tree, o, d, t_max, tile_rays=LANES):
    jt = PallasCulledTraverser(scene, tile_rays=tile_rays, interpret=True)
    tt = TileTraverser(convert.scene_from_numpy(_np(scene)),
                       tile_rays=tile_rays, device="cpu")
    jdata = jt.prepare(tree, o, d, t_max=t_max)
    tdata = tt.prepare(convert.bvh_from_numpy(_np(tree)), o, d, t_max=t_max)
    return jt, jdata, tt, tdata


def _assert_hits_equal(hj, ht):
    fj, fo = np.asarray(hj.face), ht.face.numpy()
    np.testing.assert_array_equal(fj, fo)
    hit = fo >= 0
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-6)
    assert (ht.t.numpy()[~hit] == np.float32(3.4e38)).all()


def test_plain_matches_pallas_and_brute(rng):
    scene = jsyn.terrain_with_boxes(rng, num_boxes=6)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    o, d = _fan_rays()
    jt, jdata, tt, tdata = _both(scene, tree, o, d, 500.0)
    hj = jt(jnp.asarray(o), jnp.asarray(d), jdata)
    ht = tt(torch.from_numpy(o), torch.from_numpy(d), tdata)
    _assert_hits_equal(hj, ht)
    brute = intersect_brute(scene, jnp.asarray(o), jnp.asarray(d))
    assert (ht.face.numpy() >= 0).sum() > 100
    np.testing.assert_array_equal(ht.face.numpy() >= 0,
                                  np.asarray(brute.face) >= 0)


def test_t_max_cut():
    verts = np.array([[-1, -1, 50], [1, -1, 50], [0, 1, 50]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    scene = jsyn.scene_from_arrays(verts, faces)
    tree = jbvh.build_bvh(verts, faces)
    o = np.zeros((LANES, 3), np.float32)
    d = np.tile(np.array([0, 0, 1], np.float32), (LANES, 1))
    tt = TileTraverser(convert.scene_from_numpy(_np(scene)), tile_rays=LANES,
                       device="cpu")
    ttree = convert.bvh_from_numpy(_np(tree))
    far = tt(torch.from_numpy(o), torch.from_numpy(d),
             tt.prepare(ttree, o, d, t_max=100.0))
    assert (far.face.numpy() == 0).all()
    np.testing.assert_allclose(far.t.numpy(), 50.0, rtol=1e-6)
    near = tt(torch.from_numpy(o), torch.from_numpy(d),
              tt.prepare(ttree, o, d, t_max=10.0))
    assert (near.face.numpy() == -1).all()


def test_fat_list_matches_chunked_pallas(rng, monkeypatch):
    """The JAX wrapper splits fat lists into MAX_CB-block passes merged by
    nearest t; the port walks each list whole.  Same hits either way, and
    the plain version's own block step changes nothing."""
    import lidar_brdf_tpu.kernels.traverse_pallas as tp
    scene = jsyn.terrain_with_boxes(rng, num_boxes=6)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    o, d = _fan_rays()
    jt, jdata, tt, tdata = _both(scene, tree, o, d, 500.0)
    assert any(c.shape[1] // CAND_BLOCK > 2 for _, c, _ in jdata)
    monkeypatch.setattr(tp, "MAX_CB", 2)
    hj = jt(jnp.asarray(o), jnp.asarray(d), jdata)
    ht = tt(torch.from_numpy(o), torch.from_numpy(d), tdata)
    _assert_hits_equal(hj, ht)
    t1, f1 = ttrav.tile_traverse_plain(
        tt.wald, torch.from_numpy(o), torch.from_numpy(d), tdata, tt.t_max,
        LANES, step_blocks=1, row_block=1)
    np.testing.assert_array_equal(f1.numpy(), ht.face.numpy())
    np.testing.assert_array_equal(t1.numpy(), ht.t.numpy())


def test_tile_rays_must_align():
    scene = convert.scene_from_numpy(_np(jsyn.terrain_with_boxes(
        np.random.default_rng(0), num_boxes=1)))
    with pytest.raises(ValueError):
        TileTraverser(scene, tile_rays=100, device="cpu")


def test_wrapper_rejects_bad_inputs():
    wald = torch.zeros((4, 12))
    o = torch.zeros((128, 3))
    good = (torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.int32), torch.zeros((1, 1)))
    ttrav._validate(wald, o, o, [good], 128)
    bad = [
        (wald.double(), o, [good], 128),                    # dtype
        (wald, o, [good], 100),                             # tile size
        (wald, o[:, :2], [good], 128),                      # shape
        (wald, o, [(good[0], good[1].t().contiguous()[:1], good[2])], 128),
        (wald, o, [(good[0], good[1], torch.zeros((1, 2)))], 128),
        (wald.t(), o, [good], 128),                         # contiguity
    ]
    for w, oo, buckets, tr in bad:
        with pytest.raises(ValueError):
            ttrav._validate(w, oo, oo, buckets, tr)
    with pytest.raises(ValueError):
        ttrav.tile_traverse(wald.to("meta"), o.to("meta"), o.to("meta"),
                            [], 1.0, 128)


def test_simulator_tile_path_matches_pallas(rng):
    """`Simulator` on the culled path, as `tests/test_pallas.py` checks it:
    same number of returns and the same intensity multiset.  (A narrower
    field of view than that test keeps every tile beam narrow, so the JAX
    side really takes its Pallas path and not the packet walk.)"""
    from lidar_brdf_tpu.api import build_rays, build_scene_bvh
    from lidar_brdf_tpu.core.config import (LiDARType, SensorConfig,
                                            ShadingMode)
    from lidar_brdf_tpu.io.materials import MaterialLibrary
    from lidar_brdf_tpu.runtime.simulate import Simulator
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator as TSim
    scene = jsyn.terrain_with_boxes(rng, num_boxes=4)
    bvh = build_scene_bvh(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0),
        tls_fov_horizontal=90.0, tls_fov_vertical=40.0,
        tls_middle_angle_vertical=-45.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=2, max_returns=1, chunk_pulses=512,
        shading_mode=ShadingMode.MEASURED)
    mats = MaterialLibrary.default().table_at(1064)
    rays = build_rays(cfg, scene)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pallas=True)
    assert sim._culler.beams_ok(np.asarray(rays.origin),
                                np.asarray(rays.direction))
    cloud_j = sim.run(rays)
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)), cfg=cfg,
                device="cpu",
                noise_buf=convert.noise_from_numpy(sim.noise_buf))
    cloud_t = tsim.run(convert.rays_from_numpy(_np(rays)))
    mj = np.asarray(cloud_j.mask)
    mt = cloud_t.mask.numpy()
    assert mj.sum() == mt.sum() > 100
    np.testing.assert_allclose(np.sort(cloud_t.intensity.numpy()[mt]),
                               np.sort(np.asarray(cloud_j.intensity)[mj]),
                               rtol=1e-4, atol=1e-7)
