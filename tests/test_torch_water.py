"""Water scenes and bathymetric mode end to end: the port's `api.simulate`,
`Simulator`, `simulate_spectral` and `simulate_chunk` on the CPU vs the JAX
package on the same inputs (the JAX rays and sim-noise buffer handed over
as numpy), and vs the float64 parity oracle of `tests/test_parity_oracle.py`.

Scenes: `tests/test_water.py::water_over_ground_scene` (water at y = 2 over
ground at y = 0) under its ALS scan, bathymetric at 532 nm and not at
1064 nm, 3 returns; `terrain_with_boxes(water_patch=True)` under a TLS
scan.  Both packages BSP-order the pulses alike, so slots line up: masks,
return numbers, comp ids and ASPRS labels exact.  Tolerances:

* positions atol 1e-4 m, distances atol 1e-4 m, intensity rtol 1e-4, but
* on bathymetric scans, positions atol 2e-3 m and distances atol 1e-3 m:
  a pulse's rays over flat water and flat ground tie in t up to rounding,
  and XLA's FMA contraction and the port's separate multiply and add break
  such ties differently in the packet walk, which moves the recorded point
  to the pulse's other ray, about a millimetre away;
* bottom returns' intensities rtol 1e-2, atol 1e-20 (returns peak near
  1e-4; below 1e-20 the decay has left nothing to measure): the
  bathymetric decay's exponent divides by the sine of the in-water angle,
  which both packages' arccos and sine evaluate within a few ulp of an
  ill-conditioned point for near-vertical rays (the parity oracle's file
  allows 1e-2 for the same reason).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_parity_oracle as oracle
from test_water import _als_cfg, water_over_ground_scene

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.api import simulate as jsimulate
from lidar_brdf_tpu.api import simulate_spectral as jspectral
from lidar_brdf_tpu.core.config import (BRDFInterpolation, LiDARType,
                                        SensorConfig, ShadingMode)
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.physics.returns import SimScalars
from lidar_brdf_tpu.runtime.simulate import Simulator
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch import api as tapi
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom.packet import make_packet_traverser
from lidar_brdf_tpu_torch.physics import returns as tret
from lidar_brdf_tpu_torch.runtime.simulate import Simulator as TSim
from lidar_brdf_tpu_torch.runtime.simulate import simulate_chunk

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

DISCRETE = ("mask", "comp_id", "return_number", "num_returns", "asprs")


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _tcfg(cfg):
    return tcfg.SensorConfig.from_json(cfg.to_json())


def _sim_noise(cfg):
    """The JAX `Simulator`'s sim-noise buffer for ``cfg``."""
    return convert.noise_from_numpy(
        jnoise.make_sim_noise(jax.random.PRNGKey(cfg.seed)))


def _assert_clouds(ct, cj, bathymetric):
    """Port cloud ``ct`` vs JAX cloud ``cj``, slot by slot (module
    docstring)."""
    for k in DISCRETE:
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    m = ct.mask.numpy()
    atol = 2e-3 if bathymetric else 1e-4
    np.testing.assert_allclose(ct.position.numpy()[m],
                               np.asarray(cj.position)[m], rtol=0, atol=atol)
    np.testing.assert_allclose(ct.distance.numpy()[m],
                               np.asarray(cj.distance)[m], rtol=0,
                               atol=1e-3 if bathymetric else 1e-4)
    bottom = (m & (ct.asprs.numpy() == 2) & (ct.return_number.numpy() >= 1)
              if bathymetric else np.zeros_like(m))
    for sel, rtol, atol in ((m & ~bottom, 1e-4, 0.0),
                            (bottom, 1e-2, 1e-20)):
        np.testing.assert_allclose(ct.intensity.numpy()[sel],
                                   np.asarray(cj.intensity)[sel], rtol=rtol,
                                   atol=atol)
    return m


@pytest.mark.parametrize("bathymetric", [True, False])
def test_api_simulate_matches_jax_on_water(bathymetric):
    """`api.simulate` on the water scene: bathymetric at 532 nm (returns
    under water, ground with return number >= 1) and the 1064 nm scan
    without (water only as a first return)."""
    scene = water_over_ground_scene()
    cfg = (_als_cfg() if bathymetric
           else _als_cfg(bathymetric=False, wavelength_nm=(1064, 1064)))
    cj = jsimulate(scene, cfg)
    mats = MaterialLibrary.default().table_at(cfg.wavelength_nm[0])
    ct = tapi.simulate(convert.scene_from_numpy(_np(scene)), _tcfg(cfg),
                       materials=convert.materials_from_numpy(_np(mats)),
                       rays=convert.rays_from_numpy(_np(build_rays(cfg,
                                                                   scene))),
                       device="cpu", noise_buf=_sim_noise(cfg))
    m = _assert_clouds(ct, cj, bathymetric)
    asprs, rn = ct.asprs.numpy()[m], ct.return_number.numpy()[m]
    under = (asprs == 2) & (rn >= 1)
    if bathymetric:
        assert (asprs == 9).sum() > 100 and under.sum() > 100
        assert ct.position.numpy()[m][under][:, 1].max() < 0.5
    else:
        assert under.sum() == 0 and ((asprs != 9) | (rn == 0)).all()


def test_simulator_matches_jax_on_water_patch():
    """`terrain_with_boxes(water_patch=True)` under a narrow TLS scan,
    bathymetric at 532 nm, 3 returns: culled level 0 (the tile path),
    packet-walk bounces (the hybrid)."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234),
                                    num_boxes=4, water_patch=True)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
        tls_fov_vertical=40.0, tls_middle_angle_vertical=-60.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=2, pulse_radius=0.05, max_returns=3,
        chunk_pulses=512, bathymetric=True, water_height=0.05,
        wavelength_nm=(532, 532), shading_mode=ShadingMode.MEASURED)
    bvh = build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(532)
    rays = build_rays(cfg, scene)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    use_pallas=True, compact_readback=False)
    cj = sim.run(rays)
    tsim = TSim(scene=convert.scene_from_numpy(_np(scene)),
                bvh=convert.bvh_from_numpy(_np(bvh)),
                materials=convert.materials_from_numpy(_np(mats)),
                cfg=_tcfg(cfg), device="cpu",
                noise_buf=convert.noise_from_numpy(sim.noise_buf))
    assert tsim.scene_has_water and tsim.reorder and not tsim.use_pulse
    ct = tsim.run(convert.rays_from_numpy(_np(rays)))
    m = _assert_clouds(ct, cj, True)
    assert (ct.asprs.numpy()[m] == 9).sum() > 10
    assert ((ct.asprs.numpy()[m] == 2)
            & (ct.return_number.numpy()[m] >= 1)).sum() > 10


def test_hybrid_matches_packet_walk_and_jax():
    """`tests/test_water.py:92-122` on the port: the hybrid (culled level
    0, no reorder) against ``use_culled=False`` (every level on the packet
    walk); and the port's packet-walk run against the JAX one, slot by
    slot.  The hybrid's first hits come from the Wald test, the walk's
    from Moller-Trumbore, so the two differ at f32 rounding, which
    refraction amplifies: they are compared at 1 cm, as the JAX test
    does."""
    scene = water_over_ground_scene()
    cfg = _als_cfg()
    bvh = build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(532)
    rays = build_rays(cfg, scene)
    kw = dict(scene=convert.scene_from_numpy(_np(scene)),
              bvh=convert.bvh_from_numpy(_np(bvh)),
              materials=convert.materials_from_numpy(_np(mats)),
              cfg=_tcfg(cfg), device="cpu", noise_buf=_sim_noise(cfg))
    trays = convert.rays_from_numpy(_np(rays))
    sim_h = TSim(reorder=False, **kw)
    sim_p = TSim(use_culled=False, **kw)
    assert sim_h.use_culled and not sim_h.reorder and sim_h.scene_has_water
    assert not sim_p.use_culled and sim_p.traverser is None
    ch, cp = sim_h.run(trays), sim_p.run(trays)
    mh, mp = ch.mask.numpy(), cp.mask.numpy()
    assert mh.sum() == mp.sum() > 0

    def rows(c, m):
        # a key per point: (pulse gps time, return number)
        key = np.lexsort((c.return_number.numpy()[m], c.gps_time.numpy()[m]))
        return c.position.numpy()[m][key]

    np.testing.assert_allclose(rows(ch, mh), rows(cp, mp), atol=1e-2)
    cj = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                   use_culled=False, compact_readback=False).run(rays)
    _assert_clouds(cp, cj, True)


def test_simulate_spectral_flips_bathymetry():
    """A 532-533 nm sweep of an aerial scan: 532 nm runs bathymetric
    (bottom returns), 533 nm not (none), each equal to the JAX sweep."""
    scene = water_over_ground_scene()
    cfg = _als_cfg(bathymetric=False, wavelength_nm=(532, 533))
    cj = jspectral(scene, cfg)
    ct = tapi.simulate_spectral(
        convert.scene_from_numpy(_np(scene)), _tcfg(cfg),
        rays=convert.rays_from_numpy(_np(build_rays(cfg, scene))),
        device="cpu", noise_buf=_sim_noise(cfg))
    assert set(ct) == set(cj) == {532, 533}
    for wl, bathy in ((532, True), (533, False)):
        m = _assert_clouds(ct[wl], cj[wl], bathy)
        under = ((ct[wl].asprs.numpy()[m] == 2)
                 & (ct[wl].return_number.numpy()[m] >= 1))
        assert (under.sum() > 0) == bathy


def _chunk_vs_oracle(scene, rays, cfg):
    """The port's `simulate_chunk` (every level on the packet walk) and
    the float64 oracle on the same scene, rays, noise and scalars.

    Returns (the port's cloud as numpy, the oracle's records and outliers,
    ``keep`` (L * P,)): the record slots to compare.  A pulse's rays that
    enter flat water together stay parallel below it and reach a flat
    bottom at the same t, exactly in real arithmetic; each side then
    takes the ray its own rounding puts first, so the two may record
    different rays there (another hit point, another noise draw).  In f32
    the rays' water hits, ~30 m from the sensor, are rounded to ulps of
    2e-6 m, so their t below the water differ by a few of those.  ``keep``
    drops the slots where the winners differ and the port's walk found the
    two rays within 5e-5 m of each other (asserted); every other slot is
    compared at the oracle file's tolerances."""
    materials = MaterialLibrary.default().table_at(532)
    min_y = float(np.asarray(scene.vertices)[:, 1].min())
    scalars = SimScalars.from_config(cfg, min_y)
    noise_buf = jnoise.make_sim_noise(jax.random.PRNGKey(0))
    ts = convert.scene_from_numpy(_np(scene))
    walk = make_packet_traverser(ts, convert.bvh_from_numpy(_np(
        build_scene_bvh(scene))))
    hits = []

    def recording_walk(o, d, active=None):
        hits.append(walk(o, d, active=active))
        return hits[-1]

    args = (ts, convert.materials_from_numpy(_np(materials)),
            convert.rays_from_numpy(_np(rays)),
            convert.noise_from_numpy(noise_buf),
            convert.scalars_from_numpy(_np(scalars)), _tcfg(cfg))
    cloud = simulate_chunk(*args, scene_has_water=True, packet_fn=walk)
    records = tret.simulate_returns(*args, scene_has_water=True,
                                    packet_fn=recording_walk)[0]
    rec, out = oracle.oracle_simulate(scene, rays, materials,
                                      np.asarray(noise_buf), scalars, cfg)
    w_port = records.winner_ray.numpy()
    w_oracle = rec["winner"].astype(np.int64)
    flip = rec["mask"] & (w_port != w_oracle)
    for lvl, p in zip(*np.nonzero(flip)):
        t = hits[lvl].t[p].numpy()
        assert abs(t[w_port[lvl, p]] - t[w_oracle[lvl, p]]) <= 5e-5, \
            (lvl, p, t)
    assert flip.sum() <= 0.1 * rec["mask"].sum()
    return cloud.numpy(), rec, out, ~flip.reshape(-1)


def test_simulate_chunk_matches_parity_oracle_composed():
    """`test_parity_oracle.py::test_parity_composed_pipeline` on the port,
    at that file's tolerances."""
    scene = oracle.parity_scene()
    rays = oracle.parity_rays()
    cfg = SensorConfig(
        lidar_type=LiDARType.AERIAL_LINEAR,
        rays_per_pulse=3, max_returns=3, max_range=60.0,
        pulse_radius=0.001, bathymetric=True, water_height=0.5,
        include_outliers=True, outlier_threshold=0.2,
        outlier_range=(0.1, 0.8),
        include_shiny_surface_error=True,
        include_terrain_induced_error=True,
        shading_mode=ShadingMode.MEASURED,
        brdf_interpolation=BRDFInterpolation.HERMITE)
    cloud, rec, out, keep = _chunk_vs_oracle(scene, rays, cfg)
    L, P = cfg.max_returns, rays.num_pulses
    K = L * P
    mask = cloud["mask"]
    assert mask.shape[0] == 2 * K
    np.testing.assert_array_equal(mask[:K], rec["mask"].reshape(K))
    o_mask = rec["mask"].reshape(K) & keep
    assert o_mask.sum() > P * 0.8 and rec["mask"][1].sum() > 3
    assert rec["pwater"].any()
    np.testing.assert_array_equal(cloud["return_number"][:K][o_mask],
                                  rec["retnum"].reshape(K)[o_mask])
    np.testing.assert_array_equal(cloud["num_returns"][:K].reshape(L, P)[0],
                                  rec["num_returns"])
    np.testing.assert_array_equal(cloud["comp_id"][:K][o_mask],
                                  rec["comp"].reshape(K)[o_mask])
    np.testing.assert_allclose(cloud["position"][:K][o_mask],
                               rec["point"].reshape(K, 3)[o_mask],
                               rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(cloud["distance"][:K][o_mask],
                               rec["distance"].reshape(K)[o_mask],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cloud["scan_angle_rank"][:K][o_mask],
                               rec["angle"].reshape(K)[o_mask],
                               rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(cloud["gps_time"][:K][o_mask],
                               rec["gps"].reshape(K)[o_mask],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cloud["intensity"][:K][o_mask],
                               rec["intensity"].reshape(K)[o_mask],
                               rtol=1e-2, atol=1e-9)
    np.testing.assert_array_equal(mask[K:], out["mask"].reshape(K))
    om = out["mask"].reshape(K) & keep
    assert om.sum() > 10
    np.testing.assert_allclose(cloud["position"][K:][om],
                               out["point"].reshape(K, 3)[om],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cloud["distance"][K:][om],
                               out["dist"].reshape(K)[om],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["tls_spherical", "als_zigzag",
                                  "als_elliptical"])
def test_simulate_chunk_matches_parity_oracle_builders(kind):
    """`test_parity_oracle.py::test_parity_builder_geometry` on the port
    (the JAX builders' rays, subsampled as there), at that file's
    tolerances."""
    scene = oracle.parity_scene()
    cfg = oracle._builder_cfg(kind)
    rays = build_rays(cfg, scene)
    P = min(96, rays.num_pulses)
    stride = max(rays.num_pulses // P, 1)
    rays = jax.tree.map(
        lambda a: np.ascontiguousarray(np.asarray(a)[:P * stride:stride]),
        rays)
    cloud, rec, out, keep = _chunk_vs_oracle(scene, rays, cfg)
    L, P = cfg.max_returns, rays.num_pulses
    K = L * P
    mask = cloud["mask"]
    np.testing.assert_array_equal(mask[:K], rec["mask"].reshape(K))
    o_mask = rec["mask"].reshape(K) & keep
    assert o_mask.sum() > P * 0.5
    np.testing.assert_array_equal(cloud["return_number"][:K][o_mask],
                                  rec["retnum"].reshape(K)[o_mask])
    np.testing.assert_array_equal(cloud["comp_id"][:K][o_mask],
                                  rec["comp"].reshape(K)[o_mask])
    np.testing.assert_allclose(cloud["position"][:K][o_mask],
                               rec["point"].reshape(K, 3)[o_mask],
                               rtol=2e-4, atol=5e-3)
    np.testing.assert_allclose(cloud["distance"][:K][o_mask],
                               rec["distance"].reshape(K)[o_mask],
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(cloud["intensity"][:K][o_mask],
                               rec["intensity"].reshape(K)[o_mask],
                               rtol=1e-2, atol=1e-9)
    np.testing.assert_array_equal(mask[K:], out["mask"].reshape(K))
    if kind == "als_zigzag":
        assert rec["pwater"].any()


def test_bounce_mask_changes_no_record_or_gradient():
    """`_returns_retraverse` hands the packet walk (``packet_fn``) each
    bounce level's active rays: the records and the gradients (w.r.t. ray
    origins, vertices and peak power) are those of the same walk over
    every ray, which a caller's ``traverse_fn`` gets, on the plain
    version, bit for bit.  The row gathers' backward is `RowGather`'s
    scatter (`index_add_` here): no autograd index backward, whose sorted
    sums vary from run to run, is left in the graph."""
    scene = water_over_ground_scene()
    cfg = _als_cfg()
    materials = MaterialLibrary.default().table_at(532)
    scalars = SimScalars.from_config(cfg, 0.0)
    ts = convert.scene_from_numpy(_np(scene))
    tm = convert.materials_from_numpy(_np(materials))
    tsc = convert.scalars_from_numpy(_np(scalars))
    tr = convert.rays_from_numpy(_np(build_rays(cfg, scene)))
    tn = _sim_noise(cfg)
    tc = _tcfg(cfg)
    walk = make_packet_traverser(ts, convert.bvh_from_numpy(_np(
        build_scene_bvh(scene))))
    masks, unmasked = [], []

    def masked(origin, direction, active=None):
        masks.append(active)
        return walk(origin, direction, active=active)

    def traverse(origin, direction, *rest):
        unmasked.append(rest)
        return walk(origin, direction, *rest)

    def run(**fn):
        xs = [x.detach().clone().requires_grad_(True)
              for x in (tr.origin, ts.vertices, tsc.peak_power)]
        rays = dataclasses.replace(tr, origin=xs[0])
        args = (dataclasses.replace(ts, vertices=xs[1]), tm, rays, tn,
                dataclasses.replace(tsc, peak_power=xs[2]), tc)
        records = tret.simulate_returns(*args, scene_has_water=True,
                                        **fn)[0]
        cloud = simulate_chunk(*args, scene_has_water=True, **fn)
        loss = torch.where(cloud.mask, cloud.intensity,
                           torch.zeros_like(cloud.intensity)).sum()
        seen, stack = set(), [loss.grad_fn]
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            assert not type(node).__name__.startswith("Index"), node
            stack.extend(f for f, _ in node.next_functions)
        assert "RowGatherBackward" in {type(n).__name__ for n in seen}
        loss.backward()
        return records, [x.grad for x in xs]

    rec_m, grads_m = run(packet_fn=masked)
    rec_u, grads_u = run(traverse_fn=traverse)
    L, P = cfg.max_returns, tr.num_pulses
    assert unmasked == [()] * (2 * L)
    # level 0 walks every ray (no culled traverser here), the bounce
    # levels their active rays: twice (records, then the cloud)
    assert len(masks) == 2 * L and masks[0] is None and masks[L] is None
    bounce = masks[1:L] + masks[L + 1:]
    for a in bounce:
        assert a.shape == (P, cfg.rays_per_pulse) and a.dtype == torch.bool
    assert 0 < int(bounce[0].sum()) < bounce[0].numel()
    for f in dataclasses.fields(rec_m):
        a, b = getattr(rec_m, f.name), getattr(rec_u, f.name)
        assert torch.equal(a, b), f.name
    assert bool(rec_m.mask[1:].any())
    for name, gm, gu in zip(("origin", "vertices", "peak_power"), grads_m,
                            grads_u):
        assert bool(gm.any()), name
        assert torch.equal(gm, gu), name
