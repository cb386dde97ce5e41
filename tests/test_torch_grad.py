"""The fwd+bwd step: the port's gradients vs `jax.grad` of the JAX package.

Loss = sum of the masked intensity of one chunk (`bench.py`'s training
loss), differentiated w.r.t. the BRDF table, the sensor ray origins, the
scene vertices and `peak_power`, on identical numpy inputs (scene, rays,
ladders or buckets, JAX noise and scalars handed to the port through
`core/convert.py`):

* (a) the tile path: the 90 x 40 degree TLS scan of
  `tests/test_torch_simulate.py`, JAX through `PallasCulledTraverser(
  interpret=True)`, the port through `TileTraverser(device="cpu")`, on the
  same BSP order and buckets;
* (b) the pulse path: `tests/test_vertgrad.py`'s workload (8,000-face rough
  terrain, 256 pulses x 4 rays), which takes the unpacked branch (F > P * L);
  JAX with and without `vertex_grad_aux`;
* (c) the same pulses with the face pack forced on both sides;
* (d) the water scan of `tests/test_water.py` (ALS over water at y = 2
  above ground at y = 0, L = 3, at 532 nm bathymetric and at 1064 nm
  not), every level on the packet walk on both sides
  (`test_water_scan_grads_match_jax`, whose docstring states what differs
  there).

(a)-(c) each at L = 1 and 2.  The loss agrees to rtol 1e-5; gradients within atol
2e-4 * max|g_jax| and rtol 2e-3, `tests/test_vertgrad.py`'s tolerance for
two correct backwards of one function: XLA's CPU backend contracts
multiply-adds into FMAs inside `jit` and PyTorch does not (ROADMAP.md
section C), and the two frameworks sum scatter-added cotangents in other
orders, so gradients that cancel differ by more than the forward values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import (attach_face_neighbors, build_rays,
                                build_scene_bvh)
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.core.types import RayBundle as JRays
from lidar_brdf_tpu.geom.vertgrad import build_vertex_grad_aux
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.kernels.pulse_pallas import (PulseLadderTraverser,
                                                 build_pulse_ladders)
from lidar_brdf_tpu.kernels.traverse_pallas import PallasCulledTraverser
from lidar_brdf_tpu.physics import brdf as jbrdf
from lidar_brdf_tpu.physics import returns as jret
from lidar_brdf_tpu.physics.shading import shade_records as jshade
from lidar_brdf_tpu.runtime.simulate import bsp_order, simulate_chunk
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core.types import RayBundle
from lidar_brdf_tpu_torch.geom.packet import make_packet_traverser
from lidar_brdf_tpu_torch.kernels import pulse as tpulse
from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser
from lidar_brdf_tpu_torch.physics import brdf as tbrdf
from lidar_brdf_tpu_torch.physics.returns import build_face_pack
from lidar_brdf_tpu_torch.runtime.simulate import simulate_chunk as tchunk
from lidar_brdf_tpu_torch.utils import safemath

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

PARAMS = ("brdf_table", "origin", "vertices", "peak_power")


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


# ---------------------------------------------------------------------------
# one chunk, both packages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Chunk:
    """A culled chunk in both packages' types; rays in kernel order."""
    scene: object
    bvh: object
    cfg: SensorConfig
    rays: JRays
    mats: object
    scalars: object
    noise: np.ndarray
    jtr: object
    jdata: object
    ttr: object
    tdata: object
    aux: object = None

    def port_inputs(self):
        return dict(
            scene=convert.scene_from_numpy(_np(self.scene)),
            mats=convert.materials_from_numpy(_np(self.mats)),
            scalars=convert.scalars_from_numpy(_np(self.scalars)),
            rays=convert.rays_from_numpy(_np(self.rays)),
            noise=convert.noise_from_numpy(self.noise),
            cfg=tcfg.SensorConfig.from_json(self.cfg.to_json()))


def jax_loss_and_grads(ch: Chunk, aux=None, pack=False):
    """(loss, {param: grad}) of the JAX package at ``ch``."""
    R = ch.rays.rays_per_pulse

    def loss(table, origin, verts, peak):
        scene = ch.scene.__class__(**{**ch.scene.__dict__,
                                      "vertices": verts})
        mats = ch.mats.__class__(**{**ch.mats.__dict__,
                                    "brdf_table": table})
        sc = ch.scalars.__class__(**{**ch.scalars.__dict__,
                                     "peak_power": peak})
        rays = JRays(origin=origin, direction=ch.rays.direction,
                     gps_time=ch.rays.gps_time)
        if not pack:
            cloud = simulate_chunk(scene, ch.bvh, mats, rays, ch.noise, sc,
                                   ch.cfg, scene_has_water=False,
                                   traverse_fn=ch.jtr,
                                   traverse_data=ch.jdata,
                                   vertex_grad_aux=aux)
            return jnp.sum(jnp.where(cloud.mask, cloud.intensity, 0.0))
        # simulate_chunk with the face pack forced (what it does on the
        # packed side of its gate)
        rec, _, _, _ = jret.simulate_returns(
            scene, ch.bvh, mats, rays, ch.noise, sc, ch.cfg,
            traverse_fn=ch.jtr, traverse_data=ch.jdata,
            scene_has_water=False,
            face_pack=jret.build_face_pack(scene, mats, ch.noise))
        inten = jshade(scene, mats, rec, rec.start, sc, ch.cfg, R)
        return jnp.sum(jnp.where(rec.mask, inten, 0.0))

    args = (ch.mats.brdf_table, ch.rays.origin, ch.scene.vertices,
            ch.scalars.peak_power)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(*args)
    return float(val), {k: np.asarray(g) for k, g in zip(PARAMS, grads)}


def port_loss_fn(ch: Chunk, pack=None):
    """f(table, origin, verts, peak) -> loss, the port at ``ch``: the face
    pack by the gate (``pack=None``), built and handed in (True) or
    refused (False)."""
    p = ch.port_inputs()

    def loss(table, origin, verts, peak):
        scene = dataclasses.replace(p["scene"], vertices=verts)
        mats = dataclasses.replace(p["mats"], brdf_table=table)
        sc = dataclasses.replace(p["scalars"], peak_power=peak)
        rays = RayBundle(origin=origin, direction=p["rays"].direction,
                         gps_time=p["rays"].gps_time)
        fp = build_face_pack(scene, mats, p["noise"]) if pack else pack
        cloud = tchunk(scene, mats, rays, p["noise"], sc, p["cfg"],
                       scene_has_water=False, traverse_fn=ch.ttr,
                       traverse_data=ch.tdata, face_pack=fp)
        return torch.where(cloud.mask, cloud.intensity,
                           torch.zeros_like(cloud.intensity)).sum()

    x0 = (p["mats"].brdf_table, p["rays"].origin, p["scene"].vertices,
          p["scalars"].peak_power)
    return loss, x0


def port_loss_and_grads(ch: Chunk, pack=None):
    loss, x0 = port_loss_fn(ch, pack)
    xs = [x.detach().clone().requires_grad_(True) for x in x0]
    val = loss(*xs)
    val.backward()
    return float(val.detach()), {k: x.grad.numpy()
                                 for k, x in zip(PARAMS, xs)}


def assert_grads_match(lt, gt, lj, gj):
    assert np.isfinite(lt) and lt > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in PARAMS:
        assert np.isfinite(gt[k]).all(), f"{k}: non-finite port gradient"
        assert np.isfinite(gj[k]).all(), f"{k}: non-finite JAX gradient"
        scale = np.abs(gj[k]).max()
        assert scale > 0, f"{k}: the JAX gradient is all zero"
        np.testing.assert_allclose(gt[k], gj[k], atol=2e-4 * scale,
                                   rtol=2e-3, err_msg=k)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def _materials_scalars_noise(cfg):
    mats = MaterialLibrary.default().table_at(1064)
    scalars = jret.SimScalars.from_config(cfg, 0.0)
    noise = np.asarray(jnoise.make_sim_noise(jax.random.PRNGKey(0)))
    return mats, scalars, noise


def _tile_chunk(L):
    """(a): the 90 x 40 degree TLS scan over boxes, BSP-ordered and culled
    into tiles as both Simulators do it."""
    rpp, radius = (2, 0.001) if L == 1 else (6, 0.1)
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=4)
    bvh = build_scene_bvh(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
        tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=rpp, pulse_radius=radius, max_returns=L,
        chunk_pulses=512, shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=True)
    step = 128 // np.gcd(128, rpp)
    block = -(-max(1, 640 // rpp) // step) * step
    rays = jax.tree.map(jnp.asarray, bsp_order(build_rays(cfg, scene),
                                               block))
    mats, scalars, noise = _materials_scalars_noise(cfg)
    b0, b1 = cfg.max_range_soft_boundary
    t_max = float(cfg.max_range + abs(b0) + abs(b1) + 1.0)
    o, d = np.asarray(rays.origin), np.asarray(rays.direction)
    jtr = PallasCulledTraverser(scene, tile_rays=block * rpp, interpret=True)
    assert jtr.beams_ok(o, d)
    jdata = jtr.prepare(bvh, o, d, t_max=t_max)
    ttr = TileTraverser(convert.scene_from_numpy(_np(scene)),
                        tile_rays=block * rpp, device="cpu")
    tdata = ttr.prepare(convert.bvh_from_numpy(_np(bvh)), o, d, t_max=t_max)
    return Chunk(scene, bvh, cfg, rays, mats, scalars, noise, jtr, jdata,
                 ttr, tdata)


def _pulse_chunk(L):
    """(b), (c): `tests/test_vertgrad.py`'s workload at ``max_returns=L``,
    the ladders in bucket-contiguous pulse order on both sides."""
    rng = np.random.default_rng(11)
    scene = attach_face_neighbors(
        jsyn.rough_terrain(rng, num_tris=8000, half=60.0))
    bvh = build_scene_bvh(scene)
    P, R = 256, 4
    o = np.tile(np.array([[0.0, 50.0, 0.0]], np.float32), (P * R, 1))
    th = rng.uniform(-0.5, 0.5, P)
    ph = rng.uniform(-0.5, 0.5, P)
    d = np.stack([np.sin(th), -np.cos(th) * np.cos(ph), np.sin(ph)], -1)
    d = np.repeat(d, R, axis=0) + rng.normal(0, 2e-3, (P * R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jtr = PulseLadderTraverser(scene, rays_per_pulse=R, interpret=True)
    t_max = jtr._resolve_t_max(bvh, o, None)
    raw = build_pulse_ladders(bvh, o, d, R, t_max=t_max)
    perm, jdata = jtr.pack_permuted(raw, P)
    aux = build_vertex_grad_aux(np.asarray(scene.faces), raw, P,
                                int(scene.vertices.shape[0]))
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL, rays_per_pulse=R,
        max_returns=L, chunk_pulses=P, shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=True, max_range=400.0)
    mats, scalars, noise = _materials_scalars_noise(cfg)
    rays = JRays(origin=jnp.asarray(o.reshape(P, R, 3)[perm]),
                 direction=jnp.asarray(d.reshape(P, R, 3)[perm]),
                 gps_time=jnp.zeros(P, jnp.float32))
    ttr = tpulse.PulseLadderTraverser(
        convert.scene_from_numpy(_np(scene)), rays_per_pulse=R, device="cpu")
    ttr.t_max = t_max
    traw = tpulse.build_pulse_ladders(convert.bvh_from_numpy(_np(bvh)), o, d,
                                      R, t_max=t_max)
    tdata = ttr.upload(tpulse.renumber_pulse_ladders(traw, perm))
    assert scene.num_faces > P * L           # the gate leaves it unpacked
    return Chunk(scene, bvh, cfg, rays, mats, scalars, noise, jtr, jdata,
                 ttr, tdata, aux)


_CACHE = {}


def _chunk(kind, L):
    key = (kind, L)
    if key not in _CACHE:
        _CACHE[key] = (_tile_chunk if kind == "tile" else _pulse_chunk)(L)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 2])
def test_tile_path_grads_match_jax(L):
    ch = _chunk("tile", L)
    lt, gt = port_loss_and_grads(ch)
    lj, gj = jax_loss_and_grads(ch)
    assert_grads_match(lt, gt, lj, gj)


@pytest.mark.parametrize("L", [1, 2])
def test_pulse_path_unpacked_grads_match_jax(L):
    """The port's unpacked branch vs JAX's, whose vertex backward is the
    stock scatter or the scatter-free `vertex_grad_aux` union."""
    ch = _chunk("pulse", L)
    lt, gt = port_loss_and_grads(ch)
    for aux in (None, ch.aux):
        lj, gj = jax_loss_and_grads(ch, aux=aux)
        assert_grads_match(lt, gt, lj, gj)


@pytest.mark.parametrize("L", [1, 2])
def test_pulse_path_packed_grads_match_jax(L):
    ch = _chunk("pulse", L)
    lt, gt = port_loss_and_grads(ch, pack=True)
    lj, gj = jax_loss_and_grads(ch, pack=True)
    assert_grads_match(lt, gt, lj, gj)
    lu, gu = port_loss_and_grads(ch)          # same values either branch
    np.testing.assert_allclose(lt, lu, rtol=1e-6)
    for k in PARAMS:
        np.testing.assert_allclose(gt[k], gu[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(gu[k]).max())


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_face_pack_gate_follows_jax(kind, monkeypatch):
    """``face_pack=None`` builds the pack exactly when F <= P * L, the JAX
    package's gate (`lidar_brdf_tpu/physics/returns.py:370-375`): the tile
    scene (80 faces, 512 pulses) packs, the pulse scene (8,000 faces, 256
    pulses) does not."""
    from lidar_brdf_tpu_torch.physics import returns as tret
    ch = _chunk(kind, 1)
    calls = []
    build = tret.build_face_pack
    monkeypatch.setattr(tret, "build_face_pack",
                        lambda *a: calls.append(1) or build(*a))
    loss, x0 = port_loss_fn(ch)
    assert float(loss(*x0)) > 0
    assert len(calls) == (1 if kind == "tile" else 0)
    assert (ch.scene.num_faces <= ch.rays.num_pulses) == (kind == "tile")


@pytest.mark.parametrize("L", [1, 2])
def test_face_pack_false_forces_unpacked(L, monkeypatch):
    """``face_pack=False`` takes the unpacked branch where the gate would
    pack (the tile scene, 80 faces <= P * L): no pack is built, and the loss
    and gradients are the packed branch's."""
    from lidar_brdf_tpu_torch.physics import returns as tret
    ch = _chunk("tile", L)
    calls = []
    build = tret.build_face_pack
    monkeypatch.setattr(tret, "build_face_pack",
                        lambda *a: calls.append(1) or build(*a))
    lu, gu = port_loss_and_grads(ch, pack=False)
    assert not calls
    lp, gp = port_loss_and_grads(ch)
    assert len(calls) == 1
    np.testing.assert_allclose(lu, lp, rtol=1e-6)
    for k in PARAMS:
        assert np.isfinite(gu[k]).all(), k
        np.testing.assert_allclose(gu[k], gp[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(gp[k]).max(), err_msg=k)


@pytest.mark.parametrize("models", [(2, 5), (4, 6), (3, 1)])
def test_tile_path_analytic_grads_match_jax(models):
    """ANALYTIC shading on the tile path (L = 1): the ground (STONE) and
    the boxes (WOOD) on the analytic models ``models`` (Minnaert and Ward,
    as the default table has them; Cook-Torrance and Oren-Nayar;
    Blinn-Phong and ideal diffuse).  The loss, and the origin, vertex and
    ``peak_power`` gradients against `jax.grad` at the tolerances above;
    the table gradient is zero on both sides (ANALYTIC reads no table)."""
    base = _chunk("tile", 1)
    model = np.asarray(base.mats.brdf_model).copy()
    model[7], model[8] = models
    ch = dataclasses.replace(
        base, cfg=base.cfg.with_(shading_mode=ShadingMode.ANALYTIC),
        mats=base.mats.__class__(**{**base.mats.__dict__,
                                    "brdf_model": jnp.asarray(model)}))
    loss, x0 = port_loss_fn(ch)
    xs = [x.detach().clone().requires_grad_(True) for x in x0]
    val = loss(*xs)
    val.backward()
    lt = float(val.detach())
    gt = {k: x.grad for k, x in zip(PARAMS, xs)}
    lj, gj = jax_loss_and_grads(ch)
    assert np.isfinite(lt) and lt > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert gt.pop("brdf_table") is None and not gj["brdf_table"].any()
    gt = {k: g.numpy() for k, g in gt.items()}
    for k in ("origin", "vertices", "peak_power"):
        assert np.isfinite(gt[k]).all(), f"{k}: non-finite port gradient"
        scale = np.abs(gj[k]).max()
        assert scale > 0, f"{k}: the JAX gradient is all zero"
        np.testing.assert_allclose(gt[k], gj[k], atol=2e-4 * scale,
                                   rtol=2e-3, err_msg=k)


def test_vertex_grads_match_finite_differences():
    """The port alone, unpacked branch: d loss / d vertices against central
    differences on the coordinates with the largest gradient, as
    `tests/test_gradients.py::_fd_check` does.  The loss is the masked
    distance sum (the measured-BRDF lookup jumps at table-cell edges, so
    intensity has no finite difference), evaluated in float64: the port's
    record pass follows its inputs' dtype; the traversal stays f32 and
    fixes the winners."""
    ch = _chunk("pulse", 2)
    p = ch.port_inputs()
    f64 = lambda x: x.double() if x.is_floating_point() else x
    scene = dataclasses.replace(p["scene"], **{
        f.name: f64(getattr(p["scene"], f.name))
        for f in dataclasses.fields(p["scene"])
        if getattr(p["scene"], f.name) is not None})
    mats = dataclasses.replace(p["mats"], roughness=f64(p["mats"].roughness),
                               refractive_index=f64(
                                   p["mats"].refractive_index))
    sc = type(p["scalars"])(**{k: f64(v) for k, v in
                               vars(p["scalars"]).items()})
    rays = type(p["rays"])(**{k: f64(v) for k, v in vars(p["rays"]).items()})
    trav = lambda o, d, data: ch.ttr(o.float(), d.float(), data)

    def loss(verts):
        cloud = tchunk(dataclasses.replace(scene, vertices=verts), mats,
                       rays, f64(p["noise"]), sc, p["cfg"],
                       scene_has_water=False, traverse_fn=trav,
                       traverse_data=ch.tdata)
        return torch.where(cloud.mask, cloud.distance,
                           torch.zeros_like(cloud.distance)).sum()

    v = scene.vertices.clone().requires_grad_(True)
    val = loss(v)
    assert val.dtype == torch.float64
    val.backward()
    g = v.grad.numpy().ravel()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    for idx in np.argsort(-np.abs(g))[:4]:
        e = torch.zeros_like(scene.vertices).view(-1)
        e[idx] = 1e-4
        e = e.view(scene.vertices.shape)
        with torch.no_grad():
            fd = float(loss(scene.vertices + e) - loss(scene.vertices - e)) \
                / 2e-4
        assert abs(fd - g[idx]) <= 0.05 * max(abs(fd), abs(g[idx])) + 1e-7, \
            (idx, fd, g[idx])


def test_tie_rules_follow_jax():
    """A nadir ray on a flat face: |cos(L, N)| is exactly 1, on the upper
    bound of the table clip, where `jnp.clip` passes half the gradient and
    `torch.clamp` all of it; a grazing ray (cos = 0) sits on the lower
    bound and at the kink of |.|, where `jnp.abs` has derivative +1 and
    `torch.abs` 0."""
    N = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    L = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    gj = np.asarray(jax.grad(
        lambda l: jnp.sum(jbrdf.table_angles(l, jnp.asarray(N))[1]))(
            jnp.asarray(L)))
    lt = torch.from_numpy(L).requires_grad_(True)
    tbrdf.table_angles(lt, torch.from_numpy(N))[1].sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), gj, rtol=1e-6)
    assert gj[0, 1] == pytest.approx(45.0, rel=1e-6)    # half of 90
    assert gj[1, 1] == pytest.approx(45.0, rel=1e-6)
    # what torch.clamp / torch.abs would have given
    ln = torch.from_numpy(L).requires_grad_(True)
    cos = torch.abs((ln * torch.from_numpy(N)).sum(-1))
    (torch.clamp(cos, 0.0, 1.0) * 90.0).sum().backward()
    assert ln.grad[0, 1] == pytest.approx(2 * gj[0, 1], rel=1e-6)
    assert ln.grad[1, 1] == 0.0
    # forward values stay PyTorch's, bit for bit
    x = torch.tensor([-2.0, -0.0, 0.0, 0.25, 1.0, 3.0])
    assert torch.equal(safemath.clip(x, 0.0, 1.0), torch.clamp(x, 0.0, 1.0))
    assert torch.equal(safemath.abs_(x), torch.abs(x))
    assert torch.equal(safemath.maximum(x, 0.0), torch.clamp(x, min=0.0))


@pytest.mark.parametrize("bathymetric", [True, False])
def test_water_scan_grads_match_jax(bathymetric):
    """(d): gradients through the refraction scan (`_returns_retraverse`)
    against `jax.grad` of the JAX `simulate_chunk` (jitted, as its users
    run it), on the same rays, noise and scalars, every level on the
    packet walk.

    Every measured-BRDF lookup of this near-nadir scan lands on the
    default tables' retro-reflection peak, where the Hermite value
    exceeds 1 and `clip(., 0, 1)` passes no gradient: the table gradient
    is zero on both sides at both wavelengths (asserted; the table
    gradients of (a)-(c) are compared where the lookups are not clipped).
    JAX's backward is finite everywhere on this scene (asserted): no
    masked bathymetric slot gives 0 * inf here, so no tolerance is set
    for one.  A pulse's two parallel rays reach the flat bottom at the
    same t in real arithmetic; under `jit` XLA's FMA contraction breaks
    that tie for another ray than the port's rounding in ~13% of the
    pulses (level 1 only; asserted below), so the winner, and with it
    the share of the pulse's origin gradient each of its rays gets,
    moves to the other ray.  Origins are therefore compared ray by ray
    where both pick the same winners and summed over the pulse's rays
    elsewhere; the loss, the vertices, `peak_power` and the table at the
    tolerances of (a)-(c)."""
    from test_water import _als_cfg, water_over_ground_scene
    scene = water_over_ground_scene()
    cfg = (_als_cfg() if bathymetric
           else _als_cfg(bathymetric=False, wavelength_nm=(1064, 1064)))
    bvh = build_scene_bvh(scene)
    rays = build_rays(cfg, scene)
    mats = MaterialLibrary.default().table_at(cfg.wavelength_nm[0])
    scalars = jret.SimScalars.from_config(
        cfg, float(np.asarray(scene.vertices)[:, 1].min()))
    noise = jnoise.make_sim_noise(jax.random.PRNGKey(0))
    scene, bvh, mats, scalars = jax.tree.map(jnp.asarray,
                                             (scene, bvh, mats, scalars))

    def jax_rays(origin):
        return JRays(origin=origin, direction=rays.direction,
                     gps_time=rays.gps_time)

    def jloss(table, origin, verts, peak):
        cloud = simulate_chunk(
            scene.__class__(**{**scene.__dict__, "vertices": verts}), bvh,
            mats.__class__(**{**mats.__dict__, "brdf_table": table}),
            jax_rays(origin), noise,
            scalars.__class__(**{**scalars.__dict__, "peak_power": peak}),
            cfg, scene_has_water=True)
        return jnp.sum(jnp.where(cloud.mask, cloud.intensity, 0.0))

    x0 = (mats.brdf_table, jnp.asarray(rays.origin), scene.vertices,
          scalars.peak_power)
    lj, gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(*x0)
    lj, gj = float(lj), {k: np.asarray(g) for k, g in zip(PARAMS, gj)}
    w_jax = np.asarray(jax.jit(lambda o: jret.simulate_returns(
        scene, bvh, mats, jax_rays(o), noise, scalars, cfg,
        scene_has_water=True)[0].winner_ray)(x0[1]))

    ts = convert.scene_from_numpy(_np(scene))
    tm = convert.materials_from_numpy(_np(mats))
    tsc = convert.scalars_from_numpy(_np(scalars))
    tr = convert.rays_from_numpy(_np(rays))
    tn = convert.noise_from_numpy(np.asarray(noise))
    tc = tcfg.SensorConfig.from_json(cfg.to_json())
    walk = make_packet_traverser(ts, convert.bvh_from_numpy(_np(bvh)))

    def tloss(table, origin, verts, peak):
        cloud = tchunk(
            dataclasses.replace(ts, vertices=verts),
            dataclasses.replace(tm, brdf_table=table),
            RayBundle(origin=origin, direction=tr.direction,
                      gps_time=tr.gps_time), tn,
            dataclasses.replace(tsc, peak_power=peak), tc,
            scene_has_water=True, packet_fn=walk)
        return torch.where(cloud.mask, cloud.intensity,
                           torch.zeros_like(cloud.intensity)).sum()

    xs = [x.detach().clone().requires_grad_(True)
          for x in (tm.brdf_table, tr.origin, ts.vertices, tsc.peak_power)]
    val = tloss(*xs)
    val.backward()
    lt, gt = float(val.detach()), {k: x.grad.numpy()
                                   for k, x in zip(PARAMS, xs)}
    records = tret_simulate(ts, tm, tr, tn, tsc, tc, walk)
    assert np.isfinite(lt) and lt > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in PARAMS:
        assert np.isfinite(gt[k]).all(), f"{k}: non-finite port gradient"
        assert np.isfinite(gj[k]).all(), f"{k}: non-finite JAX gradient"
    mask = records.mask.numpy()
    flip = mask & (records.winner_ray.numpy() != w_jax)
    assert set(np.nonzero(flip)[0]) <= {1}
    assert flip.any(axis=0).sum() <= 0.2 * mask.shape[1]
    assert not gt["brdf_table"].any() and not gj["brdf_table"].any()
    for k in ("vertices", "peak_power"):
        scale = np.abs(gj[k]).max()
        assert scale > 0, f"{k}: the JAX gradient is all zero"
        np.testing.assert_allclose(gt[k], gj[k], atol=2e-4 * scale,
                                   rtol=2e-3, err_msg=k)
    same = ~flip.any(axis=0)
    scale = np.abs(gj["origin"]).max()
    assert scale > 0
    np.testing.assert_allclose(gt["origin"][same], gj["origin"][same],
                               atol=2e-4 * scale, rtol=2e-3)
    np.testing.assert_allclose(gt["origin"].sum(1), gj["origin"].sum(1),
                               atol=2e-4 * scale, rtol=2e-3)


def tret_simulate(scene, mats, rays, noise, scalars, cfg, walk):
    """The port's records of the water scan (winners per level)."""
    from lidar_brdf_tpu_torch.physics.returns import simulate_returns
    with torch.no_grad():
        return simulate_returns(scene, mats, rays, noise, scalars, cfg,
                                scene_has_water=True, packet_fn=walk)[0]
