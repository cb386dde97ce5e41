"""The port's sharded scan and training step (`lidar_brdf_tpu_torch/parallel/
shard.py`) against the JAX package's 4-device mesh
(`lidar_brdf_tpu/parallel/shard.py`) on the same inputs.

JAX runs on ``jax.devices()[:4]`` of the 8 virtual CPU devices of
`tests/conftest.py`, K2 through `PulseLadderTraverser(interpret=True)`, the
tile path through `CulledTraverser` with the port's tile of 128 rays.  The
port's 4 shards run in this process: one shard at a time (``RayMesh(None,
k, 4, cpu)``: no collective) for the forwards and culls; for the training
steps and the ladder ``t_max``, on four threads whose mesh sums (or maxes)
across them through a barrier in place of `torch.distributed`, so that the
step's own reductions and update run.  Scenes and the TLS scan are
`tests/test_shard.py`'s (512 pulses x 2 rays over a ground plane); the
ground plane of 200 faces puts the face-pack gate ``F <= P * L`` between a
shard's 128 pulses and the scan's 512.

Tolerances are `tests/test_shard.py`'s: intensity rtol 1e-5 / atol 1e-7
(1e-4 on the culled tile and ladder paths, as that file loosens them),
masks equal; positions, which carry each ray index's noise, atol 1e-4
(as `tests/test_torch_simulate_pulse.py`); loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-8; the updated
materials (p - 1e-3 g) rtol 1e-5 / atol 1e-8.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.geom.beamcull import CulledTraverser
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.kernels.pulse_pallas import PulseLadderTraverser
from lidar_brdf_tpu.parallel import shard as jshard
from lidar_brdf_tpu.physics.returns import SimScalars
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom.packet import make_packet_traverser
from lidar_brdf_tpu_torch.io import native as tnative
from lidar_brdf_tpu_torch.kernels import pulse as tpulse
from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser, default_t_max
from lidar_brdf_tpu_torch.parallel import shard as tshard
from lidar_brdf_tpu_torch.physics import returns as treturns

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

N = 4                  # shards
CPU = torch.device("cpu")
LEAVES = ("refractive_index", "roughness", "brdf_table", "reflectivity_f0")


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@dataclasses.dataclass
class Case:
    """One scene and scan on both sides: ``j*`` JAX, ``t*`` the port's."""
    jscene: object
    jbvh: object
    jcfg: object
    jrays: object
    jmats: object
    jscalars: object
    jnoise: object
    tscene: object
    tbvh: object
    tcfg: object
    trays: object
    tmats: object
    tscalars: object
    tnoise: object


_CASES = {}


def _case(cells: int, shiny: bool = False) -> Case:
    """`tests/test_shard.py`'s scan over a ground plane of 2 * cells^2
    faces; ``shiny`` turns on the shiny-surface error, which displaces each
    point by the noise of its ray index."""
    if (cells, shiny) not in _CASES:
        v, f = jsyn.ground_plane(half=40.0, y=0.0, cells=cells)
        scene = jsyn.scene_from_arrays(v, f)
        bvh = build_scene_bvh(scene)
        cfg = SensorConfig(
            lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
            tls_position=(0.0, 12.0, 0.0),
            tls_fov_horizontal=360.0, tls_fov_vertical=60.0,
            tls_middle_angle_vertical=-45.0,
            tls_resolution_horizontal=32, tls_resolution_vertical=16,
            rays_per_pulse=2, max_returns=1, chunk_pulses=512,
            shading_mode=ShadingMode.MEASURED,
            include_shiny_surface_error=shiny)
        rays = build_rays(cfg, scene)
        mats = MaterialLibrary.default().table_at(1064)
        scalars = SimScalars.from_config(cfg, 0.0)
        noise = jnoise.make_sim_noise(jax.random.PRNGKey(0))
        _CASES[cells, shiny] = Case(
            scene, bvh, cfg, rays, mats, scalars, noise,
            convert.scene_from_numpy(_np(scene)),
            convert.bvh_from_numpy(_np(bvh)),
            tcfg.SensorConfig.from_json(cfg.to_json()),
            convert.rays_from_numpy(_np(rays)),
            convert.materials_from_numpy(_np(mats)),
            convert.scalars_from_numpy(_np(scalars)),
            convert.noise_from_numpy(noise))
    return _CASES[cells, shiny]


def _jax_path(c: Case, path: str, mesh):
    """(traverse_fn, sharded traverse data) of one path on the JAX mesh."""
    if path == "tile":
        tr = CulledTraverser(c.jscene, tile_rays=128, chunk=8)
        return tr, jshard.shard_buckets_put(
            jshard.build_sharded_buckets(tr, c.jbvh, c.jrays, mesh), mesh)
    if path == "ladder":
        tr = PulseLadderTraverser(c.jscene, rays_per_pulse=2, interpret=True)
        return tr, jshard.shard_traverse_data(
            jshard.build_sharded_traverse_data(tr, c.jbvh, c.jrays, mesh),
            mesh)
    return None, None


def _port_path(c: Case, path: str, mesh, rays):
    """(traverse_fn, traverse data, packet_fn) of one path on one port
    shard."""
    if path == "packet":
        return None, None, make_packet_traverser(c.tscene, c.tbvh)
    tr = (TileTraverser(c.tscene, tile_rays=128, device="cpu")
          if path == "tile" else
          tpulse.PulseLadderTraverser(c.tscene, rays_per_pulse=2,
                                      device="cpu"))
    data = tshard.shard_traverse_data(
        tshard.build_sharded_traverse_data(tr, c.tbvh, rays, mesh), mesh)
    return tr, data, None


_JAX_FWD = {}


def _jax_forward(cells: int, path: str):
    """The JAX mesh's cloud and traverser for (cells, path), computed
    once."""
    key = (cells, path)
    if key not in _JAX_FWD:
        c = _case(cells)
        mesh = jshard.ray_mesh(jax.devices()[:N])
        tr, data = _jax_path(c, path, mesh)
        fwd = jshard.sharded_forward(mesh, c.jcfg, scene_has_water=False,
                                     traverse_fn=tr)
        cloud = fwd(c.jscene, c.jbvh, c.jmats, c.jrays, c.jnoise, c.jscalars,
                    data)
        _JAX_FWD[key] = (cloud, tr, data, mesh)
    return _JAX_FWD[key]


# ---------------------------------------------------------------------------
# a mesh of threads: the step's collectives without torch.distributed
# ---------------------------------------------------------------------------

class _Hub:
    """Sums (or maxes) one tensor of each of ``n`` threads, in rank
    order, and hands every thread the same result."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n, timeout=300)
        self.slots = [None] * n

    def reduce(self, rank, tensor, op):
        self.slots[rank] = tensor.detach().clone()
        self.barrier.wait()
        out = self.slots[0].clone()
        for t in self.slots[1:]:
            out = torch.maximum(out, t) if op == dist.ReduceOp.MAX \
                else out + t
        self.barrier.wait()            # every thread has read the slots
        tensor.copy_(out)
        return tensor


@dataclasses.dataclass(frozen=True)
class ThreadMesh(tshard.RayMesh):
    hub: object = None

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM):
        return self.hub.reduce(self.rank, tensor, op)


def _on_threads(fn):
    """[fn(mesh of shard k) for k in range(N)], each on its own thread."""
    hub = _Hub(N)
    out, errors = [None] * N, []

    def run(k):
        try:
            out[k] = fn(ThreadMesh(None, k, N, CPU, hub))
        except BaseException as exc:      # re-raised below, in the test
            errors.append(exc)
            hub.barrier.abort()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a shard thread hangs"
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells", [3, 10])
@pytest.mark.parametrize("path", ["tile", "ladder", "packet"])
def test_sharded_forward_matches_jax_mesh(path, cells, monkeypatch):
    """Each port shard's cloud = its rows of the JAX mesh's cloud.  With 200
    faces the face pack is built for the scan's 512 pulses but not for a
    shard's 128: the port, like each JAX shard, gates on its own pulses."""
    c = _case(cells)
    cj, jtr, _, _ = _jax_forward(cells, path)
    built = []
    real = treturns.build_face_pack
    monkeypatch.setattr(treturns, "build_face_pack",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    tol = dict(rtol=1e-5, atol=1e-7) if path == "packet" \
        else dict(rtol=1e-4, atol=1e-7)
    per = c.trays.num_pulses // N
    for k in range(N):
        mesh = tshard.RayMesh(None, k, N, CPU)
        rays = tshard.shard_rays(c.trays, mesh)
        assert rays.num_pulses == per
        tr, data, pk = _port_path(c, path, mesh, rays)
        cloud = tshard.sharded_forward(mesh, c.tcfg, traverse_fn=tr,
                                       packet_fn=pk)(
            c.tscene, c.tmats, rays, c.tnoise, c.tscalars, data)
        rows = slice(k * per, (k + 1) * per)           # L = 1
        np.testing.assert_array_equal(cloud.mask.numpy(),
                                      np.asarray(cj.mask)[rows])
        np.testing.assert_allclose(cloud.intensity.numpy(),
                                   np.asarray(cj.intensity)[rows], **tol)
        if path == "ladder":           # a fixed TLS origin: one far for all
            assert tr.t_max == jtr.t_max
    assert np.asarray(cj.mask).sum() > 400
    assert len(built) == (N if c.tscene.num_faces <= per else 0)
    assert (c.tscene.num_faces <= per) == (cells == 3)
    assert c.tscene.num_faces <= N * per


def test_each_shard_draws_its_noise_from_ray_index_0():
    """The shiny-surface error displaces a point by the noise of its ray
    index.  Each JAX shard draws from index 0 (no ``base_ray_index``), and
    so does each port shard: positions agree to atol 1e-4; shard 1 drawn
    from its global offset instead would not."""
    from lidar_brdf_tpu_torch.runtime.simulate import simulate_chunk
    c = _case(3, shiny=True)
    mesh = jshard.ray_mesh(jax.devices()[:N])
    cj = jshard.sharded_forward(mesh, c.jcfg, scene_has_water=False)(
        c.jscene, c.jbvh, c.jmats, c.jrays, c.jnoise, c.jscalars)
    pk = make_packet_traverser(c.tscene, c.tbvh)
    per = c.trays.num_pulses // N
    for k in range(N):
        m = tshard.RayMesh(None, k, N, CPU)
        rays = tshard.shard_rays(c.trays, m)
        cloud = tshard.sharded_forward(m, c.tcfg, packet_fn=pk)(
            c.tscene, c.tmats, rays, c.tnoise, c.tscalars)
        want = np.asarray(cj.position)[k * per:(k + 1) * per]
        np.testing.assert_array_equal(cloud.mask.numpy(),
                                      np.asarray(cj.mask)[k * per:
                                                          (k + 1) * per])
        np.testing.assert_allclose(cloud.position.numpy(), want, rtol=0,
                                   atol=1e-4)
        if k == 1:
            offset = simulate_chunk(
                c.tscene, c.tmats, rays, c.tnoise, c.tscalars, c.tcfg,
                base_ray_index=per * 2, scene_has_water=False, packet_fn=pk)
            m1 = offset.mask.numpy()
            assert np.abs(offset.position.numpy()[m1] - want[m1]).max() \
                > 1e-3


def test_shard_rays_needs_an_even_split():
    rays = _case(3).trays
    with pytest.raises(ValueError, match="not divisible"):
        tshard.shard_rays(rays, tshard.RayMesh(None, 0, 3, CPU))


# ---------------------------------------------------------------------------
# buckets, ladders and t_max
# ---------------------------------------------------------------------------

def _assert_buckets_equal(jbuckets, tbuckets, k, pad_id):
    """Shard k of JAX's stacked (ids (N, B), cand (N, B, C)) buckets with
    the union padding (id ``pad_id``, candidates -1) stripped = the port's
    (ids (B_k,), cand (B_k, C)) buckets of shard k."""
    port = {c.shape[1]: (np.asarray(i), np.asarray(c)) for i, c in tbuckets}
    assert set(port) <= {c.shape[-1] for _, c in jbuckets}
    for ids, cand in jbuckets:
        ids, cand = ids[k], cand[k]
        C = cand.shape[-1]
        B = port[C][0].shape[0] if C in port else 0
        if C in port:
            np.testing.assert_array_equal(ids[:B], port[C][0])
            np.testing.assert_array_equal(cand[:B], port[C][1])
        assert (ids[B:] == pad_id).all() and (cand[B:] == -1).all()


def _jax_ladders(jdata):
    """JAX `prepare_sharded`'s (pidx (N, B), ids (N, NB, KB, 8, 128)) per K
    as (pidx (N, B), cand (N, B, K))."""
    out = []
    for pidx, _, ids in jdata:
        ids = np.asarray(ids)
        n, NB, KB, cb, lanes = ids.shape
        cand = ids.transpose(0, 1, 4, 2, 3).reshape(n, NB * lanes, KB * cb)
        out.append((np.asarray(pidx), cand))
    return out


def test_buckets_and_ladders_match_jax_without_union_padding(monkeypatch):
    """With the numpy culler on both sides, each rank's tile buckets and
    pulse ladders are JAX's stacked arrays with the union padding (dummy
    tile ``n_tiles``, pad pulse ``per``) stripped."""
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    c = _case(10)
    mesh = jshard.ray_mesh(jax.devices()[:N])
    jb = jshard.build_sharded_buckets(
        CulledTraverser(c.jscene, tile_rays=128, chunk=8), c.jbvh, c.jrays,
        mesh)
    jtr = PulseLadderTraverser(c.jscene, rays_per_pulse=2, interpret=True)
    jl = _jax_ladders(jshard.build_sharded_traverse_data(
        jtr, c.jbvh, c.jrays, mesh))
    per = c.trays.num_pulses // N
    ttile = TileTraverser(c.tscene, tile_rays=128, device="cpu")
    tlad = tpulse.PulseLadderTraverser(c.tscene, rays_per_pulse=2,
                                       device="cpu")
    for k in range(N):
        tmesh = tshard.RayMesh(None, k, N, CPU)
        rays = tshard.shard_rays(c.trays, tmesh)
        _assert_buckets_equal(
            jb, tshard.build_sharded_buckets(ttile, c.tbvh, rays), k,
            pad_id=per * 2 // 128)                    # n_tiles of a shard
        _assert_buckets_equal(
            jl, tlad.prepare_sharded(c.tbvh, rays.origin, rays.direction,
                                     tmesh), k, pad_id=per)
        assert tlad.t_max == jtr.t_max


def _als_case():
    scene = jsyn.rough_terrain(np.random.default_rng(0), num_tris=4000,
                               half=30.0)
    cfg = SensorConfig(
        lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 40.0, 0.0),
        als_fov_horizontal=70.0, als_fov_vertical=4.5,
        als_scan_frequency=40, als_pulse_frequency=2560, als_speed=30.0,
        max_range=400.0, rays_per_pulse=4, pulse_radius=0.3, max_returns=1,
        chunk_pulses=1024, shading_mode=ShadingMode.MEASURED)
    rays = jax.tree.map(lambda a: np.asarray(a)[:1024],
                        build_rays(cfg, scene))
    return scene, build_scene_bvh(scene), rays


def test_ladder_t_max_is_the_global_one_on_an_als_flight(monkeypatch):
    """On a flight the shards' own far distances differ; every rank's
    ladders take JAX's one ``t_max`` over all pulses (the MAX over the
    ranks), and are JAX's per-shard ladders.  The JAX package culls with
    the port's native library (no fused multiply-adds: the arithmetic of
    the port's cull on the device, whose lists it must equal in order)."""
    from lidar_brdf_tpu.io import native as jnative
    monkeypatch.delenv("LIDAR_BRDF_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_lib", tnative.get_lib())
    monkeypatch.setattr(jnative, "_tried", True)
    scene, bvh, rays = _als_case()
    o = np.asarray(rays.origin).reshape(-1, 3)
    d = np.asarray(rays.direction).reshape(-1, 3)
    jtr = PulseLadderTraverser(scene, rays_per_pulse=4, interpret=True)
    jl = _jax_ladders(jtr.prepare_sharded(bvh, o, d, N))
    tscene = convert.scene_from_numpy(_np(scene))
    tbvh = convert.bvh_from_numpy(_np(bvh))
    trays = convert.rays_from_numpy(_np(rays))
    own = []
    for k in range(N):
        rk = tshard.shard_rays(trays, tshard.RayMesh(None, k, N, CPU))
        own.append(default_t_max(tbvh, rk.origin))
    assert len(set(own)) > 1 and max(own) == jtr.t_max

    def shard(mesh):
        tr = tpulse.PulseLadderTraverser(tscene, rays_per_pulse=4,
                                         device="cpu")
        rk = tshard.shard_rays(trays, mesh)
        data = tshard.build_sharded_traverse_data(tr, tbvh, rk, mesh)
        return tr.t_max, data

    per = trays.num_pulses // N
    for k, (t_max, data) in enumerate(_on_threads(shard)):
        assert t_max == jtr.t_max
        _assert_buckets_equal(jl, data, k, pad_id=per)


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,grad_params", [
    ("packet", "materials"), ("packet", "full"), ("tile", "full"),
    ("ladder", "materials")])
def test_sharded_train_step_matches_jax_mesh(path, grad_params):
    """The port's step on four shards (their losses and replicated
    gradients summed across the shards by the step itself) = the JAX
    mesh's step: loss, material, vertex and origin gradients, updated
    materials."""
    c = _case(3)
    cj, jtr, jdata, mesh = _jax_forward(3, path)
    target = jnp.where(cj.mask, cj.intensity * 1.3, 0.0)
    jstep = jshard.sharded_train_step(mesh, c.jcfg, scene_has_water=False,
                                      traverse_fn=jtr, grad_params=grad_params)
    jloss, jnew, jgrads = jstep(c.jscene, c.jbvh, c.jmats, c.jrays, c.jnoise,
                                c.jscalars, target, jdata)
    per = c.trays.num_pulses // N
    ttarget = torch.from_numpy(np.array(target))

    def shard(m):
        rays = tshard.shard_rays(c.trays, m)
        tr, data, pk = _port_path(c, path, m, rays)
        step = tshard.sharded_train_step(m, c.tcfg, traverse_fn=tr,
                                         packet_fn=pk,
                                         grad_params=grad_params)
        return step(c.tscene, c.tmats, rays, c.tnoise, c.tscalars,
                    ttarget[m.rank * per:(m.rank + 1) * per], data)

    res = _on_threads(shard)
    loss, new, grads = res[0]
    for other in res[1:]:              # one reduced result on every shard
        assert torch.equal(other[0], loss)
        for k in LEAVES:
            assert torch.equal(getattr(other[1], k), getattr(new, k))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss) > 0
    gtol = dict(rtol=1e-4, atol=1e-8)
    if grad_params == "full":
        tmat, jmat = grads["materials"], jgrads["materials"]
        np.testing.assert_allclose(grads["vertices"].numpy(),
                                   np.asarray(jgrads["vertices"]), **gtol)
        origin = torch.cat([r[2]["origin"] for r in res])
        np.testing.assert_allclose(origin.numpy(),
                                   np.asarray(jgrads["origin"]), **gtol)
        assert np.abs(origin.numpy()).sum() > 0
    else:
        tmat, jmat = grads, jgrads
    for k, tg, jg in zip(LEAVES, tmat, jmat):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **gtol,
                                   err_msg=k)
        np.testing.assert_allclose(getattr(new, k).numpy(),
                                   np.asarray(getattr(jnew, k)), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    assert np.abs(tmat[2].numpy()).sum() > 0       # BRDF table gradients


def test_train_step_rejects_unknown_grad_params():
    with pytest.raises(ValueError, match="grad_params"):
        tshard.sharded_train_step(tshard.RayMesh(None, 0, 1, CPU),
                                  _case(3).tcfg, grad_params="vertices")
