"""The runtime of the port against the JAX package's (`tests/test_runtime.py`
on the port): chunking, checkpoint/resume (files written by either package
resumed by the other), material parameters, `PipelineMetrics`, the ladder
cache, the BSP-order cache and the compacted readback's count hints,
`Simulator.benchmark`, `coherent_order` and a caller's ``traverse_fn``.

The port runs on the CPU with the JAX `Simulator`'s sim-noise buffer, on
the JAX rays.  Repeat runs from the caches must give clouds equal bit for
bit to the first run and to a run without caches.  Port vs JAX clouds
follow `tests/test_torch_simulate.py`: masks exact, positions atol 1e-4.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core.config import SensorConfig, ShadingMode
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.runtime import checkpoint as jckpt
from lidar_brdf_tpu.runtime import simulate as jsim
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core.types import PointCloud
from lidar_brdf_tpu_torch.geom.packet import make_packet_traverser
from lidar_brdf_tpu_torch.runtime import checkpoint as tckpt
from lidar_brdf_tpu_torch.runtime import simulate as tsim
from lidar_brdf_tpu_torch.runtime.metrics import (PipelineMetrics,
                                                  device_trace)

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(PointCloud)]


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@dataclasses.dataclass
class Case:
    """One workload in both packages' types."""
    scene: object
    bvh: object
    cfg: SensorConfig
    rays: object
    mats: object

    def port(self, **kw):
        """The port's `Simulator` on the CPU with the JAX noise buffer."""
        return tsim.Simulator(
            scene=convert.scene_from_numpy(_np(self.scene)),
            bvh=convert.bvh_from_numpy(_np(self.bvh)),
            materials=convert.materials_from_numpy(_np(self.mats)),
            cfg=tcfg.SensorConfig.from_json(self.cfg.to_json()),
            device="cpu", noise_buf=convert.noise_from_numpy(
                jnoise.make_sim_noise(jax.random.PRNGKey(self.cfg.seed))),
            **kw)

    def jax(self, **kw):
        return jsim.Simulator(scene=self.scene, bvh=self.bvh,
                              materials=self.mats, cfg=self.cfg, **kw)

    def port_rays(self):
        return convert.rays_from_numpy(_np(self.rays))


def _mk(chunk_pulses, narrow=False):
    """`tests/test_runtime.py::_mk`; ``narrow``: the 40 x 30 degree field of
    view of its ladder-cache test, whose chunks pass the beam gate."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=3)
    cfg = SensorConfig(
        tls_position=(0.0, 9.0, 0.0), tls_fov_vertical=70.0,
        tls_middle_angle_vertical=-40.0, tls_fov_horizontal=360.0,
        tls_resolution_horizontal=24, tls_resolution_vertical=8,
        rays_per_pulse=2, max_returns=1, chunk_pulses=chunk_pulses,
        shading_mode=ShadingMode.LAMBERTIAN,
        include_shiny_surface_error=False)
    if narrow:
        cfg = cfg.with_(tls_fov_horizontal=40.0, tls_fov_vertical=30.0)
    return Case(scene, build_scene_bvh(scene), cfg, build_rays(cfg, scene),
                MaterialLibrary.default().table_at(1064))


def _assert_equal(a: PointCloud, b: PointCloud):
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _assert_matches_jax(ct: PointCloud, cj):
    """Port vs JAX, both compacted on the host (masks, ids exact,
    positions and distances atol 1e-4, intensity rtol 1e-4)."""
    ct = ct.compact_host()
    cj = {k: np.asarray(v)[np.asarray(cj.mask)] for k, v in _np(cj).items()}
    for k in ("return_number", "comp_id", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(), cj[k],
                                      err_msg=k)
    for k in ("position", "distance"):
        np.testing.assert_allclose(getattr(ct, k).numpy(), cj[k], rtol=0,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ct.intensity.numpy(), cj["intensity"],
                               rtol=1e-4, atol=0)


def _sorted_points(cloud):
    p = cloud.position[cloud.mask].numpy()
    return p[np.lexsort(p.T[::-1])]


def test_chunked_equals_single_pass():
    """Chunks of 64 and one chunk of all 192 pulses give the same points
    (wide beams: the packet walk), and the chunked run matches JAX's."""
    case = _mk(64)
    chunked = case.port().run(case.port_rays())
    single = dataclasses.replace(case, cfg=case.cfg.with_(
        chunk_pulses=24 * 8)).port().run(case.port_rays())
    assert int(chunked.mask.sum()) == int(single.mask.sum()) > 100
    np.testing.assert_allclose(_sorted_points(chunked),
                               _sorted_points(single), atol=1e-3)
    _assert_matches_jax(chunked, case.jax(compact_readback=False).run(
        case.rays))


def _truncate(ck, n):
    with open(ck.state_path, "w") as fh:
        json.dump({"completed_chunks": n}, fh)


def test_checkpoint_resume(tmp_path):
    case = _mk(48)
    sim = case.port()
    ckdir = str(tmp_path / "ck")
    full = sim.run(case.port_rays(), checkpoint_dir=ckdir)
    ck = tckpt.ChunkCheckpointer(ckdir)
    assert ck.completed_chunks() == -(-case.rays.num_pulses // 48) == 4
    _assert_equal(ck.load_all(), full.compact_host())
    _truncate(ck, 1)                    # a crash after the first chunk
    calls = []
    run_chunk = sim.run_chunk
    sim.run_chunk = lambda *a, **k: calls.append(1) or run_chunk(*a, **k)
    resumed = sim.run(case.port_rays(), checkpoint_dir=ckdir)
    assert len(calls) == 3 and ck.completed_chunks() == 4
    _assert_equal(resumed.compact_host(), full.compact_host())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A checkpoint directory written by one package, cut after two of its
    four chunks, is resumed by the other: the result is the uninterrupted
    run's points."""
    case = _mk(48, narrow=True)
    ckdir = str(tmp_path / "ck")
    if writer == "jax":
        case.jax(compact_readback=False).run(case.rays,
                                             checkpoint_dir=ckdir)
        _truncate(tckpt.ChunkCheckpointer(ckdir), 2)
        resumed = case.port().run(case.port_rays(), checkpoint_dir=ckdir)
        _assert_matches_jax(resumed, case.jax(compact_readback=False).run(
            case.rays))
        return
    full = case.port().run(case.port_rays(), checkpoint_dir=ckdir)
    _truncate(tckpt.ChunkCheckpointer(ckdir), 2)
    resumed = case.jax(compact_readback=False).run(case.rays,
                                                   checkpoint_dir=ckdir)
    _assert_matches_jax(full, resumed)
    assert jckpt.ChunkCheckpointer(ckdir).completed_chunks() == 4


def test_params_roundtrip_across_packages(tmp_path):
    """`save_params` / `load_params` round trip, and a params file written
    by either package loads in the other with the same arrays."""
    mats = convert.materials_from_numpy(
        _np(MaterialLibrary.default().table_at(1064)))
    path = str(tmp_path / "port.npz")
    tckpt.save_params(path, mats, step=42, lr=np.float32(0.5))
    back, step, extra = tckpt.load_params(path)
    assert step == 42 and float(extra["lr"]) == 0.5
    for f in dataclasses.fields(mats):
        assert torch.equal(getattr(back, f.name), getattr(mats, f.name))
    jmats, jstep, _ = jckpt.load_params(path)
    assert jstep == 42
    np.testing.assert_array_equal(np.asarray(jmats.brdf_table),
                                  mats.brdf_table.numpy())
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params(jpath, MaterialLibrary.default().table_at(532), step=7)
    tmats, tstep, _ = tckpt.load_params(jpath)
    assert tstep == 7
    for k, v in _np(MaterialLibrary.default().table_at(532)).items():
        np.testing.assert_array_equal(getattr(tmats, k).numpy(), v)


def test_metrics_aggregation(tmp_path):
    import time
    m = PipelineMetrics()
    for _ in range(3):
        with m.stage("TRAVERSE", sync=torch.zeros(2)):
            time.sleep(0.01)
    assert m.mean("TRAVERSE") >= 0.01 and len(m.samples["TRAVERSE"]) == 3
    assert "TRAVERSE" in m.report()
    m2 = PipelineMetrics(discard_first=True)
    m2.samples["X"] = [100.0, 1.0, 1.0]
    assert abs(m2.mean("X") - 1.0) < 1e-9 and m2.std("X") == 0.0
    m.add(m2)
    assert m.samples["X"] == [100.0, 1.0, 1.0]
    m.footer = "footer line"
    path = str(tmp_path / "report.txt")
    m.export(path)
    with open(path) as fh:
        text = fh.read()
    assert text.endswith("footer line\n") and "X" in text
    with device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


@pytest.fixture
def spy_cull(monkeypatch):
    """Counts host culls: `TileTraverser.prepare` and the pulse path's
    `build_pulse_ladders`."""
    calls = []
    prepare = tsim.TileTraverser.prepare
    ladders = tsim.build_pulse_ladders
    monkeypatch.setattr(tsim.TileTraverser, "prepare",
                        lambda *a, **k: calls.append("tile")
                        or prepare(*a, **k))
    monkeypatch.setattr(tsim, "build_pulse_ladders",
                        lambda *a, **k: calls.append("pulse")
                        or ladders(*a, **k))
    return calls


@pytest.mark.parametrize("use_pulse", [False, True])
@pytest.mark.parametrize("compact", [False, True])
def test_ladder_cache_repeat_run_identical(spy_cull, use_pulse, compact):
    """A repeat run of the same rays culls nothing (every chunk from the
    cache) and gives the first run's cloud bit for bit, which is also the
    cloud of a run without the cache: the cache changes no pulse's slot
    or noise draw (the pulse path caches the permuted slice)."""
    case = _mk(64, narrow=True)
    kw = dict(use_pulse=use_pulse, compact_readback=compact)
    sim = case.port(**kw)
    assert sim.use_pulse == use_pulse and sim.reorder == (not use_pulse)
    first = sim.run(case.port_rays())
    n_chunks = 3
    assert spy_cull == ["pulse" if use_pulse else "tile"] * n_chunks
    assert len(sim._ladder_cache) == n_chunks
    stats = {}
    second = sim.run(case.port_rays(), stats=stats)
    assert len(spy_cull) == n_chunks, "cache miss on an identical repeat run"
    assert stats["cull_s"] < 0.05
    _assert_equal(first, second)
    plain = case.port(cache_ladders=False, **kw)
    _assert_equal(first, plain.run(case.port_rays()))
    assert not plain._ladder_cache
    # a new bundle of the same content hits too (the key is the content)
    third = sim.run(convert.rays_from_numpy(_np(case.rays)))
    assert len(spy_cull) == n_chunks * 2
    _assert_equal(first, third)


def test_ladder_cache_eviction(spy_cull):
    """``cache_ladders_max=2`` over six culled chunks keeps the last two
    (FIFO); a repeat run then culls the four evicted chunks again."""
    case = _mk(32, narrow=True)
    sim = case.port(cache_ladders_max=2)
    rays = case.port_rays()
    first = sim.run(rays)
    assert len(spy_cull) == 6 and len(sim._ladder_cache) == 2
    run_key = sim._ray_key(rays, {k: getattr(rays, k).numpy()
                                  for k in ("origin", "direction")})
    assert list(sim._ladder_cache) == [f"{run_key}:{lo}:{lo + 32}:32"
                                       for lo in (128, 160)]
    _assert_equal(first, sim.run(rays))
    assert len(spy_cull) == 6 + 6     # FIFO: each chunk evicts the next
    assert len(sim._ladder_cache) == 2


def test_bsp_order_cache_and_keys_follow_jax(monkeypatch):
    """The run key is JAX's `_ray_key` (blake2b-16 of the f32 rays and
    t_max), memoised on the tensors' identity; the BSP order is computed
    once per bundle and the last two bundles are kept."""
    case = _mk(64, narrow=True)
    sim = case.port()
    jax_sim = case.jax()
    rays = case.port_rays()
    host = {k: getattr(rays, k).numpy() for k in ("origin", "direction")}
    assert sim._ray_key(rays, host) == jax_sim._ray_key(case.rays)
    o, d = host["origin"][:64], host["direction"][:64]
    assert sim._chunk_key(o, d) == jax_sim._chunk_key(o, d)
    orders = []
    bsp = tsim.bsp_order
    monkeypatch.setattr(tsim, "bsp_order",
                        lambda *a: orders.append(1) or bsp(*a))
    sim.run(rays)
    sim.run(rays)
    assert len(orders) == 1
    flipped = convert.rays_from_numpy(
        {k: v[::-1].copy() for k, v in _np(case.rays).items()})
    other = convert.rays_from_numpy(
        {k: v[1:].copy() for k, v in _np(case.rays).items()})
    sim.run(flipped)
    sim.run(other)
    assert len(orders) == 3 and len(sim._bsp_cache) == 2
    sim.run(rays)                       # evicted: ordered again
    assert len(orders) == 4


def test_compact_readback_equals_dense():
    """The compacted readback gives the dense run's valid points in slot
    order, mask all True."""
    case = _mk(64)
    dense = case.port(compact_readback=False).run(case.port_rays())
    compact = case.port(compact_readback=True).run(case.port_rays())
    assert bool(compact.mask.all())
    assert compact.capacity == int(dense.mask.sum()) > 0
    _assert_equal(compact, dense.compact_host())


def test_compact_readback_hint_prefetch_repeat_run(monkeypatch):
    """The second run takes the count-hint branch on every chunk (its
    prefix fetched next to the count) and gives the first run's cloud
    exactly; a hint that falls short takes the count-then-slice
    fallback, with the same cloud."""
    case = _mk(64, narrow=True)
    sim = case.port(compact_readback=True)
    first = sim.run(case.port_rays())
    assert len(sim._count_hints) == 3
    fetched = []
    to_host = tsim._to_host
    monkeypatch.setattr(tsim, "_to_host",
                        lambda t: fetched.append(t.shape) or to_host(t))
    second = sim.run(case.port_rays())
    assert len(fetched) == 2 * 3          # the prefix and the count
    _assert_equal(first, second)
    monkeypatch.setattr(tsim, "_pad_rows", lambda n, cap: min(n, cap))
    for k in sim._count_hints:
        sim._count_hints[k] = 1          # short hints
    fetched.clear()
    stats = {}
    third = sim.run(case.port_rays(), stats=stats)
    assert [s[0] for s in fetched[::2]] == [1, 1, 1]
    _assert_equal(first, third)
    assert stats["readback_bytes"] > 3 * 4 + third.capacity * 20 * 4


def test_benchmark_numexecs_per_stage():
    """`Simulator.benchmark`: num_execs samples of every stage, first-run
    discard, positive means.  (No ordering of stage means is asserted:
    wall-clock means of small stages on a shared host are not ordered.)"""
    case = _mk(192)
    metrics = case.port().benchmark(case.port_rays(), num_execs=3,
                                    discard_first=True)
    report = metrics.report()
    for s in ("RAY_BUILDING", "TRAVERSE_PREP", "FIND_COLLISION", "REDUCE",
              "INTENSITY", "TOTAL", "READ"):
        assert len(metrics.samples[s]) == 3, (s, report)
        assert len(metrics._kept(s)) == 2
        assert metrics.mean(s) > 0.0
    assert "TOTAL" in report and "FIND_COLLISION" in report


def test_benchmark_steady_state_report(spy_cull):
    case = _mk(48, narrow=True)
    sim = case.port()
    metrics = sim.benchmark(case.port_rays(), num_execs=3, steady_chunks=2)
    rep = metrics.report()
    assert "RUN_FIRST" in rep and "RUN_STEADY" in rep and "points/s" in rep
    assert len(metrics.samples["RUN_FIRST"]) == 1
    assert len(metrics.samples["RUN_STEADY"]) == 2
    # the steady passes cull every chunk (ladder cache off), 2 chunks each
    assert len(metrics.samples["RUN_CHUNK_TOTAL"]) == 4
    assert len(metrics.samples["RUN_CHUNK_PREP"]) == 4
    assert len(spy_cull) == 3 + 3 * 2 and sim.cache_ladders
    assert not sim._ladder_cache


def test_benchmark_skips_reduce_on_water():
    """Water scenes re-traverse their bounce levels, so REDUCE and
    INTENSITY are not timed there (as in JAX)."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234),
                                    num_boxes=2, water_patch=True)
    cfg = _mk(64, narrow=True).cfg.with_(max_returns=2, chunk_pulses=64)
    case = Case(scene, build_scene_bvh(scene), cfg, build_rays(cfg, scene),
                MaterialLibrary.default().table_at(1064))
    sim = case.port()
    assert sim.scene_has_water
    metrics = sim.benchmark(case.port_rays(), num_execs=2, steady_chunks=0)
    assert "REDUCE" not in metrics.samples
    assert "INTENSITY" not in metrics.samples
    assert len(metrics.samples["TOTAL"]) == 2


def test_coherent_order_matches_jax():
    case = _mk(64)
    for rays in (case.rays, jax.tree.map(lambda a: np.asarray(a)[::-1],
                                         case.rays)):
        want = jsim.coherent_order(rays)
        got = tsim.coherent_order(convert.rays_from_numpy(_np(rays)))
        for k in ("origin", "direction", "gps_time"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)))
    sim = case.port()
    got = sim.coherent_order(case.port_rays())
    assert torch.equal(got.gps_time,
                       tsim.coherent_order(case.port_rays()).gps_time)


def test_traverse_fn_turns_off_the_cull(spy_cull):
    """A caller's ``traverse_fn`` replaces the cull and the reorder, as the
    JAX `Simulator`'s does: the port's run with the packet walk handed in
    equals ``use_culled=False`` bit for bit and JAX's run with its own walk
    handed in."""
    from lidar_brdf_tpu.geom.packet import intersect_packed_scene, pack_scene
    case = _mk(64, narrow=True)
    ref = case.port(use_culled=False)
    walk = make_packet_traverser(ref.scene, ref.bvh)
    calls = []
    sim = case.port(traverse_fn=lambda o, d: calls.append(1) or walk(o, d))
    assert not sim.use_culled and not sim.reorder
    assert sim.traverser is None and sim.block_pulses is None
    cloud = sim.run(case.port_rays())
    assert len(calls) == 3 and not spy_cull and sim.packet_fn is None
    _assert_equal(cloud, ref.run(case.port_rays()))
    packed = pack_scene(case.scene, case.bvh)
    jfn = lambda o, d: intersect_packed_scene(packed, o, d)
    jax_sim = case.jax(traverse_fn=jfn, compact_readback=False)
    assert not jax_sim._culled_active
    _assert_matches_jax(cloud, jax_sim.run(case.rays))
