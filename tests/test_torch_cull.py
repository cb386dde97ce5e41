"""The beam cull on the device (`kernels/cull.py`: K5 on the card, its
plain version `cull_plain` here) vs the JAX package's culler and the
port's host functions, on the CPU.

Scenes: the city at 368 faces, `rough_terrain` at 20,000 faces and
`tests/test_water.py::water_over_ground_scene`; rays in tiles of 640 (a
narrow cone a tile) and in pulses of 10 (ALS-like, from above); inputs are
numpy, made from a seed.  Tolerances:

- (a) plain version vs the JAX package's numpy culler
  (``LIDAR_BRDF_TPU_NO_NATIVE=1``), beam by beam as sets.  The two test
  in different precisions (f32 here, float64 there), so a candidate may be
  in one set only, and then only at the threshold: its true beam/box gap,
  found in float64 by a ternary search run to convergence, must lie within
  ``slack`` of the threshold ``slack = 1e-4 + 1e-5 t_max``, plus the reach
  of the 24-step search ((1 + tan_half) t_max (2/3)^24).
- (b) plain version vs the port's own `cull_candidates_native` (g++ with
  ``-ffp-contract=off``): counts, faces in order and near distances
  bit-equal, on the scans' beams, a beam over the whole scene and beams
  planted beside leaf boxes at 0, 0.95 and 1.05 times the slack.
- (b') the port's native culler vs the JAX package's own build of
  `native/lidar_native.cpp` (its flags, multiply-adds fused where the
  compiler likes): the same sets (a one-sided candidate only at the
  threshold, as in (a)); each shared near distance within the f32 rounding
  of its terms, 8 ulp of the sum of their magnitudes, so any two faces the
  lists order differently lie within twice that of each other.  The copy's
  code is the reference source's, character for character, below its
  header comment.
- (c) bucketing on the device vs the host functions on the same lists
  (`build_bucketed_candidates` + `TileTraverser.bucket_bounds`,
  `build_pulse_ladders` + `permute_pulse_ladders` +
  `renumber_pulse_ladders`, the lists fed through `_collect_candidates`):
  bit-equal, bounds included.
- (e) no path of `Simulator`, the bench, the traversers or the sharded
  prepare calls `cull_candidates_native`.
"""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from test_water import water_over_ground_scene

from lidar_brdf_tpu.geom import beamcull as jbc
from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.io import native as jnative
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu_torch import bench
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.core.config import LiDARType, SensorConfig
from lidar_brdf_tpu_torch.geom import beamcull as tbc
from lidar_brdf_tpu_torch.geom.packet import pack_bvh
from lidar_brdf_tpu_torch.io import native as tnative
from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
from lidar_brdf_tpu_torch.kernels import cull
from lidar_brdf_tpu_torch.kernels import pulse as tpulse
from lidar_brdf_tpu_torch.kernels import traverse as ttr
from lidar_brdf_tpu_torch.runtime import simulate as tsim

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

T_MAX = 120.0


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _scene(name):
    rng = np.random.default_rng(7)
    if name == "city":
        return jsyn.city_scene(rng, num_buildings=20)
    if name == "terrain":
        return jsyn.rough_terrain(rng, num_tris=20_000, half=30.0)
    return water_over_ground_scene()


def _rays(kind, seed=0):
    """numpy (origins, directions, rays a beam): 8 tiles of 640 rays, each
    a cone of 0.03 rad from one point above the scene, or 256 pulses of 10
    rays of 0.002 rad from a line 40 m up."""
    rng = np.random.default_rng(seed)
    if kind == "tile":
        n, R, spread = 8, 640, 0.03
        o = np.repeat(rng.uniform([-5, 8, -5], [5, 12, 5], (n, 3)), R, 0)
        axis = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1.2, -0.3, n),
                         rng.uniform(-1, 1, n)], -1)
    else:
        n, R, spread = 256, 10, 0.002
        o = np.repeat(np.stack([rng.uniform(-25, 25, n), np.full(n, 40.0),
                                rng.uniform(-25, 25, n)], -1), R, 0)
        o += rng.normal(0, 0.05, o.shape)
        axis = np.stack([rng.normal(0, 0.3, n), -np.ones(n),
                         rng.normal(0, 0.3, n)], -1)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    d = np.repeat(axis, R, 0) + rng.normal(0, spread, (n * R, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), R


@pytest.fixture(scope="module", params=["city", "terrain", "water"])
def scene_case(request):
    scene = _scene(request.param)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    ttree = convert.bvh_from_numpy(_np(tree))
    return request.param, scene, tree, ttree, pack_bvh(ttree, "cpu")


def _plain(nodes, o, d, R, stats=None):
    beams = tbc.tile_beams_torch(torch.from_numpy(o), torch.from_numpy(d), R)
    ins = cull.walk_inputs(beams)
    return ins, cull.cull_plain(nodes, *ins, T_MAX, stats=stats)


def _sets(counts, faces):
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [set(faces[offsets[t]:offsets[t + 1]].tolist())
            for t in range(len(counts))]


def _min_gap64(c, a, tan, r, lo, hi, t_max, iters=200):
    """The least of dist(c + s a, box grown by r) - s tan over [0, t_max],
    in float64, by a ternary search run to convergence."""
    c, a = c.astype(np.float64), a.astype(np.float64)
    g0, g1 = lo - r, hi + r

    def gap(s):
        p = c + s * a
        return np.linalg.norm(np.clip(p, g0, g1) - p) - s * tan

    a_, b_ = 0.0, t_max
    for _ in range(iters):
        m1, m2 = a_ + (b_ - a_) / 3, b_ - (b_ - a_) / 3
        if gap(m1) < gap(m2):
            b_ = m2
        else:
            a_ = m1
    return gap(0.5 * (a_ + b_))


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_plain_matches_jax_numpy_culler_as_sets(scene_case, kind,
                                                monkeypatch):
    name, scene, tree, ttree, nodes = scene_case
    o, d, R = _rays(kind, seed=len(name))
    stats = {}
    ins, (counts, _, faces, _) = _plain(nodes, o, d, R, stats)
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    _, jf, jc = jbc._collect_candidates(tree, jbc.tile_beams(o, d, R), T_MAX)
    got, want = _sets(counts.numpy(), faces.numpy()), _sets(jc, jf)
    assert sum(len(s) for s in want) > 0 and stats["node_tests"] > 0
    slack = 1e-4 + 1e-5 * T_MAX
    leaf = np.asarray(tree.node_face)
    box_of = {int(f): n for n, f in enumerate(leaf) if f >= 0}
    c, a, tan, r, _ = (x.numpy().astype(np.float64) for x in ins)
    odd = 0
    for t, (g, w) in enumerate(zip(got, want)):
        for f in g ^ w:
            n = box_of[f]
            reach = (1 + tan[t]) * T_MAX * (2 / 3) ** cull.ITERS
            gap = _min_gap64(c[t], a[t], tan[t], r[t],
                             np.asarray(tree.node_min[n], np.float64),
                             np.asarray(tree.node_max[n], np.float64), T_MAX)
            assert abs(gap - slack) <= slack + reach, (name, kind, t, f, gap)
            odd += 1
    assert odd <= 0.01 * sum(len(s) for s in want)


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_plain_matches_port_native_culler(scene_case, kind):
    name, scene, tree, ttree, nodes = scene_case
    if tnative.get_lib() is None:
        pytest.skip("no C++ toolchain: the native culler is not built")
    o, d, R = _rays(kind, seed=10 + len(name))
    ins, (counts, offsets, faces, dnear) = _plain(nodes, o, d, R)
    _assert_native_equal(ttree, ins, counts, faces, dnear)


def _assert_native_equal(ttree, ins, counts, faces, dnear):
    """The port's `cull_candidates_native` (built with -ffp-contract=off)
    gives the plain version's lists bit for bit: counts, faces in order,
    near distances."""
    _, nf, nd, nc = tnative.cull_candidates_native(
        ttree, *(x.numpy() for x in ins), T_MAX)
    np.testing.assert_array_equal(counts.numpy(), nc)
    assert nc.sum() > 0
    np.testing.assert_array_equal(faces.numpy(), nf)
    np.testing.assert_array_equal(dnear.numpy().view(np.int32),
                                  nd.view(np.int32))
    off = np.concatenate([[0], np.cumsum(nc)])
    for t in range(len(nc)):
        keys = list(zip(nd[off[t]:off[t + 1]].tolist(),
                        nf[off[t]:off[t + 1]].tolist()))
        assert keys == sorted(keys)


def _code(path):
    """A C++ source without its leading comment block."""
    lines = open(path).read().splitlines()
    while lines and (lines[0].startswith("//") or not lines[0].strip()):
        lines.pop(0)
    return lines


def test_native_copy_is_the_reference_source():
    """The port's `lidar_native.cpp` is the JAX package's below the header
    comment: `lbt_cull`, `beam_box_overlap` and every other function."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = _code(os.path.join(root, "native", "lidar_native.cpp"))
    assert len(ref) > 300 and any("lbt_cull(" in x for x in ref)
    assert _code(tnative._SRC) == ref


@pytest.fixture(scope="module")
def jax_own_build(tmp_path_factory):
    """The JAX package's binding over its own build of its source, with
    its own flags, in a temporary directory (its tracked library is left
    alone)."""
    mp = pytest.MonkeyPatch()
    lib = tmp_path_factory.mktemp("jax_native") / "liblidar_native.so"
    mp.setattr(jnative, "_LIB", str(lib))
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_tried", False)
    built = jnative.get_lib()
    yield built
    mp.undo()


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_port_native_culler_vs_the_jax_package_build(scene_case, kind,
                                                     jax_own_build):
    name, scene, tree, ttree, nodes = scene_case
    if jax_own_build is None or tnative.get_lib() is None:
        pytest.skip("no C++ toolchain: the native cullers are not built")
    o, d, R = _rays(kind, seed=20 + len(name))
    beams = tbc.tile_beams(o, d, R)
    args = (beams.center, beams.axis, tbc.beam_tan_half(beams.cos_half),
            beams.radius, beams.valid)
    _, jf, jd, jc = jnative.cull_candidates_native(tree, *args, T_MAX)
    _, tf, td, tc = tnative.cull_candidates_native(ttree, *args, T_MAX)
    assert jc.sum() > 0
    c, a, tan, r = (np.asarray(x, np.float32).astype(np.float64)
                    for x in args[:4])
    lo = np.asarray(tree.node_min, np.float32).astype(np.float64)
    hi = np.asarray(tree.node_max, np.float32).astype(np.float64)
    box_of = {int(f): n for n, f in enumerate(np.asarray(tree.node_face))
              if f >= 0}
    slack = 1e-4 + 1e-5 * T_MAX
    joff = np.concatenate([[0], np.cumsum(jc)])
    toff = np.concatenate([[0], np.cumsum(tc)])
    eps = np.finfo(np.float32).eps
    odd = 0
    for t in range(len(jc)):
        jl = dict(zip(jf[joff[t]:joff[t + 1]].tolist(),
                      jd[joff[t]:joff[t + 1]].tolist()))
        tl = dict(zip(tf[toff[t]:toff[t + 1]].tolist(),
                      td[toff[t]:toff[t + 1]].tolist()))
        for f in jl.keys() ^ tl.keys():
            n = box_of[f]
            reach = (1 + tan[t]) * T_MAX * (2 / 3) ** cull.ITERS
            gap = _min_gap64(c[t], a[t], tan[t], r[t], lo[n], hi[n], T_MAX)
            assert abs(gap - slack) <= slack + reach, (name, kind, t, f, gap)
            odd += 1
        for f in jl.keys() & tl.keys():
            n = box_of[f]
            mid, ext = 0.5 * (lo[n] + hi[n]), 0.5 * (hi[n] - lo[n])
            mag = (np.abs(mid - c[t]) @ np.abs(a[t])
                   + ext @ np.abs(a[t]) + r[t])
            assert abs(jl[f] - tl[f]) <= 8 * eps * mag, (name, t, f)
    assert odd <= 0.01 * jc.sum()
    same = np.array_equal(jf, tf) and np.array_equal(jd.view(np.int32),
                                                     td.view(np.int32))
    print(f"{name} {kind}: lists {'equal' if same else 'reordered'}, "
          f"{odd} one-sided")


def test_plain_sorts_long_lists_and_planted_slack(scene_case):
    """A wide beam over the whole scene (a list of every face) and beams
    planted beside leaf boxes at 0, 0.95 and 1.05 times the slack: the
    lists bit-equal to the port's host culler's, the first two beams of
    each leaf listing it and the third not."""
    name, scene, tree, ttree, nodes = scene_case
    if tnative.get_lib() is None:
        pytest.skip("no C++ toolchain: the native culler is not built")
    beams, leaves = chip_smoke.planted_slack_beams(ttree, T_MAX)
    counts, offsets, faces, dnear = cull.cull_plain(nodes, *beams, T_MAX)
    _assert_native_equal(ttree, beams, counts, faces, dnear)
    assert counts[0] == scene.num_faces            # the wide beam: all
    lists = _sets(counts.numpy(), faces.numpy())
    face = np.asarray(tree.node_face)
    for i, n in enumerate(leaves):
        inside, edge, outside = lists[1 + 3 * i:4 + 3 * i]
        assert face[n] in inside and face[n] in edge
        assert face[n] not in outside


@pytest.mark.parametrize("kind,pad_to", [("tile", 8), ("tile", 128),
                                         ("pulse", 8)])
def test_device_bucketing_bit_equal_to_host(scene_case, kind, pad_to,
                                            monkeypatch):
    name, scene, tree, ttree, nodes = scene_case
    o, d, R = _rays(kind, seed=20 + len(name))
    beams = tbc.tile_beams_torch(torch.from_numpy(o), torch.from_numpy(d), R)
    lists = cull.beam_cull(nodes, *cull.walk_inputs(beams), T_MAX, pad_to)
    T = lists.counts.shape[0]
    counts = lists.counts.long().numpy()
    host = (np.repeat(np.arange(T), counts), lists.faces.long().numpy(),
            counts)
    monkeypatch.setattr(tbc, "_collect_candidates", lambda *a, **k: host)
    monkeypatch.setattr(tpulse, "_collect_candidates",
                        lambda *a, **k: host)
    if kind == "tile":
        want = tbc.build_bucketed_candidates(ttree, o, d, tile_rays=R,
                                             t_max=T_MAX, pad_to=pad_to)
        got = ttr.buckets_from_lists(lists, T)
        assert len(got) == len(want) >= 1
        for (gt, gc), (wt, wc) in zip(got, want):
            np.testing.assert_array_equal(gt.numpy(), wt)
            np.testing.assert_array_equal(gc.numpy(), wc)
        if pad_to == 8:
            tt = ttr.TileTraverser(convert.scene_from_numpy(_np(scene)),
                                   tile_rays=R, device="cpu")
            want_b = tt.bucket_bounds(ttree, want, o, d)
            got_b = ttr.bucket_bounds_torch(tt.face_boxes(ttree), got, beams)
            for gb, wb in zip(got_b, want_b):
                assert gb.dtype == torch.float32
                np.testing.assert_array_equal(gb.numpy(), wb)
        return
    want = tpulse.build_pulse_ladders(ttree, o, d, R, t_max=T_MAX)
    got = tpulse.ladders_from_lists(lists, T)
    assert len(got) == len(want) >= 1
    for (gp, gc), (wp, wc) in zip(got, want):
        np.testing.assert_array_equal(gp.numpy(), wp)
        np.testing.assert_array_equal(gc.numpy(), wc)
    perm_w, layout_w = tpulse.permute_pulse_ladders(want, T)
    perm_g, layout_g = tpulse.permute_ladders_torch(lists, T)
    np.testing.assert_array_equal(perm_g.numpy(), perm_w)
    assert layout_g == layout_w
    for (gp, gc), (wp, wc) in zip(
            tpulse.renumber_ladders_torch(got, perm_g),
            tpulse.renumber_pulse_ladders(want, perm_w)):
        np.testing.assert_array_equal(gp.numpy(), wp)
        np.testing.assert_array_equal(gc.numpy(), wc)
    assert tpulse.uncovered_groups(layout_g, T) == \
        tpulse.uncovered_groups(layout_w, T)


def test_size_classes_follow_the_host_rule():
    counts = torch.tensor([0, 1, 7, 8, 9, 16, 17, 63, 64, 65, 1000, 4097],
                          dtype=torch.int32)
    for pad_to in (8, 128):
        k = cull.size_classes(counts, pad_to)
        c = counts.numpy()
        padded = np.maximum(pad_to * (2 ** np.ceil(np.log2(np.maximum(
            (c + pad_to - 1) // pad_to, 1))).astype(np.int64)), pad_to)
        got = np.where(c > 0, pad_to << np.minimum(k.numpy(), 38), 0)
        np.testing.assert_array_equal(got, np.where(c > 0, padded, 0))
        assert int(k[0]) == cull.NO_LIST


def test_readbacks_per_culled_chunk():
    """A culled chunk reads two small vectors from the device: the
    narrowness flag and the cull's total and size counts."""
    scene = jsyn.city_scene(np.random.default_rng(0), num_buildings=20)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    tt = ttr.TileTraverser(convert.scene_from_numpy(_np(scene)),
                           tile_rays=640, device="cpu")
    o, d, _ = _rays("tile", seed=3)
    before = cull.READBACKS
    data = tt.prepare(convert.bvh_from_numpy(_np(tree)), o, d, t_max=T_MAX,
                      narrow_only=True)
    assert data and cull.READBACKS - before == 2
    wide = d.copy()
    wide[::2] *= -1                                   # cones over 90 deg
    assert tt.prepare(convert.bvh_from_numpy(_np(tree)), o, wide,
                      t_max=T_MAX, narrow_only=True) is None


@pytest.fixture
def native_cull_raises(monkeypatch):
    """`cull_candidates_native` raises, and every plain cull is counted."""
    def boom(*a, **k):
        raise AssertionError("cull_candidates_native called")
    monkeypatch.setattr(tnative, "cull_candidates_native", boom)
    calls = []
    plain = cull.cull_plain
    monkeypatch.setattr(cull, "cull_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    return calls


def _small_scan(num_faces):
    """(scene, bvh, cfg, rays, mats): an ALS-like scan of 256 pulses over
    rough terrain (the pulse path above 100k faces is forced by
    ``use_pulse``)."""
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.io import synthetic
    scene = synthetic.rough_terrain(np.random.default_rng(1),
                                    num_tris=num_faces, half=30.0)
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 40.0, 0.0),
        als_fov_horizontal=40.0, als_fov_vertical=4.5, max_range=200.0,
        rays_per_pulse=4, max_returns=1, chunk_pulses=128)
    rays = api.build_rays(cfg, scene, device="cpu")
    n = 256
    rays = type(rays)(origin=rays.origin[:n], direction=rays.direction[:n],
                      gps_time=rays.gps_time[:n])
    return scene, bvh, cfg, rays, MaterialLibrary.default().table_at(1064)


@pytest.mark.parametrize("path", ["tile", "pulse"])
def test_no_path_calls_the_host_culler(native_cull_raises, path):
    scene, bvh, cfg, rays, mats = _small_scan(4000)
    sim = tsim.Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                         device="cpu", use_pulse=path == "pulse")
    cloud = sim.run(rays)
    assert int(cloud.mask.sum()) > 0 and len(native_cull_raises) == 2
    ws = bench.cull(scene, bvh, cfg, rays, mats, path, "cpu")
    assert ws.data and len(native_cull_raises) == 3
    ct = tbc.CulledTraverser(scene, tile_rays=128, chunk=8, device="cpu")
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    hits = ct(o, d, ct.prepare(bvh, o, d))
    assert int((hits.face >= 0).sum()) > 0 and len(native_cull_raises) == 4


def test_sharded_prepare_culls_on_the_device(native_cull_raises):
    from lidar_brdf_tpu_torch.parallel import shard as tshard
    scene, bvh, cfg, rays, mats = _small_scan(4000)
    mesh = tshard.RayMesh(None, 1, 2, torch.device("cpu"))
    mine = tshard.shard_rays(rays, mesh)
    for tr in (ttr.TileTraverser(scene, tile_rays=128, device="cpu"),
               tpulse.PulseLadderTraverser(scene, rays_per_pulse=4,
                                           device="cpu")):
        data = tshard.build_sharded_traverse_data(tr, bvh, mine, mesh)
        assert len(data) >= 1
    assert len(native_cull_raises) == 2
    assert math.isfinite(tr.t_max)


# ---------------------------------------------------------------------------
# K5's schedule, scratch and stacks (the wrapper's torch steps, on the CPU)
# ---------------------------------------------------------------------------

def test_schedule_takes_a_warp_for_few_beams_a_thread_for_many():
    """`cull.schedule`: a block a beam up to `GROUP_BEAMS` beams, one
    thread a beam above; the capacity a power of two in [CAP_MIN, CAP_MAX] that
    keeps the scratch near `SCRATCH_ENTRIES`."""
    assert cull.schedule(2048) == (128, 1024)         # a `tls` chunk
    assert cull.schedule(131072) == (1, 32)           # an `als` chunk
    assert cull.schedule(cull.GROUP_BEAMS)[0] == cull.GROUP_LANES
    assert cull.schedule(cull.GROUP_BEAMS + 1)[0] == 1
    for T in (0, 1, 19, 1000, 4097, 8192, 8193, 50_000, 1 << 20):
        lanes, cap = cull.schedule(T)
        assert cap & (cap - 1) == 0
        assert cull.CAP_MIN <= cap <= cull.CAP_MAX
        assert T * cap <= max(cull.SCRATCH_ENTRIES, T * cull.CAP_MIN)
        assert cap == cull.CAP_MAX or 2 * cap * T > cull.SCRATCH_ENTRIES


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_lists_through_a_small_scratch_match_plain(scene_case, kind):
    """`beam_cull` on the CPU through a scratch of a forced small capacity
    (some beams over it, walked again) gives `cull_plain`'s CSR bit for
    bit, the same sizes and order, and counts the beams over capacity in
    its one read."""
    name, scene, tree, ttree, nodes = scene_case
    o, d, R = _rays(kind, seed=30 + len(name))
    beams = tbc.tile_beams_torch(torch.from_numpy(o), torch.from_numpy(d), R)
    ins = cull.walk_inputs(beams)
    want = cull.cull_plain(nodes, *ins, T_MAX)
    longest = int(want[0].max())
    assert longest > 2
    for cap in (1, 2, longest - 1, longest):
        before = cull.READBACKS
        got = cull.beam_cull(nodes, *ins, T_MAX, capacity=cap)
        assert cull.READBACKS - before == 1
        for g, w in zip(got[:4], want):
            assert chip_smoke.same_tensors(g, w)
        assert got.overflow == int((want[0] > cap).sum())
        assert (got.overflow > 0) == (cap < longest)
        ref = cull.lists_of(*want)
        assert got.sizes == ref.sizes and torch.equal(got.order, ref.order)


def test_scratch_copies_short_lists_and_rewalks_long_ones():
    """`_through_scratch` on hand-made entries: a beam within capacity is
    taken from its scratch row (its first entries in walk order), a beam
    over it only from the second walk."""
    beam = torch.tensor([2, 0, 2, 2, 0])
    fcs = torch.tensor([7, 3, 5, 9, 1], dtype=torch.int32)
    dn = torch.tensor([0.5, 0.1, 0.2, 0.3, 0.4])
    counts = torch.tensor([2, 0, 3], dtype=torch.int32)
    asked = []

    def rewalk(mask):
        asked.append(mask.tolist())
        return (torch.tensor([2, 2, 2]),
                torch.tensor([70, 50, 90], dtype=torch.int32),
                torch.tensor([5.0, 2.0, 3.0]))

    b, f, d = cull._through_scratch(beam, fcs, dn, counts, 2, rewalk)
    assert asked == [[False, False, True]]
    assert b.tolist() == [0, 0, 2, 2, 2]
    assert f.tolist() == [3, 1, 70, 50, 90]
    assert d.tolist() == pytest.approx([0.1, 0.4, 5.0, 2.0, 3.0])


def _depth_by_parents(skip, face):
    """Each node's depth from its parent's, in pre-order (a parent comes
    before its children), children as `cull_plain` expands them."""
    N = face.shape[0]
    depth = np.full(N, -1)
    if N:
        depth[0] = 0
    for n in range(N):
        if face[n] < 0:
            for c in (n + 1, skip[n + 1]):
                if c < N:
                    depth[c] = depth[n] + 1
    return int(depth.max()) if N else -1


def _group_walk(passes, skip, face, G):
    """K5's group walk of one beam on the host (``passes[node]``: the
    beam's test of the node): each round pops up to G nodes from the top,
    appends the leaves that pass and pushes both children of each internal
    node that passes, lanes in order.  Returns (faces listed, the most
    nodes the stack held)."""
    N = face.shape[0]
    stack, listed, most = [0], [], 1
    while stack:
        take = stack[-G:][::-1]           # lane i pops stack[sp - 1 - i]
        del stack[-G:]
        pushed = []
        for node in take:
            if not passes[node]:
                continue
            if face[node] >= 0:
                listed.append(int(face[node]))
            else:
                pushed.append(node + 1)
                if skip[node + 1] < N:
                    pushed.append(int(skip[node + 1]))
        stack += pushed
        most = max(most, len(stack))
    return listed, most


def test_tree_depth_and_group_stacks_bound(scene_case):
    """`tree_depth` on the city, terrain and water trees equals the depth
    found from the parents; K5's group walk of every lane count, on the
    wide beam over the whole scene (every node passes) and on the scans'
    tile beams, lists the plain version's faces and never holds more than
    `stack_entries(lanes, depth)` nodes; the trees' stacks fit shared
    memory, a chain of depth 120's do not."""
    name, scene, tree, ttree, nodes = scene_case
    box, skip, face = nodes
    depth = cull.tree_depth(skip, face)
    sk, fc = skip.numpy(), face.numpy()
    assert depth == _depth_by_parents(sk, fc) > 0
    assert all(cull.stacks_in_shared(g, depth) for g in (1, 4, 32, 128))
    chain, _ = chip_smoke.chain_tree(chip_smoke.CHAIN_DEPTH, "cpu")
    assert cull.tree_depth(chain[1], chain[2]) == chip_smoke.CHAIN_DEPTH
    assert not cull.stacks_in_shared(32, chip_smoke.CHAIN_DEPTH)
    wide, _ = chip_smoke.planted_slack_beams(ttree, T_MAX)
    o, d, R = _rays("tile", seed=40)
    tiles = cull.walk_inputs(tbc.tile_beams_torch(
        torch.from_numpy(o), torch.from_numpy(d), R))
    k = cull._F32("cpu")
    tm = torch.tensor(T_MAX, dtype=torch.float32)
    N = fc.shape[0]
    for ins, beams in ((wide, [0]), (tiles, [0, 3, 5])):
        counts, offsets, faces, _ = cull.cull_plain(nodes, *ins, T_MAX)
        for t in beams:
            c, a, tan, r = (x[t:t + 1] for x in ins[:4])
            passes, _ = cull._overlap_plain(
                c.t().expand(3, N), a.t().expand(3, N), tan.expand(N),
                r.expand(N), box, tm, k)
            want = sorted(faces[offsets[t]:offsets[t + 1]].tolist())
            for G in (1, 2, 4, 8, 16, 32, 128):
                listed, most = _group_walk(passes.numpy(), sk, fc, G)
                assert sorted(listed) == want
                assert most <= cull.stack_entries(G, depth)


VARIANTS = ["base", "thread", "lanes=2", "lanes=32", "lanes=64",
            "lanes=256", "unpostponed", "postponed=16"]


@pytest.mark.parametrize("name", VARIANTS)
def test_k5_variant_script_edits_apply(name, monkeypatch):
    """`scripts/k5_variants.py` makes each variant by a text change of K5's
    source: every change still finds its text there, as often as the
    variant expects."""
    import importlib
    import pathlib
    monkeypatch.syspath_prepend(
        str(pathlib.Path(__file__).parent.parent / "scripts"))
    mod = importlib.import_module("k5_variants")
    base = open(cull.KERNEL.source).read()
    out = mod.source(name, base)
    assert (out == base) == (name in ("base", "thread"))
    if name.startswith("lanes="):
        assert f"launch<{name[6:]}>" in out
    if name == "unpostponed":
        assert "__ballot_sync(FULL, wait)" not in out
    if name.startswith("postponed="):
        assert f"POSTPONE = {name[10:]};" in out
