"""The CUDA kernels (K1 tiles, K2 pulse ladders, K3 the bench's pre-flight,
K4 the packet walk, K5 the beam cull, K6 the table gradient's scatter-add)
on the card vs their plain PyTorch versions, the
water and packet-walk scans, the compacted readback, the CLI on an OBJ
directory and the fwd+bwd step's gradients on the card vs the CPU (the
card's clouds are compacted, so clouds are compared after
`compact_host`).

Every test here needs an NVIDIA Hopper card and nvcc; without one each
skips.  The file imports nothing of JAX, so on a card host without JAX it
runs on its own, without `tests/conftest.py` (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Faces must be equal and t equal to rtol 1e-6 where a face is hit; K3, K4
and K5 (lists, near distances, and the buckets, bounds and ladders built
from them) equal bit for bit; K6 within count_c * 2^-23 * sum_c |g| of its
plain version at each cell c (float atomics sum in no fixed order).
Gradients: loss to rtol 1e-5, each gradient within
atol 1e-4 * max|g| (the card's scatter-add order is not fixed).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu_torch import api, bench
from lidar_brdf_tpu_torch.core.config import LiDARType, SensorConfig
from lidar_brdf_tpu_torch.geom.intersect import BIG
from lidar_brdf_tpu_torch.io import synthetic
from lidar_brdf_tpu_torch.kernels import packet as kpk
from lidar_brdf_tpu_torch.kernels import pulse as pp
from lidar_brdf_tpu_torch.kernels import smoke
from lidar_brdf_tpu_torch.kernels import traverse as tr
from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser
from lidar_brdf_tpu_torch.runtime.simulate import Simulator

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")


def _fan(n_az, n_el):
    o0 = np.array([0.0, 9.0, 0.0], np.float32)
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    el = np.linspace(-1.3, -0.1, n_el)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


def _k1_vs_plain(wald, og, dg, data, t_max, tile_rays):
    """One K1 call (one launch) and the plain version on the same input:
    faces equal, t to rtol 1e-6, misses (BIG, -1)."""
    before = tr.KERNEL.launches
    t_k, f_k = tr.tile_traverse(wald, og, dg, data, t_max, tile_rays)
    torch.cuda.synchronize()
    assert tr.KERNEL.launches == before + 1
    t_p, f_p = tr.tile_traverse_plain(wald, og, dg, data, t_max, tile_rays)
    assert torch.equal(f_k, f_p)
    hit = f_p >= 0
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
    assert bool((t_k[~hit] == BIG).all())
    return f_k


# 1-40 units of 128 rays per tile row
@pytest.mark.parametrize("tile_rays", [128, 640, 1280, 2560, 5120])
def test_kernel_matches_plain(card, tile_rays):
    scene = synthetic.terrain_with_boxes(np.random.default_rng(tile_rays),
                                         num_boxes=12)
    o, d = _fan(128, 80)                                 # 10,240 rays
    tt = TileTraverser(scene, tile_rays=tile_rays, device="cuda")
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=500.0)
    og, dg = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    f = _k1_vs_plain(tt.wald, og, dg, data, tt.t_max, tile_rays)
    assert int((f >= 0).sum()) > 5000


def test_kernel_long_lists(card):
    """Candidate lists longer than 1024 (4096 here: random rays make wide
    tile beams): many 128-candidate stages, double-buffered."""
    rng = np.random.default_rng(7)
    scene = synthetic.random_triangles(rng, num_tris=3000, spread=30.0)
    o = rng.uniform(-20, 20, (32 * 256, 3)).astype(np.float32)
    d = rng.normal(0, 1, (32 * 256, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tt = TileTraverser(scene, tile_rays=256, device="cuda")
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=80.0)
    assert max(c.shape[1] for _, c, _ in data) > 1024
    f = _k1_vs_plain(tt.wald, torch.from_numpy(o).cuda(),
                     torch.from_numpy(d).cuda(), data, tt.t_max, 256)
    assert int((f >= 0).sum()) > 1000


@pytest.mark.parametrize("n_cand", [128, 512])
def test_kernel_planted_tie_across_blocks(card, n_cand):
    """Coincident faces 40 (block 1) and 12 (block 6): the earlier block
    wins, as in the serial walk, though its id is larger; in a list of one
    128-candidate stage and of four."""
    wald, o, d, ids = (torch.from_numpy(a).cuda()
                       for a in chip_smoke.planted_tie(n_cand))
    bucket = (torch.zeros(1, dtype=torch.int32, device="cuda"), ids[None],
              torch.zeros((1, n_cand // 8), device="cuda"))
    f = _k1_vs_plain(wald, o, d, [bucket], 100.0, 128)
    assert int((f == 40).sum()) > 10 and not bool((f == 12).any())


def test_kernel_dummy_bucket_and_uncovered_tiles(card):
    """One call over a real bucket, an all-dummy bucket and an empty one:
    the dummy rows write nothing and tiles 1 and 2, in no bucket, stay
    (BIG, -1)."""
    wald, o, d, ids = (torch.from_numpy(a).cuda()
                       for a in chip_smoke.planted_tie(512))
    o3, d3 = o.repeat(3, 1), d.repeat(3, 1)                 # 3 tiles
    i32 = dict(dtype=torch.int32, device="cuda")
    data = [(torch.tensor([0, 3], **i32),
             torch.stack([ids, torch.full_like(ids, -1)]),
             torch.zeros((2, 64), device="cuda")),
            (torch.full((4,), 3, **i32), torch.zeros((4, 8), **i32),
             torch.zeros((4, 1), device="cuda")),
            (torch.zeros(0, **i32), torch.zeros((0, 16), **i32),
             torch.zeros((0, 2), device="cuda"))]
    f = _k1_vs_plain(wald, o3, d3, data, 100.0, 128)
    assert int((f[:128] >= 0).sum()) > 10
    assert bool((f[128:] == -1).all())


def test_kernel_checks_inputs_and_drops_dummy_rows(card):
    wald = torch.zeros((4, 12), device="cuda")
    o = torch.zeros((256, 3), device="cuda")
    dummy = (torch.full((2,), 2, dtype=torch.int32, device="cuda"),  # == T
             torch.zeros((2, 8), dtype=torch.int32, device="cuda"),
             torch.zeros((2, 1), device="cuda"))
    t, f = tr.tile_traverse(wald, o, o, [dummy], 10.0, 128)
    torch.cuda.synchronize()
    assert bool((f == -1).all()) and bool((t == BIG).all())
    with pytest.raises(ValueError):
        tr.tile_traverse(wald.double(), o, o, [dummy], 10.0, 128)
    with pytest.raises(ValueError):
        tr.tile_traverse(wald, o, o.cpu(), [dummy], 10.0, 128)


def test_simulator_card_matches_cpu(card):
    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=4)
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(1064)
    cfg = SensorConfig(tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
                       tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
                       tls_resolution_horizontal=32,
                       tls_resolution_vertical=16, rays_per_pulse=6,
                       pulse_radius=0.1, max_returns=2, chunk_pulses=512)
    rays = api.build_rays(cfg, scene, device="cpu")
    before = tr.KERNEL.launches
    g = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cuda").run(rays.to("cuda"))
    assert tr.KERNEL.launches > before
    c = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cpu").run(rays)
    # the card reads back compacted: compared after `compact_host`
    chip_smoke.compare_clouds("tls L=2", g, c)
    assert int((c.return_number[c.mask] == 1).sum()) > 5


def _k2_vs_plain(scene, o, d, R, group=1):
    """K2 and its plain version on one input: faces equal, t to rtol 1e-6."""
    tt = pp.PulseLadderTraverser(scene, rays_per_pulse=R, group=group,
                                 device="cuda")
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=500.0)
    og, dg = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    before = pp.KERNEL.launches
    t_k, f_k = pp.pulse_traverse(tt.wald, og, dg, data, tt.t_max,
                                 tt.kernel_rays)
    torch.cuda.synchronize()
    assert pp.KERNEL.launches == before + 1
    t_p, f_p = pp.pulse_traverse_plain(tt.wald, og, dg, data, tt.t_max,
                                       tt.kernel_rays)
    assert torch.equal(f_k, f_p)
    hit = f_p >= 0
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
    assert bool((t_k[~hit] == BIG).all())
    return f_k, data


@pytest.mark.parametrize("group", [1, 4])
def test_pulse_kernel_matches_plain(card, group):
    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=12)
    o, d = _fan(128, 80)                                 # 10,240 rays
    f, _ = _k2_vs_plain(scene, o, d, 4, group)
    assert int((f >= 0).sum()) > 5000


def test_pulse_kernel_fat_ladders_and_pads(card):
    scene = synthetic.rough_terrain(np.random.default_rng(1234),
                                    num_tris=20_000, half=30.0)
    # the grazing fan of tests/test_pallas.py:215-222, its last 4 pulses
    # padded as the Simulator pads a chunk
    az = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    el = np.linspace(-0.25, -0.02, 16)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.array([0.0, 3.0, 0.0], np.float32), (d.shape[0], 1))
    o[-8:], d[-8:] = 1e10, 0.0
    f, data = _k2_vs_plain(scene, o, d, 2, group=4)
    assert max(c.shape[1] for _, c in data) >= 64
    assert bool((f[-8:] == -1).all())


def test_pulse_kernel_checks_inputs_and_drops_dummy_rows(card):
    wald = torch.zeros((4, 12), device="cuda")
    o = torch.zeros((40, 3), device="cuda")
    dummy = (torch.tensor([10, -1], dtype=torch.int32, device="cuda"),
             torch.zeros((2, 8), dtype=torch.int32, device="cuda"))
    t, f = pp.pulse_traverse(wald, o, o, [dummy], 10.0, 4)
    torch.cuda.synchronize()
    assert bool((f == -1).all()) and bool((t == BIG).all())
    with pytest.raises(ValueError):
        pp.pulse_traverse(wald.double(), o, o, [dummy], 10.0, 4)
    with pytest.raises(ValueError):
        pp.pulse_traverse(wald, o, o.cpu(), [dummy], 10.0, 4)


def _k2_call_vs_plain(wald, o, d, data, t_max, R):
    """One K2 call (one launch) and the plain version: faces equal, t to
    rtol 1e-6 on hits, misses (BIG, -1)."""
    before = pp.KERNEL.launches
    t_k, f_k = pp.pulse_traverse(wald, o, d, data, t_max, R)
    torch.cuda.synchronize()
    assert pp.KERNEL.launches == before + 1
    t_p, f_p = pp.pulse_traverse_plain(wald, o, d, data, t_max, R)
    assert torch.equal(f_k, f_p)
    hit = f_p >= 0
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=1e-6, atol=0)
    assert bool((t_k[~hit] == BIG).all())
    return f_k


def test_pulse_kernel_planted_tie_across_blocks(card):
    """Coincident faces 40 (block 1) and 12 (block 6): the earlier block
    wins though its id is larger, in ladders of one and eight 16-candidate
    stages, in groups of 8 rays and one group of 128."""
    for name, wald, o, d, data, R in chip_smoke.k2_tie_cases():
        f = _k2_call_vs_plain(wald, o, d, data, 100.0, R)
        assert int((f == 40).sum()) > 10 and not bool((f == 12).any()), name


@pytest.mark.parametrize("R", [8, 384])
@pytest.mark.parametrize("named", [False, True])
def test_pulse_kernel_mixed_ladders_one_launch(card, R, named):
    """Ladders of 1-128 real candidates padded to K = 8 ... 128 (five
    buckets, shuffled, with dummy rows) in one launch; groups of 8 rays
    and of 384 (three 128-ray slices a row).  The last groups are in no
    bucket: filled by the wrapper, or by K2 when the range is named."""
    rng = np.random.default_rng(R)
    wald, o, d, _ = (torch.from_numpy(a).cuda()
                     for a in chip_smoke.planted_tie(64))
    G = 64 if R == 8 else 8
    o, d = o.repeat(G * R // 128, 1), d.repeat(G * R // 128, 1)
    lo = G - G // 8                             # groups [lo, G): no bucket
    by_k = {}
    for j, g in enumerate(rng.permutation(lo)):
        n = (5, 12, 30, 60, 120)[j] if j < 5 else int(rng.integers(1, 129))
        K = 8 * 2 ** int(np.ceil(np.log2(-(-n // 8))))
        by_k.setdefault(K, []).append((g, rng.integers(0, 64, n)))
    data = []
    for K in rng.permutation(sorted(by_k)):
        rows = by_k[int(K)]
        cand = np.full((len(rows) + 3, K), -1, np.int32)
        pidx = np.full(len(rows) + 3, G, np.int32)      # 3 dummy rows
        for j, (g, ids) in enumerate(rows):
            pidx[j], cand[j, :len(ids)] = g, ids
        data.append((torch.from_numpy(pidx).cuda(),
                     torch.from_numpy(cand).cuda()))
    assert sorted(c.shape[1] for _, c in data) == [8, 16, 32, 64, 128]
    if named:
        data = pp.PulseLadders(data, (lo, G))
    f = _k2_call_vs_plain(wald, o, d, data, 100.0, R)
    assert bool((f[lo * R:] == -1).all()) and int((f >= 0).sum()) > 100


def test_simulator_pulse_path_card_matches_cpu(card):
    scene = synthetic.rough_terrain(np.random.default_rng(0),
                                    num_tris=20_000, half=30.0)
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(1064)
    cfg = SensorConfig(lidar_type=LiDARType.AERIAL_ZIGZAG,
                       als_position=(0.0, 40.0, 0.0),
                       als_scan_frequency=40, als_pulse_frequency=2560,
                       als_speed=30.0, max_range=400.0, rays_per_pulse=4,
                       pulse_radius=0.3, max_returns=2, chunk_pulses=1024)
    rays = api.build_rays(cfg, scene, device="cpu")
    rays = type(rays)(rays.origin[:2048], rays.direction[:2048],
                      rays.gps_time[:2048])
    before = pp.KERNEL.launches
    g = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cuda", use_pulse=True).run(rays.to("cuda"))
    assert pp.KERNEL.launches > before
    c = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cpu", use_pulse=True).run(rays)
    chip_smoke.compare_clouds("als L=2", g, c)
    assert int(c.mask.sum()) > 1500


def test_pulse_kernel_padding_contract(card):
    """Whole blocks of padding inside hand-built ladders are skipped, not
    taken for the ladder's end, as is the padding at the tail of the
    traverser's ladders.  Both equal the plain version."""
    for name, wald, o, d, data, R in chip_smoke.k2_padding_cases():
        f = _k2_call_vs_plain(wald, o, d, data, 100.0, R)
        assert int((f == 40).sum()) > 10 and not bool((f == 12).any()), name


@pytest.mark.parametrize("width", kpk.WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["fan", "grazing", "padding"])
def test_packet_kernel_matches_plain(card, case, masked, width):
    """K4 vs its plain version (`chip_smoke.compare_k4`: faces and t bit
    for bit, walks as long) at each packet width, on every ray and with a
    mask; one launch a call, no host sync with the mask."""
    from lidar_brdf_tpu_torch.geom.packet import pack_scene
    if case == "grazing":
        scene, o, d = chip_smoke.grazing_fan()
    else:
        scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                             num_boxes=6)
        o, d = chip_smoke.fan_rays(64)
        if case == "padding":
            o[1000:1100], d[1000:1100] = 1e10, 0.0
            d[3000:3050] = 0.0
            o, d = o[:4000], d[:4000]
    packed = pack_scene(scene.to("cuda"), api.build_scene_bvh(scene))
    og, dg = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    active = torch.from_numpy(
        np.random.default_rng(0).random(o.shape[0]) < 0.6).cuda() \
        if masked else None
    steps, _, err = chip_smoke.compare_k4(f"K4 {case}", packed, og, dg,
                                          active, width)
    assert bool((steps[:, 0] > 0).all()) and err == 0.0
    before = kpk.KERNEL.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        kpk.packet_traverse(*packed, og, dg, active=active, width=width)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kpk.KERNEL.launches == before + 1
    with pytest.raises(ValueError):
        kpk.packet_traverse(*packed, og[:64], dg[:63])
    with pytest.raises(ValueError):
        kpk.packet_traverse(*packed, og, dg.cpu())


@pytest.mark.parametrize("entry", ["intersect_bvh", "packed_1",
                                   "packed_128"])
@pytest.mark.parametrize("case", ["fan", "grazing"])
def test_walk_entry_points_launch_k4_once(card, case, entry):
    """`intersect_bvh` and `intersect_packed` (tile 1, 128): one K4 launch
    a call, (t, face) bit-equal to the same call with the plain version,
    faces equal to the brute force but at ties and barycentric thresholds
    (`chip_smoke.entry_call`)."""
    from lidar_brdf_tpu_torch.geom import packet as gp
    from lidar_brdf_tpu_torch.geom.intersect import intersect_bvh
    if case == "grazing":
        scene, o, d = chip_smoke.grazing_fan()
    else:
        scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                             num_boxes=6)
        o, d = chip_smoke.fan_rays(64)
    bvh = api.build_scene_bvh(scene)
    scene = scene.to("cuda")
    og, dg = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    if entry == "intersect_bvh":
        call = lambda: intersect_bvh(scene, bvh, og, dg)
    else:
        nodes, rows = gp.pack_bvh(bvh, "cuda"), gp.pack_triangles(scene)
        tile = int(entry.split("_")[1])
        call = lambda: gp.intersect_packed(nodes, rows, og, dg, tile=tile)
    r = chip_smoke.entry_call(f"{entry}, {case}", kpk.KERNEL, call,
                              (scene, og, dg))
    assert r["launches"] == 1 and r["hits"] > 100


@pytest.mark.parametrize("kind", ["intersect_culled", "dense", "buckets"])
@pytest.mark.parametrize("chunk", [8, 128])
def test_culled_entry_points_launch_k1_once(card, kind, chunk):
    """`intersect_culled` and `CulledTraverser` (dense, bucketed): one K1
    launch a call, (t, face) bit-equal to the same call with
    `tile_traverse_plain` (`chip_smoke.entry_call`)."""
    from lidar_brdf_tpu_torch.geom import beamcull as bc
    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    o, d = chip_smoke.fan_rays(64)
    bvh = api.build_scene_bvh(scene)
    ct = bc.CulledTraverser(scene, tile_rays=256, chunk=chunk, device="cuda")
    og, dg = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    dense = ct.build_candidates(bvh, o, d)
    if kind == "intersect_culled":
        T = dense.shape[0]
        cand = torch.from_numpy(dense).cuda()
        call = lambda: bc.intersect_culled(ct.wald, cand,
                                           og.view(T, 256, 3),
                                           dg.view(T, 256, 3), chunk=chunk)
    else:
        data = dense if kind == "dense" else ct.prepare(bvh, o, d)
        call = lambda: ct(og, dg, data)
    r = chip_smoke.entry_call(f"{kind}, chunk {chunk}", tr.KERNEL, call)
    assert r["launches"] == 1 and r["hits"] > 3000


def test_water_simulator_card_matches_cpu(card):
    """`tests/test_water.py`'s bathymetric scan on the card and on the CPU
    (`chip_smoke.py` phase 5's water case): K1 level 0, K4 bounces."""
    scene, cfg = chip_smoke.water_over_ground()
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(532)
    rays = api.build_rays(cfg, scene, device="cpu")
    before = kpk.KERNEL.launches
    g = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cuda").run(rays.to("cuda"))
    assert kpk.KERNEL.launches > before
    c = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cpu").run(rays)
    chip_smoke.compare_clouds("water L=3", g, c, bathymetric=True)
    m = c.mask
    assert int(((c.asprs == 2) & (c.return_number >= 1) & m).sum()) > 100


def test_packet_walk_simulator_card_matches_cpu(card):
    """``use_culled=False``: every level on the packet walk, no host cull,
    on the card and on the CPU."""
    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=4)
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(1064)
    cfg = SensorConfig(tls_position=(0.0, 9.0, 0.0),
                       tls_fov_horizontal=360.0, tls_fov_vertical=60.0,
                       tls_middle_angle_vertical=-45.0,
                       tls_resolution_horizontal=32,
                       tls_resolution_vertical=16, rays_per_pulse=6,
                       pulse_radius=0.1, max_returns=2, chunk_pulses=512)
    rays = api.build_rays(cfg, scene, device="cpu")
    before = (kpk.KERNEL.launches, tr.KERNEL.launches)
    g = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cuda", use_culled=False).run(rays.to("cuda"))
    assert kpk.KERNEL.launches == before[0] + 1
    assert tr.KERNEL.launches == before[1]
    c = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                  device="cpu", use_culled=False).run(rays)
    chip_smoke.compare_clouds("tls packet walk", g, c)


def test_compact_readback_card_matches_dense(card):
    """On the card the Simulator compacts by default; the compacted cloud
    is the dense readback's `compact_host()`, field for field, in fewer
    bytes."""
    scene = synthetic.city_scene(np.random.default_rng(0), num_buildings=64)
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(1064)
    cfg = SensorConfig(tls_position=(0.0, 10.0, 0.0),
                       tls_fov_horizontal=360.0, tls_fov_vertical=100.0,
                       tls_middle_angle_vertical=-35.0,
                       tls_resolution_horizontal=512,
                       tls_resolution_vertical=32, rays_per_pulse=4,
                       max_returns=2, chunk_pulses=4096)
    rays = api.build_rays(cfg, scene, device="cuda")
    out = {}
    for compact in (None, False, True):
        stats = {}
        sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        device="cuda", compact_readback=compact)
        out[compact] = (sim.run(rays, stats=stats), stats)
        assert sim.compact_readback is (compact is not False)
    ref = out[False][0].compact_host()
    for key in (None, True):
        cloud = out[key][0]
        assert cloud.capacity == ref.capacity > 1000
        for f in ("position", "normal", "uv", "intensity", "distance",
                  "return_number", "num_returns", "scan_angle_rank",
                  "scan_direction", "gps_time", "comp_id", "semantic",
                  "asprs", "mask"):
            assert torch.equal(getattr(cloud, f), getattr(ref, f)), f
    assert 0 < out[True][1]["readback_bytes"] < out[False][1][
        "readback_bytes"]


def test_cli_card_matches_cpu(card, tmp_path):
    """`python -m lidar_brdf_tpu_torch.cli simulate` on an OBJ directory
    with measured tables, on the card and with ``--device cpu``: the same
    points (positions atol 1e-4, intensity rtol 1e-4), K1 launched."""
    from lidar_brdf_tpu_torch import cli
    from lidar_brdf_tpu_torch.io.ply import read_ply
    city = synthetic.city_scene(np.random.default_rng(0), num_buildings=64)
    sdir = chip_smoke.city_scene_dir(city, str(tmp_path / "city"))
    bdir = chip_smoke.brdf_dir(str(tmp_path / "brdf"))
    cfg = SensorConfig(tls_position=(0.0, 10.0, 0.0),
                       tls_fov_horizontal=360.0, tls_fov_vertical=100.0,
                       tls_middle_angle_vertical=-35.0,
                       tls_resolution_horizontal=256,
                       tls_resolution_vertical=32, rays_per_pulse=4,
                       max_returns=2, chunk_pulses=4096)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    back = {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.ply")
        before = tr.KERNEL.launches
        assert cli.main(["simulate", "--scene", sdir, "--config",
                         str(cfg_path), "--brdf-dir", bdir, "--out", out,
                         "--device", dev]) == 0
        assert (tr.KERNEL.launches > before) == (dev == "cuda")
        back[dev] = read_ply(out)
    g, c = back["cuda"], back["cpu"]
    assert len(g["x"]) == len(c["x"]) > 1000
    for k in ("returnNumber", "numReturns", "asprsSemanticGroup"):
        np.testing.assert_array_equal(g[k], c[k], err_msg=k)
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(g[k], c[k], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g["intensity"], c["intensity"], rtol=1e-4,
                               atol=0)


# sizes that are no multiple of 4 go through the float4 body's scalar tail
@pytest.mark.parametrize("shape", [(8, 128), (1 << 20,), (3, 1000),
                                   ((1 << 20) + 3,), (1001,), (3,)])
def test_affine_smoke_matches_plain(card, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    x = (x * 1e3).cuda()
    before = smoke.KERNEL.launches
    y = smoke.affine_smoke(x)
    torch.cuda.synchronize()
    assert smoke.KERNEL.launches == before + 1
    assert torch.equal(y, smoke.affine_smoke_plain(x))
    with pytest.raises(ValueError):
        smoke.affine_smoke(x.double())
    bench.kernel_smoke("cuda")


def test_affine_smoke_misaligned_view(card):
    """A view 4 bytes into its storage takes the one-element-per-thread
    kernel."""
    x = torch.randn(4099, generator=torch.Generator().manual_seed(1)).cuda()
    view = x[1:]
    assert view.data_ptr() % 16
    assert torch.equal(smoke.affine_smoke(view),
                       smoke.affine_smoke_plain(view))


@pytest.mark.parametrize("kind", ["tile", "pulse"])
def test_step_grads_card_match_cpu(card, kind):
    """`chip_smoke.py` phase 7's comparison, which fails (SystemExit) on a
    loss or gradient out of its tolerance."""
    for what, scene, cfg, rays in chip_smoke.grad_cases(kind):
        errs = chip_smoke.compare_grads(what, scene, cfg, rays, kind)
        assert set(errs) == {"brdf_table", "origin", "vertices"}


@pytest.mark.parametrize("case", range(10))
def test_beam_cull_matches_plain(card, case):
    """K5 on the fan over boxes (tiles of 128 rays, pulses of 4), on beams
    planted at the slack of leaf boxes (a wide beam's list of 20,000 faces,
    over the scratch's capacity, walked again and sorted in device memory)
    and on a chain too deep for shared stacks, each on its scheduled path;
    then a thread a beam where a warp was scheduled, and the overflow path
    forced on both: `LAUNCHES` launches a call, everything bit-equal to
    `cull_plain` (`chip_smoke.compare_k5`)."""
    from lidar_brdf_tpu_torch.kernels import cull
    cases = chip_smoke.k5_small_cases()
    assert len(cases) == 10
    name, nodes, ins, t_max, kind, beams, face_box, _, opts = cases[case]
    rec = chip_smoke.compare_k5(name, nodes, ins, t_max, kind=kind,
                                beams=beams, face_box=face_box, **opts)
    assert rec["launches"] == cull.LAUNCHES and rec["candidates"] > 0
    assert rec["lanes"] == opts.get("lanes", cull.schedule(rec["beams"])[0])
    if "capacity" in opts or rec["longest"] > rec["capacity"]:
        assert rec["overflow"] > 0


def test_beam_cull_of_no_beams_launches_nothing(card):
    """No beams: empty lists, the plain version's shapes, and no launch
    counted (the entry points launch nothing then)."""
    from lidar_brdf_tpu_torch.kernels import cull
    name, nodes, ins, t_max, *_ = chip_smoke.k5_small_cases()[0]
    none = [x[:0] for x in ins]
    cull.KERNEL.launches = 0
    got = cull.beam_cull(nodes, *none, t_max)
    assert cull.KERNEL.launches == 0
    want = cull.beam_cull([x.cpu() for x in nodes], *(x.cpu() for x in none),
                          t_max)
    for g, w in zip(got[:5], want[:5]):
        assert g.is_cuda and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    assert got.sizes == want.sizes == ()


@pytest.mark.parametrize("use_pulse", [False, True])
def test_culled_scan_launches_k5_per_chunk(card, use_pulse):
    """A culled scan culls each chunk on the card: K5 `LAUNCHES` times a
    chunk, none on a repeat from the ladder cache, and the cloud of the
    CPU's plain cull."""
    from lidar_brdf_tpu_torch.kernels import cull
    scene = synthetic.rough_terrain(np.random.default_rng(5), num_tris=4000,
                                    half=30.0)
    cfg = SensorConfig(lidar_type=LiDARType.AERIAL_ZIGZAG,
                       als_position=(0.0, 40.0, 0.0), max_range=200.0,
                       rays_per_pulse=4, max_returns=1, chunk_pulses=128)
    rays = api.build_rays(cfg, scene, device="cpu")
    rays = type(rays)(origin=rays.origin[:512],
                      direction=rays.direction[:512],
                      gps_time=rays.gps_time[:512])
    bvh = api.build_scene_bvh(scene)
    mats = api.MaterialLibrary.default().table_at(1064)
    sim = Simulator(scene=scene, bvh=bvh, cfg=cfg, device="cuda",
                    materials=mats, use_pulse=use_pulse)
    on_card = rays.to("cuda")
    cull.KERNEL.launches = 0
    card = sim.run(on_card)
    assert cull.KERNEL.launches == 4 * cull.LAUNCHES
    sim.run(on_card)
    assert cull.KERNEL.launches == 4 * cull.LAUNCHES
    cpu = Simulator(scene=scene, bvh=bvh, cfg=cfg, device="cpu",
                    materials=mats, use_pulse=use_pulse).run(rays)
    chip_smoke.compare_clouds(f"culled, use_pulse={use_pulse}", card, cpu)


@pytest.mark.parametrize("case", ["uniform", "one cell", "two cells",
                                  "4099 x 8", "1001 x 4", "777 x 1",
                                  "0 x 8", "masked slots"])
def test_table_scatter_matches_plain(card, monkeypatch, case):
    """K6 against its plain version on `chip_smoke.py` phase 15's small
    cases (`k6_check` fails beyond the scatter bound, on NaN at other
    cells, or on other than one launch a call, none for N = 0)."""
    monkeypatch.setattr(chip_smoke, "K6_ROWS", 1 << 16)
    monkeypatch.setattr(chip_smoke, "K6_HOT_ROWS", 1 << 16)
    idx, g, n_cells = chip_smoke.k6_cases({})[case]
    assert idx.is_cuda and g.is_cuda
    r = chip_smoke.k6_check(case, idx, g, n_cells)
    assert r["contributions"] == g.numel()


@pytest.mark.parametrize("grads", ["none", "table", "full"])
def test_table_gradient_launches_k6_once_per_step(card, grads):
    """The bench's `tls` step scatters the table gradient with one K6
    launch a step, and launches none under ``BENCH_GRADS=none``; each row
    scatter of the origin and vertex rows is one launch more
    (`chip_smoke.k6_per_step`: 3 more in a packed ``full`` step)."""
    from lidar_brdf_tpu_torch.kernels import scatter
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "tls", 2048, 10, 1, "city", 2000)
    ws = bench.cull(scene, bvh, cfg, rays, mats, "tile", "cuda")
    step, params = bench.make_step(ws, grads)
    scatter.KERNEL.launches = 0
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    per_step = chip_smoke.k6_per_step(bench.GRADS[grads], ws.scene.num_faces,
                                      ws.rays.num_pulses, ws.cfg.max_returns)
    assert per_step == {"none": 0, "table": 1, "full": 4}[grads]
    assert scatter.KERNEL.launches == 3 * per_step
