"""`chip_smoke.py` rehearsed on the CPU at a small size.

On the card the script compares the CUDA kernel with its plain version;
here both sides are the plain version, which checks the script's phases,
shapes and bookkeeping without a card.  The script itself refuses to run
without one.
"""

import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def test_chip_smoke_phases_on_cpu(monkeypatch, capsys):
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 4096)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "ALS_SUB_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "K4_REPS", 1)
    # the small terrain must still take the ladders, the small city tiles
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    tls = chip_smoke.tls_workload("cpu")
    assert tls[4].num_pulses == 4096 and tls[0].num_faces > 1500
    k1, chunk = chip_smoke.phase_kernel_vs_plain(tls)
    als = chip_smoke.als_workload("cpu")
    assert als[4].num_pulses == 2048 and als[4].rays_per_pulse == 10
    assert als[0].num_faces > 15_000 and als[0].face_neighbors is not None
    als_sim, k2, k2_chunk = chip_smoke.phase_k2_vs_plain(als)
    for k in (k1, k2):
        for key in ("name", "route", "source", "replaces", "max_abs_err",
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            assert key in k
        assert k["max_abs_err"] == 0.0 and k["bound_ms"] > 0
    assert 0 < k1["pairs_needed"] <= k1["pairs_without_exit"]
    assert 0 < k2["pairs_real"] <= k2["pairs_padded"]
    choice = chip_smoke.phase_traverser_choice(tls, als, k1, als_sim)
    assert set(choice) == {"tls", "als"}
    assert choice["als"]["pulses"] == 512
    for r in choice.values():
        assert r["k4_ms"] > 0 and r["k4_cull_s"] == 0.0 and r["k4_pack_s"] > 0
    _, _, fwd = chip_smoke.phase_forward("tls", tls, 4096, {"K1": 1})
    assert fwd["points"] > 0 and fwd["rays"] == 4096 * 10
    _, _, fwd = chip_smoke.phase_forward("als", als, 1024, {"K2": 1})
    assert fwd["points"] > 0 and fwd["rays"] == 2048 * 10
    chip_smoke.phase_card_vs_cpu()
    k3 = {}
    chip_smoke.phase_profiles(chunk, k1, k3, k2_chunk, k2)
    assert k1["device_ms"] is None and k3["host_steps_us"] == {}
    assert k2["device_ms"] is None and k2["fills_device_ms"] is None
    out = capsys.readouterr().out
    assert "faces equal" in out and "K2 als chunk" in out
    assert "K2 planted tie, 128 candidates, groups of 128" in out
    assert "K2 interior padding, hand-built bucket" in out
    assert "K2 tail-padded ladders" in out
    assert "[card-vs-cpu] TLS L=2" in out and "[card-vs-cpu] ALS L=2" in out
    assert "[card-vs-cpu] ALS L=2, use_culled=False" in out
    assert "[card-vs-cpu] water L=3" in out
    assert "[card-vs-cpu] ANALYTIC L=2, model ids 0-7" in out
    assert "[card-vs-cpu] OBJ water L=3" in out


def test_chip_smoke_files_phase_on_cpu(monkeypatch, capsys):
    """Phase 9 at a small size: the city written as OBJ/MTL/PNG with
    sidecars and `.bsdf` tables, the CLI's two-wavelength scan, the
    in-process scans against its files, the cache, dense vs compacted
    readback, ANALYTIC and both render commands."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 4096)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    tls = chip_smoke.tls_workload("cpu")
    res = chip_smoke.phase_files(tls)
    assert set(res["scans"]) == set(chip_smoke.FILES_WAVELENGTHS)
    for stats in res["scans"].values():
        assert stats["points"] > 1000
        assert {"order_s", "cull_s", "device_s", "readback_s",
                "readback_bytes", "ply_s"} <= set(stats)
    rb = res["readback"]
    assert 0 < rb["compact"]["bytes"] < rb["dense"]["bytes"]
    assert res["analytic"]["points"] == res["scans"][1064]["points"]
    assert res["cache_reload_s"] > 0 and res["parse_s"] > 0
    out = capsys.readouterr().out
    assert "[files] readback dense" in out and "clouds equal" in out
    assert not os.path.exists(os.path.join(
        os.path.dirname(chip_smoke.__file__), "build", "chip_smoke_files"))


def test_chip_smoke_water_and_packet_walk_on_cpu(monkeypatch, capsys):
    """The topo-bathymetric scan (the `als` terrain under a water plane,
    3 returns at 532 nm), the `tls` scan with ``use_culled=False`` and K4
    against its plain version, at a small size."""
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "WATER_WARM", 512)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(chip_smoke, "K4_REPS", 1)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    als = chip_smoke.als_workload("cpu")
    water = chip_smoke.water_workload(als)
    scene, _, cfg, _, rays = water
    assert scene.num_faces == als[0].num_faces + 2 * 8 * 8
    assert cfg.bathymetric and cfg.max_returns == 3
    assert rays.num_pulses == 2048 and rays.rays_per_pulse == 10
    launches, res, levels, _ = chip_smoke.phase_water(water)
    assert res["bottom_returns"] > 0 and res["surface_returns"] > 0
    assert res["rays"] == 2048 * 10 and set(launches) == {"K1", "K2", "K4",
                                                          "K5", "K6"}
    assert len(levels) == 2 and len(res["active_share"]) == 2
    for packed, o1, d1, a1 in levels:
        assert o1.shape == d1.shape == (1024 * 10, 3)
        assert a1.shape == (1024 * 10,) and a1.dtype == torch.bool
    # fewer rays walk at level 2 than at level 1 (none at this size), and
    # not every ray at level 1
    assert 0 <= res["active_share"][1] < res["active_share"][0] < 1
    tls = chip_smoke.tls_workload("cpu")
    _, _, walk = chip_smoke.phase_forward("tls packet walk", tls, 2048,
                                          {"K4": 1}, use_culled=False)
    assert walk["points"] > 0 and walk["cull_s"] < 0.5
    k4 = chip_smoke.phase_k4_vs_plain(tls, levels)
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k4
    assert k4["bound_by"] == "operations" and k4["bound_ms"] > 0
    for key in ("water", "water_all", "water_level2_all", "tls"):
        r = k4[key]
        assert 0 < r["leaf_steps"] < r["node_steps"]
        # the solo walks of the rays a call answers, and the first K4's
        # tiles over every ray, which walk no less
        assert 0 < r["work_ms"] <= r["yardstick_ms"]
    r = k4["water_level2"]
    assert (r["node_steps"] == 0) == (r["active"] == 0)
    assert r["bound_ms"] > 0 and r["work_ms"] <= r["yardstick_ms"]
    assert k4["water"]["active"] < k4["water_all"]["active"] == \
        k4["water"]["rays"]
    assert k4["water"]["work_ms"] < k4["water_all"]["work_ms"]
    out = capsys.readouterr().out
    assert f"K4 water rays, masked, packets of {kpk.PACKET}" in out
    assert "K4 grazing fan, masked, packets of 1" in out
    assert "K4 fan over boxes, all rays, packets of 128" in out
    assert "K4 water_level2 rays, all rays" in out
    assert "bottom returns" in out and "bounce level 2" in out


def test_chip_smoke_entry_points_and_no_cull_on_cpu(monkeypatch, capsys):
    """Phase 12 at a small size: (a) `intersect_bvh`, `intersect_packed`,
    `intersect_culled` and `CulledTraverser` against their plain versions
    (both sides plain here) and the brute force; (b) the `als`, `water` and
    `forward` cells with ``use_culled=False`` against culled clouds of the
    same cells."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "WATER_WARM", 512)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(chip_smoke, "FORWARD_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "FORWARD_CHUNK", 1024)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    tls = chip_smoke.tls_workload("cpu")
    tt, og, dg, data, _ = chip_smoke.tls_chunk(tls)
    entry = chip_smoke.phase_entry_points(tls, (tt, og, dg, data))
    assert len(entry) == 3 * 3 + 2 * 3
    for name, r in entry.items():
        assert r["launches"] == 0 and r["hits"] > 0, name
        assert (r["brute_ties"] is None) == ("tls rays" in name
                                              or "ulled" in name), name
    assert entry["intersect_bvh, grazing fan"]["brute_ties"] > 0
    als = chip_smoke.als_workload("cpu")
    water = chip_smoke.water_workload(als)
    forward = chip_smoke.forward_workload()
    assert forward[4].num_pulses == 2048 and forward[2].chunk_pulses == 1024
    culled = {}
    for cell, workload, kernel in (("als", als, "K2"), ("water", water, "K2"),
                                   ("forward", forward, "K1")):
        L = workload[2].max_returns
        per_chunk = {kernel: 1, "K4": L - 1} if cell == "water" \
            else {kernel: 1}
        _, cloud, rec = chip_smoke.phase_forward(cell, workload, 512,
                                                 per_chunk)
        assert rec["peak_bytes"] is None
        culled[cell] = (cloud, rec)
    res = chip_smoke.phase_no_cull(als, water, forward, culled)
    assert set(res) == {"als", "water", "forward"}
    for cell, r in res.items():
        assert r["cull_s"] < 0.5 and r["points"] > 0, cell
        assert r["culled_points"] > 0 and r["culled_wall_s"] > 0, cell
    a = res["als"]
    assert a["common"] > 0.9 * a["culled_points"]
    assert a["face_differs_share"] < 0.01 and a["max_ddist_same_face"] < 1e-3
    # the ladder path's permuted noise draws: millimetres, not metres
    assert a["max_dpos_same_face"] < 0.1
    for cell in ("water", "forward"):
        assert abs(res[cell]["points"] - res[cell]["culled_points"]) \
            <= 0.01 * res[cell]["culled_points"], cell
        assert 0 <= res[cell]["no_value_within_1e_5_share"] \
            <= res[cell]["unmatched_intensity_share"] <= 1, cell
    out = capsys.readouterr().out
    assert "[entry] CulledTraverser, buckets, tls chunk" in out
    assert "[entry] intersect_packed, tile 128, grazing fan" in out
    assert "[no-cull] als" in out and "[no-cull] forward" in out


def test_chip_smoke_k5_phase_on_cpu(monkeypatch, capsys):
    """Phase 13 at a small size: the beam cull's lists, buckets, bounds,
    ladders and permutation against the plain version (here both plain)
    on the small inputs, the `tls` chunk, an `als` chunk and the water
    chunk, with the bound and the host culler's time."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(chip_smoke, "K5_REPS", 1)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    tls = chip_smoke.tls_workload("cpu")
    als = chip_smoke.als_workload("cpu")
    k5 = chip_smoke.phase_k5_vs_plain(tls, als, chip_smoke.water_workload(als))
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k5
    assert k5["route"] == "cuda" and k5["library_ms"] is None
    assert k5["bound_by"] == "operations" and k5["bound_ms"] > 0
    cases = k5["cases"]
    assert cases["tls chunk"]["beams"] == 2048 * 10 // 640
    assert cases["als chunk"]["beams"] == 1024
    assert cases["water level-0 chunk"]["beams"] == 1024
    for name in ("tls chunk", "als chunk"):
        r = cases[name]
        assert r["host_ms"] > 0 and 0 < r["ternary_share"] < 1
        assert r["readbacks"] == 1 and r["longest"] > 0
    big = cases["planted at the slack, 20,000 faces"]
    assert big["longest"] == 20_000
    out = capsys.readouterr().out
    assert "[K5] fan over boxes, beams of 128 rays" in out
    assert "buckets and bounds bit-equal" in out
    assert "ladders and permutation and layout and renumbered ladders" in out


def test_chip_smoke_k4_chunk_on_cpu(monkeypatch):
    """`--k4-chunk` at a small size: the water levels, the `tls` and the
    `als` rays at every packet width, masked and not, with both bounds; no
    launch and no device time on the CPU."""
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 256)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    out = chip_smoke.k4_chunk(reps=1, runs=1)
    assert out["widths"] == list(kpk.WIDTHS) or out["widths"] == kpk.WIDTHS
    for name, masked in (("water_level1", True), ("water_level2", True),
                         ("tls", False), ("als", False)):
        r = out[name]
        assert (r["active"] < r["rays"]) == masked
        walked = r["active"] > 0
        keys = {f"w{w}_all" for w in kpk.WIDTHS}
        if masked:
            keys |= {f"w{w}_active" for w in kpk.WIDTHS}
        assert keys <= set(r)
        for k in keys:
            assert r[k]["launches_per_call"] == 0
            assert len(r[k]["events_ms"]) == 1
            assert (r[k]["node_steps"] > 0) == (walked or "all" in k)
        assert r["bound"]["bound_ms"] > 0


def test_chip_smoke_water_scan_on_cpu(monkeypatch):
    """`--water-scan` at a small size: each run a full scan of the water
    workload with bottom returns counted in its points, its seconds split,
    and no launch on the CPU."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 512)
    monkeypatch.setattr(chip_smoke, "WATER_WARM", 128)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    out = chip_smoke.water_scan(runs=2)
    assert len(out["runs"]) == 2
    for r in out["runs"]:
        assert r["rays"] == 512 * 10 and r["points"] > 0
        assert r["launches"] == {"K1": 0, "K2": 0, "K4": 0, "K5": 0,
                                 "K6": 0}
        for key in ("wall_s", "cull_s", "device_s", "readback_s"):
            assert r[key] >= 0
    assert out["runs"][0]["points"] == out["runs"][1]["points"]


def test_chip_smoke_k2_chunk_on_cpu(monkeypatch):
    """`--k2-chunk` at a small size: the `als` chunk with K2 writing the
    uncovered groups and with the wrapper's fills, and the `tls` ladders;
    no launch and no device time on the CPU."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    out = chip_smoke.k2_chunk(reps=2)
    lo, hi = out["uncovered"]
    assert 0 < lo < hi == 1024 and out["cull_s"] > 0
    assert out["buckets"] and out["tls_buckets"]
    for name in ("main", "fills", "tls"):
        r = out[name]
        assert r["launches_per_call"] == 0 and r["device"]["k2_ms"] is None
        assert len(r["events_ms"]) == 3 and r["call_ms"] > 0


def test_chip_smoke_training_phases_on_cpu(monkeypatch, capsys):
    """Phases 2 (K3), 6 and 7 at a small size: the bench's pre-flight, the
    `tls` and `als` fwd+bwd steps with their gradient checks and the
    BENCH_GRADS split, and the card-vs-CPU gradient comparison."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 4096)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_STEP_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "STEP_ITERS", 1)
    monkeypatch.setattr(chip_smoke, "K3_BIG", 4096)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    k3 = chip_smoke.phase_k3_vs_plain()
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k3
    assert k3["bound_by"] == "bytes" and k3["bound_ms"] > 0
    als = chip_smoke.als_workload("cpu")
    n3, tls_n, als_n, res, k6_steps, row_steps = chip_smoke.phase_training(
        als)
    assert set(res) == {"tls", "als"}
    assert res["tls"]["rays"] == 4096 * 10
    assert res["als"]["rays"] == 1024 * 10
    for r in res.values():
        assert set(r["split"]) == {"none", "table", "table+origin", "full"}
        assert r["loss"] > 0 and min(r["grad_max"].values()) > 0
        assert set(r["kernels"]) == {"table", "full"}
        assert set(r["launches"]) == set(r["split"])
    assert set(tls_n) == set(als_n) == {"K1", "K2", "K6", "K7"}
    # one step's row scatters: the winner rows and the face pack's build
    # and rows (`tls`: 2,000 faces, 4,096 pulses) or the corner vertices
    # (`als`: no pack)
    shapes = lambda k: sorted(tuple(g.shape) for _, g, _ in
                              row_steps[k]["calls"])
    assert shapes("tls") == [(4096, 6), (4096, 23), (2000 * 3, 3)]
    assert shapes("als") == [(2 * 1024, 6), (2 * 1024 * 3, 3)]
    assert row_steps["als"]["levels"] == 2 and row_steps["als"]["rays"] == 10
    # one step's table reads: (return levels x pulses, 8) Hermite cells
    idx, g, n_cells = k6_steps["tls"]
    assert idx.dtype is torch.int32 and g.shape == idx.shape
    assert idx.shape == (4096, 8) and n_cells == 15 * 360 * 91
    assert k6_steps["als"][0].shape == (2 * 1024, 8)
    chip_smoke.phase_card_vs_cpu_grads()
    out = capsys.readouterr().out
    assert "[fwd+bwd] tls" in out and "[fwd+bwd] als BENCH_GRADS" in out
    assert "[card-vs-cpu grads] ALS L=2" in out
    assert "[card-vs-cpu grads] water L=3" in out
    assert "K3 tile" in out


def test_chip_smoke_k6_phase_on_cpu(monkeypatch, capsys):
    """Phase 15 at a small size, the plain version on both sides: every
    case checked against the scatter bound, the large ones timed, and
    K6's record for the kernels line."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "K6_ROWS", 4096)
    monkeypatch.setattr(chip_smoke, "K6_HOT_ROWS", 8192)
    monkeypatch.setattr(chip_smoke, "K6_MS_BUDGET", 1.0)
    gen = torch.Generator().manual_seed(0)
    n_cells = 15 * 360 * 91
    steps = {k: (torch.randint(0, n_cells, (n, 8), generator=gen,
                               dtype=torch.int32),
                 torch.randn((n, 8), generator=gen), n_cells)
             for k, n in (("tls", 2048), ("als", 4096))}
    k6 = chip_smoke.phase_k6_vs_plain(steps)
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k6
    assert k6["route"] == "cuda" and k6["bound_by"] == "bytes"
    assert k6["max_abs_err"] == 0.0 and k6["bound_ms"] > 0
    assert k6["replaces"] == "lidar_brdf_tpu/physics/brdf.py:199"
    cases = k6["cases"]
    assert {"uniform", "one cell", "two cells", "0 x 8", "777 x 1",
            "masked slots", "tls step", "als step"} <= set(cases)
    assert cases["one cell"]["cells"] == 1
    assert cases["one cell"]["contributions"] == 8192 * 8
    assert cases["two cells"]["cells"] == 2
    assert cases["0 x 8"]["contributions"] == 0
    assert cases["777 x 1"]["contributions"] % 32
    masked = cases["masked slots"]
    assert masked["zero_cells"] == 1 and masked["live"] < 4099 * 8 / 3
    for name in chip_smoke.K6_TIMED:
        assert cases[name]["k6_ms"] > 0 and cases[name]["index_put_ms"] > 0
    out = capsys.readouterr().out
    assert "[K6] one cell" in out and "index_put_(accumulate=True)" in out


def test_chip_smoke_rows_phase_on_cpu(monkeypatch, capsys):
    """Phase 16 at a small size, the plain version on both sides: every
    row case checked on its flat cells against the scatter bound, the
    large ones and the steps' timed (the winner rows beside the dense
    compare-select too); then `--step-chunk` on small `alphaprime` and
    `als` steps: their row scatters through phase 16, their row gathers
    through phase 17, counted."""
    from lidar_brdf_tpu_torch import bench
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "ROW_ROWS", 4096)
    monkeypatch.setattr(chip_smoke, "K6_MS_BUDGET", 1.0)
    gen = torch.Generator().manual_seed(0)
    P, R, L = 512, 10, 2
    flat = (torch.arange(P) * R + torch.randint(0, R, (L, P),
                                                generator=gen)).reshape(-1)
    steps = {"tls": dict(calls=[
        (flat, torch.randn((L * P, 6), generator=gen), P * R),
        (torch.randint(0, 300, (L * P,), generator=gen),
         torch.randn((L * P, 23), generator=gen), 300)],
        pulses=P, rays=R, levels=L)}
    cases = chip_smoke.phase_rows(steps)
    assert {"uniform 23", "one row 23", "unique 6", "0 x 23",
            "masked slots", "tls winner rows", "tls face rows"} <= set(cases)
    assert cases["one row 23"]["cells"] == 23
    assert cases["one row 23"]["hottest"] == 4096
    assert cases["0 x 23"]["contributions"] == 0
    assert cases["masked slots"]["zero_cells"] >= 23
    for r in cases.values():
        assert r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
    for name in (*chip_smoke.ROW_TIMED, "tls winner rows", "tls face rows"):
        assert cases[name]["k6_ms"] > 0 and cases[name]["index_put_ms"] > 0
    assert cases["tls winner rows"]["dense_ms"] > 0
    out = capsys.readouterr().out
    assert "[rows] one row 23" in out and "dense compare-select" in out
    monkeypatch.setattr(bench, "CONFIGS", {
        "alphaprime": dict(pulses=1024, rays_pulse=10, max_returns=2,
                           scene="city", num_tris=2000, traverser="tile"),
        "als": dict(pulses=512, rays_pulse=10, max_returns=2,
                    scene="terrain", num_tris=2000, traverser="pulse")})
    chunk = chip_smoke.step_chunk()
    assert chunk["alphaprime"]["scatters"] == 3
    assert chunk["als"]["scatters"] == 2
    assert "alphaprime face rows" in chunk["phase16"]
    # unpacked terrain: 7 gathers a level, 7 over the record slots; packed
    # city: the face pack's 3, 4 a level, 4 over the record slots
    assert chunk["als"]["gathers"] == 2 * 7 + 7
    assert chunk["alphaprime"]["gathers"] == 3 + 2 * 4 + 4
    assert chunk["als"]["row_gather_rows"] == 2 * 512 * 18 + 11 * 1024
    steps = chunk["phase17"]["steps"]
    assert steps["als"]["rows"] == chunk["als"]["row_gather_rows"]
    assert steps["alphaprime"]["calls"] == chunk["alphaprime"]["gathers"]
    assert chunk["als"]["enqueue"]["synced"]["host_ms"] > 0


def test_chip_smoke_gathers_phase_on_cpu(monkeypatch, capsys):
    """Phase 17 at a small size, the plain version on both sides: every
    case bit-equal, the large ones timed; then the gathers of small `als`
    and `alphaprime` steps, captured (`capture_step`), as many as
    `k7_per_chunk` says, checked and timed."""
    from lidar_brdf_tpu_torch import bench
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "GATHER_ROWS", 4096)
    monkeypatch.setattr(chip_smoke, "GATHER_SOURCE", 20_000)
    monkeypatch.setattr(chip_smoke, "K6_MS_BUDGET", 1.0)
    k7 = chip_smoke.phase_gathers({})
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k7
    assert k7["bound_by"] == "bytes" and k7["replaces"] is None
    cases = k7["cases"]
    assert len(cases) == 2 * 7 * 3 + 1 + len(chip_smoke.GATHER_TIMED)
    assert cases["faces 16 B"]["rows"] == 4096 * 10
    assert cases["int32 x 23, empty"]["rows"] == 0
    for name in chip_smoke.GATHER_TIMED:
        assert cases[name]["k7_ms"] > 0 and cases[name]["index_ms"] > 0
    out = capsys.readouterr().out
    assert "[K7] noise 64 B" in out and "bit-equal to src[idx]" in out
    monkeypatch.setattr(bench, "CONFIGS", {
        "alphaprime": dict(pulses=1024, rays_pulse=10, max_returns=2,
                           scene="city", num_tris=2000, traverser="tile"),
        "als": dict(pulses=512, rays_pulse=10, max_returns=2,
                    scene="terrain", num_tris=2000, traverser="pulse")})
    steps = {}
    for name, spec in bench.CONFIGS.items():
        scene, bvh, cfg, rays, mats = bench.build_workload(
            name, spec["pulses"], spec["rays_pulse"], spec["max_returns"],
            spec["scene"], spec["num_tris"])
        ws = bench.cull(scene, bvh, cfg, rays, mats, spec["traverser"],
                        "cpu")
        _, _, steps[name] = chip_smoke.capture_step(ws)
        assert len(steps[name]) == chip_smoke.k7_per_chunk(
            ws.scene, ws.rays.num_pulses, ws.cfg.max_returns)
    sums = chip_smoke.phase_gathers(steps)["steps"]
    assert sums["als"]["calls"] == 2 * 7 + 7
    assert sums["alphaprime"]["calls"] == 3 + 2 * 4 + 4
    assert sums["als"]["rows"] == 2 * 512 * 18 + 11 * 1024
    assert sums["alphaprime"]["k7_ms"] > 0
    assert "[K7] als 00 float32 x 6, 512 rows" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["tls", "als", "water"])
def test_k7_per_chunk_is_a_scans_row_gathers(monkeypatch, kind):
    """`chip_smoke.k7_per_chunk`, the K7 launches a chunk that the forward
    scans are held to on the card, is the number of `row_gather` calls a
    scan makes a chunk on the CPU: the `tls` city (face pack, neighbour
    table), the `als` terrain (no pack) and the topo-bathymetric scan
    (water, bounce levels, L = 3)."""
    from lidar_brdf_tpu_torch.kernels import gather
    from lidar_brdf_tpu_torch.runtime import metrics, simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "WATER_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "WATER_CELLS", 8)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    if kind == "tls":
        workload = chip_smoke.tls_workload("cpu")
    else:
        workload = chip_smoke.als_workload("cpu")
        if kind == "water":
            workload = chip_smoke.water_workload(workload)
    scene, bvh, cfg, mats, rays = workload
    sim = simulate.Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                             device="cpu")
    metrics.clear()
    with metrics.recording():
        calls = chip_smoke.capture(gather, "row_gather",
                                   lambda: sim.run(rays))
    chunks = metrics.recorded()["counts"]["chunks"]
    metrics.clear()
    water = sim.scene_has_water or bool(cfg.bathymetric)
    assert water == (kind == "water") and chunks >= 1
    assert len(calls) == chunks * chip_smoke.k7_per_chunk(
        sim.scene, min(cfg.chunk_pulses, rays.num_pulses), cfg.max_returns,
        water)


def test_chip_smoke_runtime_phase_on_cpu(monkeypatch, capsys):
    """Phase 10 at a small size: the bench's forward config in process
    (cold and cached clouds equal), the `als` scan twice on one
    Simulator (no cull the second time, the cached slice checked against
    a fresh cull), `Simulator.benchmark`, checkpoint/resume and the three
    fit examples (two steps each)."""
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 4096)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 2048)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "ALS_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "FORWARD_PULSES", 4096)
    monkeypatch.setattr(chip_smoke, "FORWARD_CHUNK", 1024)
    monkeypatch.setattr(chip_smoke, "BENCH_EXECS", 2)
    monkeypatch.setattr(chip_smoke, "EXAMPLE_STEPS", 2)
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    tls = chip_smoke.tls_workload("cpu")
    als = chip_smoke.als_workload("cpu")
    res = chip_smoke.phase_runtime(tls, als)
    line = res["forward_bench"]["line"]
    assert line["metric"] == "rays_per_s_forward_end_to_end_per_chip"
    # the cold scan's cloud and record, for phase 12
    cloud, cold = chip_smoke.bench_cold_scan(res["forward_bench"])
    assert "cold_cloud" not in res["forward_bench"]
    assert int(cloud.mask.sum()) == line["points"]
    assert cold["peak_bytes"] is None and cold["cull_s"] > 0
    assert cold["wall_s"] == line["wall_s_cold"]
    assert line["pulses"] == 4096 and line["points"] > 1000
    first, second = res["als_repeat"]
    assert second["cull_s"] < 0.01 * first["cull_s"]
    assert res["benchmark"]["TOTAL"]["n"] == 1
    assert res["checkpoint"]["points"] > 0
    assert set(res["examples"]) == {"fit_brdf", "fit_pose", "fit_geometry"}
    for r in res["examples"].values():
        assert r["steps"] == 2 and r["loss_last"] < r["loss_first"]
    out = capsys.readouterr().out
    assert "[forward bench] cold stats= split" in out
    assert "[cache] als repeat" in out and "permuted slice" in out
    assert "RUN_STEADY" in out and "[checkpoint]" in out
    assert "[examples] fit_geometry" in out
    assert not os.path.exists(os.path.join(
        os.path.dirname(chip_smoke.__file__), "build",
        "chip_smoke_checkpoint"))


def test_chip_smoke_multirank_phase_on_cpu(monkeypatch, capsys):
    """Phase 11 at a small size on the CPU: one rank over gloo in process
    (the tls cloud equal to `simulate_chunk`'s, gradients within phase 7's
    tolerance of a step with no collective), then 4 gloo ranks as
    subprocesses on the tls and als workloads, held against the parent's
    own shards (PLY shards byte-equal, bit-equal losses and gradients
    across ranks, one ladder t_max)."""
    import torch.distributed as dist
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "MULTI_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "MULTI_TIMEOUT", 300)
    tls = chip_smoke.tls_workload("cpu")
    als = chip_smoke.als_workload("cpu")
    res = chip_smoke.phase_multirank(tls, als)
    assert not dist.is_initialized()
    assert res["nccl"]["backend"] == "gloo"
    assert set(res["nccl"]["paths"]) == {"tile", "packet"}
    ranks = res["gloo"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["workloads"]["tls"]["hi"] - r["workloads"]["tls"]["lo"] \
            == 256
        als_step = r["workloads"]["als"]["paths"]["ladder"]
        assert als_step["loss"] > 0 and als_step["reduced_bytes"] > 0
    assert set(res["gloo"]["errs"]) == {"tls", "als"}
    assert "tile.vertices" in res["gloo"]["errs"]["tls"]
    out = capsys.readouterr().out
    assert "[multirank] gloo, 1 rank on cpu" in out
    assert "[multirank] gloo rank 3 of 4" in out
    assert "not a scaling figure" in out


def test_phase_11_comparisons_treat_nan_as_a_value():
    """A NaN equals the same NaN bit for bit; a gradient within tolerance
    must be non-finite exactly where its reference is."""
    nan = float("nan")
    a = torch.tensor([1.0, nan, 3.0])
    assert chip_smoke.bits_equal(a, a.clone())
    assert not chip_smoke.bits_equal(a, torch.tensor([1.0, 2.0, 3.0]))
    assert chip_smoke.within_grad_tol("g", a + 1e-5, a) < 1e-4
    with pytest.raises(SystemExit, match="non-finite"):
        chip_smoke.within_grad_tol("g", torch.tensor([nan, 2.0, 3.0]), a)
    with pytest.raises(SystemExit, match="max"):
        chip_smoke.within_grad_tol("g", a * 2, a)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _scaling_setup(monkeypatch):
    from lidar_brdf_tpu_torch.runtime import simulate
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TLS_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "TLS_TRIS", 2000)
    monkeypatch.setattr(chip_smoke, "ALS_PULSES", 1024)
    monkeypatch.setattr(chip_smoke, "ALS_TRIS", 20_000)
    monkeypatch.setattr(chip_smoke, "SCALING_ITERS", 1)
    monkeypatch.setattr(chip_smoke, "SCALING_WINDOWS", 1)
    monkeypatch.setattr(chip_smoke, "SCALING_WORLDS", (1, 3))
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    return chip_smoke.als_workload("cpu")


def test_chip_smoke_scaling_phase_on_cpu(monkeypatch, capsys):
    """Phase 14 at a small size: every share of the `tls` and `als` steps
    at 1 and 3 ranks (an uneven split), the byte check against a world-1
    step, and the analysis; bounds only where the shares were stepped."""
    res = chip_smoke.phase_scaling(_scaling_setup(monkeypatch),
                                   {"alpha_s": 2e-5, "backend": "gloo"})
    assert set(res["measured"]) == {"tls", "als"}
    for config, by_world in res["measured"].items():
        assert set(by_world) == {1, 3}
        for n, m in by_world.items():
            shares = m["shares"]
            assert [s["rank"] for s in shares] == list(range(n))
            assert shares[0]["lo"] == 0 and shares[-1]["hi"] == 1024
            assert all(a["hi"] == b["lo"] for a, b in zip(shares, shares[1:]))
            assert all(s["busy"] is None and s["peak_bytes"] is None
                       for s in shares)
            assert m["slowest_step_s"] == max(s["step_s"] for s in shares)
    model = res["analysis"]["configs"]
    for config in ("tls", "als"):
        cases = model[config]["cases"]
        assert cases["2 cards"]["strong_bound"] is None
        assert 0 < cases["2 cards"]["weak_bound"] < 1
        assert model[config]["measured_on"] == "cpu"
    assert res["allreduce_bytes"]["tls"]["leaves"]["brdf_table"] == 1_965_600
    out = capsys.readouterr().out
    assert "[scaling] tls share 2 of 3" in out
    assert "[scaling] als all-reduced bytes a step" in out
    assert "equal to a world-1 step's on cpu" in out
    assert "strong not measured here" in out
    assert "[scaling] phase 14 took" in out


def test_chip_smoke_scaling_phase_fails_loudly(monkeypatch):
    """Phase 14 ends the run (non-zero exit) on bytes that differ from the
    step's and on a share whose loss is not finite."""
    from lidar_brdf_tpu_torch import bench_scaling as bs
    als = _scaling_setup(monkeypatch)
    alpha = {"alpha_s": 2e-5, "backend": "gloo"}
    real = bs.step_allreduce_bytes
    monkeypatch.setattr(bs, "step_allreduce_bytes",
                        lambda setup: real(setup)[:-1])
    with pytest.raises(SystemExit, match="all-reduced"):
        chip_smoke.phase_scaling(als, alpha)
    monkeypatch.setattr(bs, "step_allreduce_bytes", real)
    measured = bs.measured_step

    def nan_share(*a, **kw):
        m = measured(*a, **kw)
        m["shares"][-1]["loss"] = float("nan")
        return m

    monkeypatch.setattr(bs, "measured_step", nan_share)
    with pytest.raises(SystemExit, match="loss nan"):
        chip_smoke.phase_scaling(als, alpha)
