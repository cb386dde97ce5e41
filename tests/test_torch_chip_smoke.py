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
    monkeypatch.setattr(simulate, "PULSE_MIN_FACES", 10_000)
    als = chip_smoke.als_workload("cpu")
    water = chip_smoke.water_workload(als)
    scene, _, cfg, _, rays = water
    assert scene.num_faces == als[0].num_faces + 2 * 8 * 8
    assert cfg.bathymetric and cfg.max_returns == 3
    assert rays.num_pulses == 2048 and rays.rays_per_pulse == 10
    launches, res, level1 = chip_smoke.phase_water(water)
    assert res["bottom_returns"] > 0 and res["surface_returns"] > 0
    assert res["rays"] == 2048 * 10 and set(launches) == {"K1", "K2", "K4"}
    packed, o1, d1 = level1
    assert o1.shape == d1.shape == (1024 * 10, 3)
    tls = chip_smoke.tls_workload("cpu")
    _, _, walk = chip_smoke.phase_forward("tls packet walk", tls, 2048,
                                          {"K4": 1}, use_culled=False)
    assert walk["points"] > 0 and walk["cull_s"] < 0.5
    k4 = chip_smoke.phase_k4_vs_plain(tls, level1)
    for key in ("name", "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in k4
    assert k4["bound_by"] == "operations" and k4["bound_ms"] > 0
    assert k4["water"]["leaf_steps"] < k4["water"]["node_steps"]
    out = capsys.readouterr().out
    assert "K4 water rays" in out and "K4 grazing fan" in out
    assert "bottom returns" in out


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
    n3, n1, n2, res = chip_smoke.phase_training(als)
    assert set(res) == {"tls", "als"}
    assert res["tls"]["rays"] == 4096 * 10
    assert res["als"]["rays"] == 1024 * 10
    for r in res.values():
        assert set(r["split"]) == {"none", "table", "table+origin", "full"}
        assert r["loss"] > 0 and min(r["grad_max"].values()) > 0
    chip_smoke.phase_card_vs_cpu_grads()
    out = capsys.readouterr().out
    assert "[fwd+bwd] tls" in out and "[fwd+bwd] als BENCH_GRADS" in out
    assert "[card-vs-cpu grads] ALS L=2" in out
    assert "[card-vs-cpu grads] water L=3" in out
    assert "K3 tile" in out


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


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
