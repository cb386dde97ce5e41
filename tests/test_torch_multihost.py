"""The port's multi-process path (`lidar_brdf_tpu_torch/parallel/
multihost.py` and `worker.py`) on `torch.distributed`.

A real 4-process ``gloo`` run of the worker on the CPU (`worker.launch`):
the `small` workload (`tests/test_shard.py`'s scan over a ground plane: the
tile, ladder and packet forwards, a ``"full"`` tile step and a ladder
step) and the `als` workload over a small terrain (1,024 pulses of the
flight: the ladder forward and step).  Its ranks are held against the same
shards computed in this process (`worker.run_shards_alone`): contiguous
ranges, bit-equal losses and gradients on every rank, the PLY shards
together the in-process points as an unordered set, one global ladder
``t_max``, and the reduced loss and gradients the sum of the shards' (loss
rtol 1e-5, gradients rtol 1e-4 / atol 1e-8, as `tests/test_shard.py`).
Also `process_pulse_range` against the JAX function, and the refusals:
``nccl`` with more ranks than cards, ``cuda`` without a card.
"""

import glob
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lidar_brdf_tpu_torch import api
from lidar_brdf_tpu_torch.core.types import RayBundle
from lidar_brdf_tpu_torch.io import synthetic
from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
from lidar_brdf_tpu_torch.io.ply import read_ply
from lidar_brdf_tpu_torch.kernels.traverse import default_t_max
from lidar_brdf_tpu_torch.parallel import multihost, shard, worker

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

WORLD = 4
ALS_PULSES = 1024


def test_process_pulse_range_matches_jax(monkeypatch):
    """Contiguous, disjoint, covering ranges for any (total, n, i), each the
    JAX function's (`tests/test_multihost.py:30-48`)."""
    import jax
    from lidar_brdf_tpu.parallel import multihost as jmultihost
    assert multihost.process_pulse_range(100) == (0, 100)   # no group
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    for n in (1, 2, 3, 4, 8):
        for total in (7, 8, 64, 100, 1001):
            covered = []
            for i in range(n):
                monkeypatch.setattr(jax, "process_count", lambda n=n: n)
                monkeypatch.setattr(jax, "process_index", lambda i=i: i)
                monkeypatch.setattr(dist, "get_world_size", lambda n=n: n)
                monkeypatch.setattr(dist, "get_rank", lambda i=i: i)
                lo, hi = multihost.process_pulse_range(total)
                assert (lo, hi) == jmultihost.process_pulse_range(total)
                assert 0 <= lo <= hi <= total
                covered.append((lo, hi))
            assert covered[0][0] == 0 and covered[-1][1] == total
            for (a, b), (c, d) in zip(covered, covered[1:]):
                assert b == c


def test_single_process_without_an_address(monkeypatch):
    """No address given or set: no group is started, the rank owns the
    whole scan, its mesh runs no collective, its shard is part 0."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = multihost.global_ray_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.world_size) == (None, 0, 1)
    t = torch.ones(3)
    assert mesh.all_reduce(t) is t and torch.equal(t, torch.ones(3))
    rays = RayBundle(origin=torch.zeros(8, 2, 3),
                     direction=torch.zeros(8, 2, 3), gps_time=torch.arange(8.))
    local = multihost.host_local_rays(rays, 8)
    assert torch.equal(local.gps_time, rays.gps_time)
    assert multihost.global_rays(local, mesh).origin.device == mesh.device


def test_nccl_and_cuda_are_never_replaced(monkeypatch):
    """``nccl`` with more ranks than cards, or on the CPU, raises; ``cuda``
    without a card raises (no quiet switch to ``gloo`` or the CPU)."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="nccl backend needs"):
        multihost.initialize_distributed("tcp://127.0.0.1:1", 1, 0,
                                         backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize_distributed("tcp://127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.ray_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker.launch(2, "/nonexistent", ["small"], device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank"):
        multihost.initialize_distributed("tcp://127.0.0.1:1", 2, 0,
                                         backend="nccl")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="one card per rank"):
        multihost.initialize_distributed("tcp://127.0.0.1:1", 8, 0)
    assert not dist.is_initialized()


def _write_scenes(outdir):
    v, f = synthetic.ground_plane(half=40.0, y=0.0, cells=3)
    plane = synthetic.scene_from_arrays(v, f)
    terrain = api.attach_face_neighbors(synthetic.rough_terrain(
        np.random.default_rng(0), num_tris=4000, half=30.0))
    mats = MaterialLibrary.default().table_at(1064)
    for name, scene in (("small", plane), ("als", terrain)):
        worker.write_replicated(os.path.join(outdir, f"{name}.npz"), scene,
                                api.build_scene_bvh(scene), mats)


def _points(clouds) -> np.ndarray:
    """Rows (x, y, z, intensity, gpsTime) of PLY dicts or PointClouds,
    sorted: an unordered set of points."""
    rows = []
    for c in clouds:
        if isinstance(c, dict):
            rows.append(np.stack([c[k] for k in ("x", "y", "z", "intensity",
                                                 "gpsTime")], 1))
        else:
            c = c.compact_host()
            rows.append(np.concatenate(
                [c.position.numpy(), c.intensity.numpy()[:, None],
                 c.gps_time.numpy()[:, None]], 1))
    rows = np.concatenate(rows)
    return rows[np.lexsort(rows.T[::-1])]


def test_four_gloo_ranks_match_the_shards_run_in_process(tmp_path):
    outdir = str(tmp_path)
    _write_scenes(outdir)
    ranks = worker.launch(WORLD, outdir, ["small", "als"], device="cpu",
                          backend="gloo", pulses=ALS_PULSES, timeout=400)
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert {r["backend"] for r in ranks} == {"gloo"}
    for name in ("small", "als"):
        rep = worker.read_replicated(os.path.join(outdir, f"{name}.npz"),
                                     "cpu")
        total = worker.workload_pulses(name, rep[0], ALS_PULSES)
        refs = worker.run_shards_alone(name, rep, total, WORLD, "cpu")
        got = [r["workloads"][name] for r in ranks]
        # the ranges split the scan into contiguous pieces
        assert got[0]["lo"] == 0 and got[-1]["hi"] == total
        for a, b in zip(got, got[1:]):
            assert a["hi"] == b["lo"] and a["lo"] < a["hi"]
        for path in worker.WORKLOADS[name]["paths"]:
            # PLY shards together = the in-process points, unordered
            files = sorted(glob.glob(os.path.join(
                outdir, f"{name}_{path}.part*.ply")))
            assert files == [g["paths"][path]["ply"] for g in got]
            np.testing.assert_array_equal(
                _points(read_ply(f) for f in files),
                _points(ref["clouds"][path] for ref in refs))
            t_max = {g["paths"][path]["t_max"] for g in got}
            if path == "ladder":       # one global t_max on every rank
                assert t_max == {refs[0]["summary"]["paths"][path]["t_max"]}
        if name == "als":              # ... though the shards' own differ
            cfg = worker.workload_config(name, total)
            own = {default_t_max(rep[1], worker.scan_rays(
                cfg, rep[0], g["lo"], g["hi"]).origin) for g in got}
            assert len(own) > 1
        for path, _ in worker.WORKLOADS[name]["steps"]:
            sums = [g["paths"][path]["grad_sums"] for g in got]
            assert len({g["paths"][path]["loss"] for g in got}) == 1
            for k in sums[0]:
                if k != "origin":      # replicated: bit-equal checksums
                    assert len({s[k] for s in sums}) == 1, k
            saved = [torch.load(g["paths"][path]["step_file"],
                                weights_only=True) for g in got]
            loss = sum(float(ref["steps"][path][0]) for ref in refs)
            np.testing.assert_allclose(float(saved[0]["loss"]), loss,
                                       rtol=1e-5)
            ref_grads = [worker.named_grads(ref["steps"][path][2])
                         for ref in refs]
            for k, g0 in saved[0]["grads"].items():
                if k == "origin":      # stays with its rank
                    for s, r in zip(saved, ref_grads):
                        np.testing.assert_allclose(
                            s["grads"][k].numpy(), r[k].numpy(), rtol=1e-4,
                            atol=1e-8)
                    continue
                for s in saved[1:]:
                    assert torch.equal(s["grads"][k], g0), k
                np.testing.assert_allclose(
                    g0.numpy(), sum(r[k] for r in ref_grads).numpy(),
                    rtol=1e-4, atol=1e-8, err_msg=k)
            for k in worker.LEAVES:    # every rank's update is the same
                for s in saved[1:]:
                    assert torch.equal(s["materials"][k],
                                       saved[0]["materials"][k])
            assert float(saved[0]["loss"]) > 0
            assert saved[0]["grads"]["brdf_table"].abs().sum() > 0
        for g in got:                  # all_reduce timed over the group
            for path, _ in worker.WORKLOADS[name]["steps"]:
                ar = g["paths"][path]["all_reduce"]
                assert ar["brdf_table"]["bytes"] == \
                    rep[2].brdf_table.numel() * 4
                assert g["paths"][path]["reduced_bytes"] == sum(
                    v["bytes"] for v in ar.values())


def test_a_failing_rank_stops_every_rank(tmp_path):
    """A rank that fails (here: no scene file) ends the launch with the
    ranks' logs; no rank is left running."""
    with pytest.raises(RuntimeError, match="exited with") as err:
        worker.launch(2, str(tmp_path), ["small"], device="cpu",
                      timeout=120)
    assert "--- rank 1 log ---" in str(err.value)
    assert "small.npz" in str(err.value)
