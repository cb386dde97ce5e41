"""The port's scaling evidence (`lidar_brdf_tpu_torch/bench_scaling.py`) on
the CPU, at small sizes, with the plain kernel versions.

* The bytes `allreduce_bytes` counts are those a world-1
  `sharded_train_step` hands to `RayMesh.all_reduce`, collective by
  collective (recorded by wrapping it).
* Its two terms of the root script (`bench_scaling.py::_psum_bytes`, run in
  a subprocess: importing that module sets `JAX_PLATFORMS` and
  `XLA_FLAGS`; its `main` is never called, since it rewrites
  `SCALING.json`), and the terrain's vertex count against the root
  script's formula.
* The ring model and the bounds of `analysis` on fixed inputs.
* The port's fan on 2 gloo ranks (`virtual_check`) against the root
  script's `measure(2)` on two virtual CPU devices: the loss to rtol 1e-5
  (XLA contracts multiply-adds into FMAs, the port does not: `ROADMAP.md`
  section C), with the JAX sim-noise buffer handed to the ranks.
* `measured_step`'s shares cover every pulse once, each timed as the
  median of its windows; the fan check runs on the card unless asked for
  the CPU, refuses more ranks than cards and never runs gloo instead;
  `run` refuses a byte count that differs from the step's; `main` writes
  its record under the path given and no file of the repository.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_brdf_tpu_torch import bench, bench_scaling as bs
from lidar_brdf_tpu_torch.io import synthetic
from lidar_brdf_tpu_torch.parallel import shard, worker

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FAN_PULSES_PER_RANK = 256


@pytest.fixture(scope="module")
def jax_script():
    """The root script's `_psum_bytes("tls")` and `measure(2)` at
    FAN_PULSES_PER_RANK pulses a device, one step timed, in a subprocess."""
    code = ("import json, jax, bench_scaling as b\n"
            "print(json.dumps(dict(psum=b._psum_bytes('tls'), "
            "measure=b.measure(2, jax.devices()))))\n")
    env = dict(os.environ, SCALING_PULSES_PER_DEVICE=str(FAN_PULSES_PER_RANK),
               SCALING_ITERS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _setup(config, pulses=256, num_tris=4000):
    return bs.config_setup(config, CPU, pulses=pulses, num_tris=num_tris)


@pytest.mark.parametrize("config", ["tls", "als"])
def test_allreduce_bytes_are_what_the_step_reduces(config, monkeypatch):
    """A world-1 "full" step over the bench's workload (tile path for
    `tls`, ladders for `als`) hands `all_reduce` the loss, the four
    material leaves and the vertices, in that order, of exactly the bytes
    `allreduce_bytes` counts."""
    setup = _setup(config)
    seen = []
    real = shard.RayMesh.all_reduce

    def record(self, tensor, op=torch.distributed.ReduceOp.SUM):
        seen.append(tensor.numel() * tensor.element_size())
        return real(self, tensor, op)

    monkeypatch.setattr(shard.RayMesh, "all_reduce", record)
    scene, bvh, cfg, rays, mats = setup.workload
    ws = bench.cull(scene, bvh, cfg, rays, mats, setup.kind, CPU,
                    traverser=setup.traverser)
    step = shard.sharded_train_step(shard.RayMesh(None, 0, 1, CPU), cfg,
                                    scene_has_water=False,
                                    traverse_fn=ws.traverser,
                                    grad_params="full")
    loss, _, grads = step(ws.scene, ws.materials, ws.rays, ws.noise,
                          ws.scalars, torch.zeros(()), ws.data)
    assert float(loss) > 0 and grads["vertices"].abs().sum() > 0
    got = bs.allreduce_bytes(config, setup.workload, num_tris=4000)
    assert tuple(got["leaves"]) == bs.COLLECTIVES
    assert seen == list(got["leaves"].values())
    assert got["total"] == sum(seen)
    assert got["leaves"]["vertices"] == scene.num_vertices * 12
    # the module's own recording mesh sees the same collectives
    seen.clear()
    assert [b for _, b in bs.step_allreduce_bytes(setup, 128)] == \
        list(got["leaves"].values())
    assert len(seen) == len(bs.COLLECTIVES)


def test_jax_terms_of_tls_are_the_root_scripts(jax_script):
    """The BRDF table and the city's vertices as the root script counts
    them for `tls`: 1,965,600 + 319,884 = 2,285,484 B; the port's step
    reduces 304 B more (the loss, n, roughness and f0)."""
    workload = bs.bench_workload("tls", pulses=64)   # the full 40k city
    got = bs.allreduce_bytes("tls", workload)
    jax = jax_script["psum"]
    assert got["jax_terms"] == jax
    assert jax["total_psum_bytes"] == 2_285_484
    assert (jax["brdf_table_bytes"], jax["vertex_grad_bytes"]) == \
        (1_965_600, 319_884)
    assert got["total"] - jax["total_psum_bytes"] == 304
    assert got["leaves"]["loss"] == 4


@pytest.mark.parametrize("num_tris", [3200, 20_000, 6000, 5000 * 2 + 7])
def test_terrain_vertices_against_the_root_scripts_formula(num_tris):
    """Both packages' `rough_terrain` take floor(sqrt(F / 2)) cells a side;
    the root script's formula (:92-94) takes the ceiling.  Where F / 2 is
    a square (3200, 20,000) the counts agree; elsewhere the formula counts
    one row and one column more (at the `als` config's 5,000,000 faces:
    1583^2 = 2,505,889 against the terrain's 1582^2 = 2,502,724)."""
    from lidar_brdf_tpu.io import synthetic as jsynthetic
    port = synthetic.rough_terrain(np.random.default_rng(0),
                                   num_tris=num_tris).num_vertices
    assert port == jsynthetic.rough_terrain(
        np.random.default_rng(0), num_tris=num_tris).num_vertices
    cells = int(np.sqrt(num_tris / 2))
    assert port == (cells + 1) ** 2
    square = cells * cells * 2 == num_tris
    assert (bs.jax_vertex_formula(num_tris) == port) == square
    if not square:
        assert bs.jax_vertex_formula(num_tris) == (cells + 2) ** 2
    assert bs.jax_vertex_formula(5_000_000) * 12 == 30_070_668
    assert int(np.sqrt(5_000_000 / 2)) == 1581


def _measured(t1, shares, rays=1000):
    """{N: measured_step-shaped dict} with the given slowest steps."""
    out = {1: dict(slowest_step_s=t1, slowest_spread=1.1,
                   card="X, 700.00 W", rays=rays)}
    out.update({n: dict(slowest_step_s=s, slowest_spread=1.2,
                        card="X, 700.00 W", rays=rays)
                for n, s in shares.items()})
    return out


def test_ring_model_and_bounds_on_fixed_inputs():
    """2(N-1)/N x B / W + 2(N-1) x alpha a collective; no term at N = 1;
    weak = t1 / (t1 + t_ar); strong = t1 / (N (slowest + t_ar)); the
    bounds fall as the slowest share or the bytes rise."""
    assert bs.ring_allreduce_s([1e9, 4], 1, 1.0, 1.0) == 0.0
    w, a = 450e9, 1e-5
    assert bs.ring_allreduce_s([450e6], 2, w, a) == pytest.approx(1e-3 + 2e-5)
    assert bs.ring_allreduce_s([450e6, 4], 8, w, a) == pytest.approx(
        1.75e-3 + 1.75 * 4 / w + 2 * 14 * a)
    reduced = {"tls": {"leaves": {"loss": 4, "brdf_table": 45_000_000},
                       "total": 45_000_004}}
    alpha = {"alpha_s": 1e-5, "card": "X, 700.00 W"}
    model = bs.analysis({"tls": _measured(0.1, {2: 0.05, 8: 0.02})},
                        reduced, alpha)
    assert model["kind"] == "analysis"
    assert "assumption" in model["links"]["nvlink_source"]
    assert "assumption" in model["links"]["node_link_source"]
    cases = model["configs"]["tls"]["cases"]
    t2 = 45_000_000 / 450e9 + 4 / 450e9 + 2 * 2 * 1e-5
    assert cases["2 cards"]["allreduce_s"] == pytest.approx(t2)
    assert cases["2 cards"]["weak_bound"] == pytest.approx(0.1 / (0.1 + t2))
    assert cases["2 cards"]["strong_bound"] == pytest.approx(
        0.1 / (2 * (0.05 + t2)))
    assert cases["4 cards"]["strong_bound"] is None
    t16 = 2 * 15 / 16 * 45_000_004 / bs.NODE_LINK_BYTES_S + 2 * 2 * 15 * 1e-5
    assert cases["2 nodes"]["cards"] == 16
    assert cases["2 nodes"]["allreduce_s"] == pytest.approx(t16)
    weaks = [cases[n]["weak_bound"] for n in ("2 cards", "4 cards",
                                              "8 cards", "2 nodes")]
    assert weaks == sorted(weaks, reverse=True) and 0 < weaks[-1] < 1
    slower = bs.analysis({"tls": _measured(0.1, {2: 0.06, 8: 0.03})},
                         reduced, alpha)["configs"]["tls"]["cases"]
    for n in ("2 cards", "8 cards"):
        assert slower[n]["strong_bound"] < cases[n]["strong_bound"]
        assert slower[n]["weak_bound"] == cases[n]["weak_bound"]
    heavier = dict(reduced["tls"], leaves={"loss": 4, "t": 90_000_000})
    assert bs.analysis({"tls": _measured(0.1, {})}, {"tls": heavier}, alpha)[
        "configs"]["tls"]["cases"]["8 cards"]["weak_bound"] < \
        cases["8 cards"]["weak_bound"]
    proj = bs.projection(model)
    node = proj["configs"]["tls"]
    assert cases["8 cards"]["bandwidth_s"] == pytest.approx(
        1.75 * 45_000_004 / 450e9)
    # beside each bound, the bound from the bytes alone (no alpha)
    bw2 = cases["2 cards"]["bandwidth_s"]
    assert bw2 == pytest.approx(45_000_004 / 450e9)
    assert cases["2 cards"]["weak_bound_bytes_only"] == pytest.approx(
        0.1 / (0.1 + bw2))
    assert cases["2 cards"]["strong_bound_bytes_only"] == pytest.approx(
        0.1 / (2 * (0.05 + bw2)))
    assert cases["4 cards"]["strong_bound_bytes_only"] is None
    for n in ("2 cards", "8 cards"):
        assert cases[n]["strong_bound_bytes_only"] > cases[n]["strong_bound"]
        assert cases[n]["weak_bound_bytes_only"] > cases[n]["weak_bound"]
    assert model["configs"]["tls"]["t1_spread"] == 1.1
    assert cases["8 cards"]["slowest_share_spread"] == 1.2
    assert cases["4 cards"]["slowest_share_spread"] is None
    assert "every hop" in model["alpha_source"]
    assert node["single_card_rays_s"] == pytest.approx(1000 / 0.1)
    assert node["node_rays_s"] == pytest.approx(
        1000 / (0.02 + cases["8 cards"]["allreduce_s"]))
    assert "PROJECTED" in proj["label"]


def test_fan_loss_on_2_gloo_ranks_matches_jax_measure_2(jax_script):
    """The port's fan (`build_workload`) on 2 gloo ranks = the root
    script's `measure(2)` on two virtual CPU devices: same pulses, each
    shard's noise from ray index 0 of the JAX buffer.  Every rank reduces
    the same loss, the one-rank loss of the same pulses in process."""
    import jax
    from lidar_brdf_tpu.utils import noise as jnoise
    noise = np.asarray(jnoise.make_sim_noise(jax.random.PRNGKey(0)))
    res = bs.virtual_check((2,), FAN_PULSES_PER_RANK, device="cpu",
                           noise=noise, timeout=240)
    assert res["kind"] == "virtual-correctness-check"
    assert "NOT hardware scaling" in res["note"]
    (row,) = res["rows"]
    want = jax_script["measure"]
    assert row["ranks"] == want["devices"] == 2
    assert row["pulses"] == want["pulses"] and row["rays"] == want["rays"]
    np.testing.assert_allclose(row["loss"], want["loss"], rtol=1e-5)
    assert row["loss_rel_diff"] <= 1e-6
    assert len(row["step_ms"]) == 2 and min(row["step_ms"]) > 0
    assert row["reduced_bytes"] > 1_965_600
    for per_rank in row["all_reduce"]:
        assert set(per_rank) == set(worker.LEAVES) | {"vertices"}
    scene, _, cfg, rays, mats, _, _ = bs.build_workload(8, "cpu")
    assert scene.num_faces == worker.fan_scene().num_faces
    assert cfg.rays_per_pulse == 2 and not cfg.include_shiny_surface_error
    assert tuple(rays.origin.shape) == (8, 2, 3)


@pytest.mark.parametrize("config,world", [("tls", 3), ("als", 4)])
def test_measured_step_covers_every_pulse_once(config, world):
    """The shares follow `pulse_range` (uneven where the pulses do not
    split evenly), cover the pulses once in order, and each steps a
    finite loss; each share's step is the median of its windows; the
    slowest share is the largest step time."""
    setup = _setup(config, pulses=1000)
    m = bs.measured_step(config, world, setup, iters=1, windows=3)
    shares = m["shares"]
    assert len(shares) == world and m["pulses"] == 1000
    assert shares[0]["lo"] == 0 and shares[-1]["hi"] == 1000
    assert all(a["hi"] == b["lo"] for a, b in zip(shares, shares[1:]))
    assert sum(s["pulses"] for s in shares) == 1000
    assert all(s["rays"] == s["pulses"] * 10 for s in shares)
    assert all(np.isfinite(s["loss"]) and s["loss"] > 0 for s in shares)
    assert m["slowest_step_s"] == max(s["step_s"] for s in shares)
    assert m["card"] == "cpu" and all(s["busy"] is None for s in shares)
    assert all(set(s["launches"].values()) == {0} for s in shares)
    for s in shares:
        assert len(s["windows_s"]) == 3
        assert s["step_s"] == sorted(s["windows_s"])[1]
        assert s["spread"] == max(s["windows_s"]) / min(s["windows_s"])
        assert s["buckets"] >= 1 and s["rows"] >= 1 and s["candidates"] > 0
    assert m["slowest_spread"] == shares[m["slowest_rank"]]["spread"]
    assert bs.steps_per_share(1, 3) == 2 + 3 + 1


def test_hardware_check_refuses_more_ranks_than_cards(monkeypatch):
    """The fan check and the fan's workload run on the card unless the
    caller asks for the CPU: with no card they raise.  More NCCL ranks
    than cards raises with a message; nothing is launched, so no gloo run
    takes its place."""
    def no_launch(*a, **kw):
        raise AssertionError("launched")

    monkeypatch.setattr(worker, "launch", no_launch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bs.virtual_check((1,), 16)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bs.build_workload(8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one NCCL rank per card.*never "
                                           "runs gloo"):
        bs.virtual_check((1, 2), 16)


def test_run_refuses_bytes_the_step_does_not_reduce(monkeypatch):
    """`run` holds `allreduce_bytes` against a world-1 step's all_reduce
    calls and raises before any share is stepped where they differ."""
    real = bs.step_allreduce_bytes
    monkeypatch.setattr(bs, "step_allreduce_bytes",
                        lambda setup: real(setup)[:-1])
    monkeypatch.setattr(bs, "measured_step", lambda *a, **kw: 1 / 0)
    with pytest.raises(RuntimeError, match="all-reduced"):
        bs.run(("tls",), (1,), device="cpu", pulses=256, num_tris=2000,
               alpha={"alpha_s": 1e-5})


def test_main_writes_only_its_record(tmp_path, capsys, monkeypatch):
    """`main` on the CPU prints one JSON line and writes its record where
    it is told; no root JSON record is read or touched."""
    def records():
        return {n: os.stat(os.path.join(REPO, n)).st_mtime_ns
                for n in os.listdir(REPO) if n.endswith(".json") and
                n.startswith(("SCALING", "BENCH_", "MULTICHIP_"))}

    roots = records()
    assert "SCALING.json" in roots
    out = tmp_path / "scaling.json"
    monkeypatch.setattr(bs, "CPU_RUN", bs.Sizes(
        ("tls",), (2,), 1, 1, 256, 2000, (1,), 32))
    assert bs.main(["--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["card"] == "cpu"
    assert line["runbook"] == "scripts/gpu_scaling.md"
    assert set(line["analysis"]["tls"]) == {"2 cards", "4 cards", "8 cards",
                                            "2 nodes", "t1_s", "t1_spread"}
    assert line["analysis"]["tls"]["2 cards"]["strong_bound"] > 0
    assert line["analysis"]["tls"]["2 cards"]["strong_bound_bytes_only"] > 0
    rec = json.loads(out.read_text())
    assert set(rec["measured"]["tls"]) == {"1", "2"}
    assert rec["virtual_check"]["rows"][0]["ranks"] == 1
    assert records() == roots
    src = open(bs.__file__).read()
    for name in ("BENCH_", "SCALING.json", "MULTICHIP"):
        assert name not in src
