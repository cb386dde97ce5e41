"""The port's bench (`python -m lidar_brdf_tpu_torch.bench`) and its
pre-flight kernel K3 on the CPU, at small sizes: the JSON line, the
gradient selection, the host cull and the training step.

On the card `kernel_smoke` launches the CUDA kernel; here `affine_smoke`
takes its plain version, because the tensors lie on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from lidar_brdf_tpu_torch import bench
from lidar_brdf_tpu_torch.kernels import smoke

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

SMALL = dict(BENCH_FORCE_CPU="1", BENCH_PULSES="4096", BENCH_TRIS="2000",
             BENCH_ITERS="1")


def _small_tls(grads="full"):
    spec = bench.CONFIGS["tls"]
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "tls", 4096, 10, spec["max_returns"], "city", 2000)
    assert rays.num_pulses == 4096 and rays.rays_per_pulse == 10
    ws = bench.cull(scene, bvh, cfg, rays, mats, "tile", "cpu")
    return ws, bench.make_step(ws, grads)


def test_affine_smoke_plain_is_2x_plus_1():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128) - 300.5
    want = torch.from_numpy(x.numpy() * np.float32(2) + np.float32(1))
    assert torch.equal(smoke.affine_smoke_plain(x), want)
    assert torch.equal(smoke.affine_smoke(x), want)     # CPU: plain version
    with pytest.raises(ValueError, match="unsupported device"):
        smoke.affine_smoke(torch.zeros(4, device="meta"))


def test_kernel_smoke_passes_and_raises_on_a_wrong_result(monkeypatch):
    bench.kernel_smoke("cpu")
    monkeypatch.setattr(bench, "affine_smoke", lambda x: x * 2.0)
    with pytest.raises(RuntimeError, match="cuda-kernel-smoke-failed"):
        bench.kernel_smoke("cpu")


def test_bench_prints_one_json_line(monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "rays_per_s_fwd_bwd_per_chip"
    assert set(line) >= {"metric", "value", "unit", "vs_baseline",
                         "compile_s", "compile_s_warm", "grads", "device",
                         "power_limit_w"}
    assert line["unit"] == "rays/s" and line["value"] > 0
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["grads"] == "brdf_table+sensor_origin+scene_vertices"


def test_bench_metric_names_and_forward_waits(monkeypatch):
    assert bench.metric_name("als") == "rays_per_s_fwd_bwd_per_chip_als"
    assert set(bench.CONFIGS) == {"tls", "multireturn", "als", "alphaprime"}
    monkeypatch.setenv("BENCH_CONFIG", "forward")
    with pytest.raises(NotImplementedError, match="ladder caching"):
        bench.main()


def test_bench_needs_a_card_unless_forced_to_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("BENCH_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()


def test_grads_none_leaves_no_gradient():
    ws, (step, params) = _small_tls("none")
    loss = step()
    assert float(loss) > 0
    for p in params.values():
        assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("grads", ["table", "table+origin", "full"])
def test_step_differentiates_the_selected_set(grads):
    ws, (step, params) = _small_tls(grads)
    before = {k: v.clone() for k, v in params.items()}
    l1, l2 = float(step()), float(step())
    assert l1 > 0 and np.isfinite(l1)
    assert l2 == pytest.approx(l1, rel=1e-6)          # 1e-30 * g: no change
    for k, p in params.items():
        assert p.requires_grad == (k in bench.GRADS[grads])
        assert p.grad is None
        torch.testing.assert_close(p.detach(), before[k], rtol=1e-6,
                                   atol=1e-20)
    # what the step differentiates: finite, non-zero gradients
    probe = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
    bench.step_loss(ws, probe).backward()
    for k in bench.GRADS[grads]:
        g = probe[k].grad
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), k


def test_als_step_takes_the_ladders_unpacked():
    spec = bench.CONFIGS["als"]
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "als", 1024, 10, spec["max_returns"], "terrain", 20_000)
    ws = bench.cull(scene, bvh, cfg, rays, mats, "pulse", "cpu")
    assert ws.kind == "pulse" and scene.num_faces > 1024 * 2
    step, params = bench.make_step(ws, "full")
    assert float(step()) > 0
    t = bench.time_steps(step, "cpu", iters=1, warm=1)
    assert t["step_s"] > 0 and t["loss"] > 0
