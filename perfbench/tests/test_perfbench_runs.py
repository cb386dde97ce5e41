"""Whole runs of each cell on the CPU at a tiny size, past the look for a
card: sound runs come out correct, the bfloat16 control and each planted
fault do not, and no run loads the JAX stack or the JAX package."""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import core

FAULTS = {"alphaprime_city.fit": ["frozen", "half", "altered"],
          "als_terrain.fit": ["frozen", "half", "altered"],
          "als_terrain.survey": ["altered"]}
CELLS = list(FAULTS)


def run_tiny(spec, fault=None, seed=2_500_000_017, trace=1):
    import run as runner
    args = argparse.Namespace(seed=seed, seconds=0.2, trace=trace)
    ok, line, _ = runner.execute(spec, args, device="cpu", fault=fault,
                                 clock0=time.perf_counter())
    return ok, json.loads(line)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tiny_spec):
    spec = tiny_spec(cell)
    ok, line = run_tiny(spec)
    assert ok and line["correct"] and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(spec["limits"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    ok, line = run_tiny(spec, trace=0)
    names = {m["name"] for m in spec["end_to_end"]}
    assert ok and set(line["metrics"]) == names


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items()
                                         for f in fs])
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, tiny_spec):
    from lidar_brdf_tpu_torch import bench
    from lidar_brdf_tpu_torch.kernels.pulse import PulseLadderTraverser
    before = (bench.simulate_chunk, PulseLadderTraverser.__call__)
    ok, line = run_tiny(tiny_spec(cell), fault)
    assert (bench.simulate_chunk, PulseLadderTraverser.__call__) == before
    assert not ok and not line["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_fails_the_limits(cell, tiny_spec):
    import calibrate
    spec = tiny_spec(cell)
    bad = 0
    for seed in (11, 12, 13):
        numbers = calibrate.control_numbers(spec, seed, "cpu")
        bad += not core.checks_of(numbers, spec["limits"])[0]
    assert bad == 3


def test_a_run_loads_no_jax_and_no_jax_package(tiny_spec):
    code = (
        "import sys, time, argparse, json\n"
        f"sys.path[:0] = [{core.ROOT!r}, {core.HERE!r}]\n"
        "from perfbench import core\n"
        "import run as runner\n"
        "from perfbench.tests.conftest import TINY\n"
        "spec = core.resolve(core.load_benchmark(), 'alphaprime_city.fit')\n"
        "for k, v in TINY['alphaprime_city.fit'].items():\n"
        "    spec['config'][k].update(v)\n"
        "a = argparse.Namespace(seed=5, seconds=0.1, trace=0)\n"
        "runner.execute(spec, a, device='cpu', clock0=time.perf_counter())\n"
        "print(json.dumps(core.forbidden_loaded()))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_means_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=core.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, card):
    out = subprocess.run(
        [sys.executable, os.path.join(core.HERE, "run.py"), "--workload",
         cell, "--seed", "2718281828", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
