"""The registry, the window arithmetic, the trace reduction and the
metric readers, on synthetic inputs."""

import ast
import os

import pytest

from perfbench import core, trace

METRICS = os.path.join(core.HERE, "metrics")


def test_every_cell_resolves_its_files_by_name():
    bench = core.load_benchmark()
    assert bench["workloads"]
    for cell in bench["workloads"]:
        spec = core.resolve(bench, cell["name"])
        assert spec["config"]["name"] == cell["config"]
        assert os.path.exists(os.path.join(core.HERE, "drivers",
                                           spec["traffic"]["driver"] + ".py"))
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in names
            assert callable(core.metric_reader(m["name"]).read)
        assert spec["limits"] and all(
            isinstance(v, (int, float)) for v in spec["limits"].values())


def test_every_metric_file_is_named_in_the_benchmark():
    bench = core.load_benchmark()
    named = {m["name"] for m in bench["per_layer"]}
    files = {f[:-3] for f in os.listdir(METRICS) if f.endswith(".py")}
    assert files == named


def test_config_files_are_named_as_configs():
    bench = core.load_benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(core.ROOT, c["file"]))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_closes_at_the_first_completion_past_its_length():
    clock = FakeClock()
    win = core.Window(1.0, clock)
    win.open()
    for _ in range(4):
        clock.t += 0.3
        closed = win.complete(10)
    assert closed and win.completions == 4
    assert win.elapsed == pytest.approx(1.2)
    assert win.rate == pytest.approx(40 / 1.2)


def test_a_stall_inside_the_window_counts_in_the_rate():
    clock = FakeClock()
    win = core.Window(1.0, clock)
    win.open()
    clock.t += 0.1
    assert not win.complete(10)
    clock.t += 2.0                   # one request stalls
    assert win.complete(10)
    assert win.rate == pytest.approx(20 / 2.1)


def test_idle_share_counts_overlapping_kernels_once():
    ops = [("a", 0.0, 0.4), ("b", 0.2, 0.5), ("c", 0.45, 0.6),
           ("d", 0.8, 0.9), ("e", 0.95, 1.5)]
    host = [("aten::mul", 0.55, 0.85), ("aten::add", 0.6, 0.7)]
    s = trace.summarize(ops, host, 0.0, 1.0)
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.6 + 0.1 + 0.05)
    idle = core.metric_reader("fit.device_idle").read(
        dict(trace=s, items=1, rays=1))
    assert idle == pytest.approx(0.25)
    gaps = s["idle_gaps"]
    assert gaps[0][0] == "aten::add" and gaps[0][1] == pytest.approx(0.2)
    assert [g[1] for g in gaps] == pytest.approx([0.2, 0.05])


def test_traversal_roofline_counts_32_bytes_a_ray():
    read = core.metric_reader("fit.traverse_roofline").read
    kernels = [("tile_traverse_kernel(Params)", 0.0, 1e-3),
               ("void pulse_traverse_kernel(Params)", 2e-3, 3e-3),
               ("void at::native::indexing_backward_kernel<float>", 0, 9.0)]
    tr = dict(kernels=kernels, busy_s=1.0, window_s=1.0)
    rays = 13_104_000 * 2
    want = 100.0 * rays * 32 / 3.35e12 / 2e-3
    assert read(dict(trace=tr, items=2, rays=rays)) == pytest.approx(want)
    assert read(dict(trace=dict(tr, kernels=kernels[2:]), items=2,
                     rays=rays)) is None


def test_physics_ms_leaves_out_the_traversal_and_the_cull():
    read = core.metric_reader("fit.physics_device_ms").read
    kernels = [("tile_traverse_kernel(Params)", 0.0, 1.0),
               ("void walk_group_kernel<128>(Params)", 0.0, 1.0),
               ("_Z11sort_kernel6Params", 0.0, 1.0),
               ("void at::native::sort_kernel_x", 0.0, 0.004),
               ("table_scatter_kernel", 0.0, 0.002)]
    tr = dict(kernels=kernels, busy_s=1.0, window_s=1.0)
    assert read(dict(trace=tr, items=2, rays=1)) == pytest.approx(3.0)


def test_checks_hold_each_number_to_its_limit():
    ok, checks = core.checks_of({"a": 0.5, "b": 0}, {"a": 1.0, "b": 0})
    assert ok and checks["b"] == {"value": 0, "limit": 0}
    assert not core.checks_of({"a": float("nan")}, {"a": 1.0})[0]
    assert not core.checks_of({"a": 2.0}, {"a": 1.0})[0]


def test_forbidden_modules_compare_whole_top_level_names():
    found = core.forbidden_loaded(["lidar_brdf_tpu_torch.api", "jaxtyping",
                                   "jax.numpy", "lidar_brdf_tpu.geom"])
    assert found == ["jax", "lidar_brdf_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(core.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] in ("torch", "numpy", "math",
                                              "__future__"), (f, name)


def test_harness_reads_nothing_of_the_jax_package_or_root_bench():
    for dirpath, _, files in os.walk(core.HERE):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for name in _imports(path):
                assert name.split(".")[0] not in core.FORBIDDEN, (path, name)
                assert name not in ("bench", "bench_scaling"), (path, name)
            text = open(path).read()
            for word in ("BENCH_r0", "BENCH_EXTRA", "MULTICHIP_",
                         "lidar_brdf_tpu/"):
                assert word not in text, (path, word)
