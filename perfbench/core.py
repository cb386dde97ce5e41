"""What every run shares: the registry that finds a cell's configuration,
traffic mix and metrics by name, the measured window, the device record
and the result line.

A cell (an entry of ``workloads`` in `BENCHMARK.json`) names a
configuration, found as ``configs/<config>.json``, and a traffic mix,
found as ``traffic/<traffic>.json``; the traffic file names its driver
(``drivers/<driver>.py``).  A per-layer metric is read by
``metrics/<metric name>.py``; its correctness limits are
``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules that no run may hold once its window has closed: the JAX stack and
# the JAX package (compared by whole top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_brdf_tpu")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    """A module from a file path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "perfbench_metric_" + name.replace(".", "_"))


def applies(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric belongs to a cell that its ``workloads`` list (every cell
    without the list); a per-layer metric also needs the end-to-end metric
    it moves there."""
    if "workloads" in metric and cell not in metric["workloads"]:
        return False
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with its configuration, traffic, limits and
    metrics, all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = read_json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    traffic = read_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, workload, names)]
    limits = read_json(os.path.join(HERE, "limits", workload + ".json"))
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, limits=limits)


class Window:
    """The measured window: it opens at `open`, and closes at the first
    completion at or after ``seconds``; the rate is every item completed
    over the time from the opening to that completion."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds, self.clock = float(seconds), clock
        self.t0 = self.t_end = None
        self.items = self.completions = 0

    def open(self):
        self.t0 = self.clock()

    def complete(self, items: int) -> bool:
        """Record a completion of ``items``; True once the window has
        closed."""
        now = self.clock()
        self.items += items
        self.completions += 1
        if now - self.t0 >= self.seconds:
            self.t_end = now
            return True
        return False

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t0

    @property
    def rate(self) -> float:
        return self.items / self.elapsed


def forbidden_loaded(modules=None) -> list[str]:
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods
                   if m.split(".")[0] in FORBIDDEN})


def device_record(torch, count: int, trace: dict | None) -> dict:
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
               count=count,
               memory_peak_bytes=int(torch.cuda.max_memory_allocated(0)))
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def checks_of(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number is
    finite and at most its limit."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]
        good = value is not None and math.isfinite(value) and value <= lim
        ok = ok and good
        out[name] = {"value": value, "limit": lim}
    return ok, out


def result_line(correct, attempted, failed, metrics, device, breakdown,
                checks) -> str:
    line = dict(correct=bool(correct), attempted=int(attempted),
                failed=int(failed), metrics=metrics, device=device)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)
