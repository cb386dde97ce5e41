"""Run one cell of the benchmark once, on the card it is started on:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, metrics and limits are found by
name (`core.resolve`).  Set-up is timed from the start of this process to
the window's opening.  With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
by each metric's own file from the profiled window.  The last line on
standard output is the result; the last lines on standard error are the
compared numbers beside their limits.  Exits non-zero, printing no
result, without enough CUDA cards, or when the JAX stack or the JAX
package is loaded once the window has closed.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache of a run lives at a fixed place in the
# checkout, so that only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")


class Context:
    """What a driver gets: the cell's files, the run's arguments, the
    window, and how to read the device record."""

    def __init__(self, spec, seed, seconds, trace, device, clock0,
                 fault=None):
        from perfbench import core
        self.cell, self.config = spec["cell"], spec["config"]
        self.traffic = spec["traffic"]
        self.seed, self.trace, self.device = seed, trace, device
        self.clock0, self.fault = clock0, fault
        self.window = core.Window(seconds)

    def read_device(self, trace):
        import torch
        from perfbench import core
        if self.device == "cpu":
            return dict(platform="cpu", kind="cpu", count=0,
                        memory_peak_bytes=0)
        return core.device_record(torch, self.cell["chips"], trace)


def execute(spec, args, device="cuda", fault=None, clock0=None):
    """Drive the cell and build its result: (correct, result line, check
    lines)."""
    from perfbench import core
    ctx = Context(spec, args.seed, args.seconds, bool(args.trace), device,
                  CLOCK0 if clock0 is None else clock0, fault)
    driver = importlib.import_module(
        "perfbench.drivers." + spec["traffic"]["driver"])
    out = driver.run(ctx)
    correct, checks = core.checks_of(out["numbers"], spec["limits"])
    correct = correct and out["failed"] == 0
    breakdown = None
    if args.trace:
        metrics = {}
        run = dict(out["run"], trace=out["trace"], cell=spec["cell"],
                   config=spec["config"])
        for m in spec["per_layer"]:
            value = core.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if out["trace"] is not None:
            breakdown = {k: out["trace"][k] for k in ("device_ops",
                                                      "idle_gaps")}
    else:
        values = {"setup_s": out["setup_s"],
                  spec["traffic"]["metric"]: out["rate"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    line = core.result_line(correct, out["attempted"], out["failed"],
                            metrics, out["device"], breakdown, checks)
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checks.items()]
    return correct, line, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from perfbench import core
    spec = core.resolve(core.load_benchmark(), args.workload)
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"# card: {core.card_line()}", file=sys.stderr, flush=True)
    correct, line, lines = execute(spec, args)
    found = core.forbidden_loaded()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
