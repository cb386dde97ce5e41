"""The readings that a cell's correctness limits are set from, on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: a run of the cell with a one-step window
(the program's numbers against the reference: the lower readings), runs
with each fault of ``--faults`` planted, then the control, the reference
computed in bfloat16 in the program's place, held against the float32
reference by the same comparison (the upper readings).  One JSON line
a seed on standard output.  Not run by `run.py`.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(spec, seed, device):
    """The control's numbers for ``seed``, as the cell's driver reads
    them."""
    import importlib
    driver = importlib.import_module("perfbench.drivers."
                                     + spec["traffic"]["driver"])
    return driver.control(spec, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true",
                   help="the program's readings alone")
    p.add_argument("--faults", nargs="*", default=[],
                   help="faults planted in the program "
                        "(drivers/fit.py::plant_fault), each read like it")
    args = p.parse_args(argv)
    from perfbench import core
    import run as runner
    spec = core.resolve(core.load_benchmark(), args.workload)
    for seed in args.seeds:
        out = dict(seed=seed)
        t0 = time.perf_counter()
        ns = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        ok, line, lines = runner.execute(spec, ns, clock0=t0)
        out["program"] = json.loads(line)["checks"]
        out["program_s"] = time.perf_counter() - t0
        for fault in args.faults:
            ns = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
            ok, line, lines = runner.execute(spec, ns, fault=fault,
                                             clock0=time.perf_counter())
            out[f"fault_{fault}"] = json.loads(line)["checks"]
        if not args.no_control:
            t0 = time.perf_counter()
            out["control"] = control_numbers(spec, seed, "cuda")
            out["control_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
