#!/usr/bin/env python3
"""Time variants of the pulse-ladder kernel K2 beside each other on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scripts/k2_variants.py base cg min_blocks=8 no_tests base@64

Each variant is a text change of `lidar_brdf_tpu_torch/kernels/csrc/
pulse_traverse.cu`, built with the package's nvcc flags into
`build/variants/` and launched through the package's own wrapper
(`pulse.KERNEL` pointed at the variant's library):

    base          the source as it is
    cg            Wald rows copied through L2 only (cp.async.cg), not L1
    min_blocks=N  N blocks an SM in `__launch_bounds__` (a register cap)
    no_tests      each Wald test replaced by a sum over its row: timing
                  only, its faces are wrong
    no_rays       each ray a constant instead of six loads: timing only

A suffix ``@T`` sets the wrapper's threads a block (`pulse.MAX_THREADS`),
e.g. ``base@64``.  Inputs: the `als` chunk and the `tls` city chunk's
ladders, as `chip_smoke.py` builds them.  For each (variant, chunk): faces
equal to the plain version or not, CUDA events on a queue and profiler
device ms per call, two rounds taken in turns (the second in reverse
order).  Prints one JSON line per (variant, chunk) and the card's name and
power limit.
"""

from __future__ import annotations

import json
import re
import sys

from variant_harness import ROOT, apply_edits, build_all, card_line


def source(name: str, base: str) -> str:
    """The variant ``name`` (without its ``@T``) of K2's source ``base``."""
    changes = {
        "base": [],
        "cg": [("lbt::cp_async16_l1(", "lbt::cp_async16(", None)],
        "no_tests": [("const float t_m = lbt::wald_t_m(ray, wr, c[m], t_max);",
                      "const float t_m = wr[0] + wr[5] + wr[11] + ray.ox;",
                      None)],
        "no_rays": [(re.search(r"ray = lbt::Ray\{__ldg.*?\};", base,
                               re.S).group(0),
                     "ray = lbt::Ray{0.01f * r, 0.02f * q, 100.0f, "
                     "0.001f * r, -1.0f, 0.0f};", None)],
    }
    if name.startswith("min_blocks="):
        n = int(name.split("=")[1])
        edits = [("constexpr int MIN_BLOCKS = 12;",
                  f"constexpr int MIN_BLOCKS = {n};", None)]
    else:
        edits = changes[name]
    return apply_edits(name, base, edits)


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    runs = [(a.split("@")[0], int(a.split("@")[1]) if "@" in a else
             pp.MAX_THREADS) for a in (sys.argv[1:] or ["base"])]
    base = open(pp.KERNEL.source).read()
    libs = build_all("k2", {n: source(n, base) for n, _ in runs},
                     pp._declare)
    _, als_t, als_o, als_d, als_b, _ = cs.als_chunk(cs.als_workload("cuda"))
    tls = cs.tls_pulse_chunk(cs.tls_workload("cuda"))
    chunks = {"als": (als_t, als_o, als_d, als_b), "tls": tls[:4]}
    ref = {k: pp.pulse_traverse_plain(t.wald, o, d, b, t.t_max,
                                      t.kernel_rays)[1]
           for k, (t, o, d, b) in chunks.items()}
    res = {}
    for order in (runs, runs[::-1]):
        for n, threads in order:
            pp.KERNEL.lib, pp.KERNEL.fn = libs[n], libs[n].lbt_pulse_traverse
            pp.MAX_THREADS = threads
            for k, (t, o, d, b) in chunks.items():
                call = lambda: pp.pulse_traverse(t.wald, o, d, b, t.t_max,
                                                 t.kernel_rays)
                if (n, threads, k) not in res:
                    res[n, threads, k] = dict(
                        variant=n, threads=threads, chunk=k,
                        exact=bool(torch.equal(call()[1], ref[k])),
                        events_ms=[], device_ms=[])
                r = res[n, threads, k]
                r["events_ms"].append(cs.cuda_ms(call, 20, queued=True))
                r["device_ms"].append(
                    cs.k2_device_split(call, 20)["k2_ms"])
    for r in res.values():
        print(json.dumps(r), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
