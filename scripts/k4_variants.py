#!/usr/bin/env python3
"""Time variants of the packet-walk kernel K4 beside each other on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scripts/k4_variants.py base packet32 prefetch min_blocks=0

Each variant is a text change of `lidar_brdf_tpu_torch/kernels/csrc/
packet_traverse.cu`, built and loaded by `variant_harness.py` and launched
through the package's own wrapper (`packet.KERNEL` pointed at the
variant's library):

    base          the source as it is: packets of 1 and 128 rays
                  (`packet.WIDTHS`)
    packet32      also warp packets of 32 rays (one warp a packet, one ray
                  a lane, `__any_sync` for the descend decision); the
                  wrapper is let take width 32 while this variant runs
    prefetch      both successors' records (node + 1 and the skip link)
                  loaded when a node's record is in hand, before the
                  decision, so that the next step's record is in flight
                  (the first design of this kernel's redesign)
    min_blocks=N  N blocks an SM in every kernel's `__launch_bounds__` (a
                  register cap; the base asks 12 of width 1's kernel and
                  nothing of the other); min_blocks=0 asks nothing of any

Inputs: `chip_smoke.k4_inputs()` (the water chunk's level-1 and level-2
rays with their masks, the `tls` rays, the `als` chunk's rays), built once.
Every variant must give the plain version's (t, face) bit for bit at every
packet width it runs, masked where the input has a mask.  Then
`chip_smoke.k4_chunk` on each variant (every width, masked and on every
ray: CUDA events on a queue, walk lengths, bounds), two rounds taken in
turns (the second in reverse order).  Prints one JSON line per (variant,
round) and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys

from variant_harness import ROOT, apply_edits, build_all, card_line

# packet widths a variant runs at, where they are not `packet.WIDTHS`
WIDTHS_OF = {"packet32": (1, 32, 128)}


def source(name: str, base: str) -> str:
    """The variant ``name`` of K4's source ``base``."""
    if name == "base":
        return base
    if name == "packet32":
        return apply_edits(name, base, [
            ("static int blocks_solo = 0, blocks_128 = 0;",
             "static int blocks_solo = 0, blocks_32 = 0, blocks_128 = 0;", 1),
            ("(width != 1 && width != 128)",
             "(width != 1 && width != 32 && width != 128)", 1),
            ("  } else {\n    grid = resident_blocks(packet_kernel<4>",
             "  } else if (width == 32) {\n"
             "    grid = resident_blocks(packet_kernel<1>, blocks_32);\n"
             "  } else {\n    grid = resident_blocks(packet_kernel<4>", 1),
            ("  } else {\n    packet_kernel<4><<<",
             "  } else if (width == 32) {\n"
             "    packet_kernel<1><<<grid, BLOCK, 0, s>>>(p);\n"
             "  } else {\n    packet_kernel<4><<<", 1)])
    if name.startswith("min_blocks="):
        n = int(name.split("=")[1])
        bounds = f"__launch_bounds__(BLOCK, {n})" if n else \
            "__launch_bounds__(BLOCK)"
        return apply_edits(name, base, [
            ("__launch_bounds__(BLOCK)\n", bounds + "\n", 1),
            ("__launch_bounds__(BLOCK, SOLO_MIN_BLOCKS)", bounds, 1)])
    if name != "prefetch":
        raise SystemExit(f"unknown variant {name}")
    step = ("      float4 lo, hi;\n      load_rec(p, node, lo, hi);\n"
            "      const int32_t skip = __float_as_int(hi.z);\n"
            "      const int32_t face = __float_as_int(hi.w);\n"
            "      ++node_steps;\n")
    root = ("    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;\n"
            "    if (p.n_nodes > 0) load_rec(p, 0, lo, hi);\n")
    child = "        float4 clo, chi;\n        load_rec(p, node + 1, clo, chi);\n"
    return apply_edits(name, base, [
        # a successor past the tree's end is loaded (clamped), never used
        ("  lo = __ldg(p.node_rec + 2 * (int64_t)node);\n"
         "  hi = __ldg(p.node_rec + 2 * (int64_t)node + 1);\n",
         "  const int64_t i = 2 * (int64_t)max(0, min(node, p.n_nodes - 1));\n"
         "  lo = __ldg(p.node_rec + i);\n  hi = __ldg(p.node_rec + i + 1);\n",
         1),
        ("    int node = 0;\n", "    int node = 0;\n" + root, 1),
        ("stays put\n", "stays put\n" + root, 1),
        (step, step.split("      float4 lo, hi;\n      load_rec(p, node, lo, "
                          "hi);\n")[1]
         + "      float4 slo, shi;\n      load_rec(p, skip, slo, shi);\n", 2),
        ("        node = skip;\n",
         "        node = skip;\n        lo = slo;\n        hi = shi;\n", 2),
        ("        bool hit = false;\n", child + "        bool hit = false;\n",
         1),
        ("        node = __any_sync(FULL, hit) ? node + 1 : skip;\n",
         "        if (__any_sync(FULL, hit)) {\n          node = node + 1;\n"
         "          lo = clo;\n          hi = chi;\n        } else {\n"
         "          node = skip;\n          lo = slo;\n          hi = shi;\n"
         "        }\n", 1),
        ("        node = box_hit(ray, lo, hi) ? node + 1 : skip;\n",
         child + "        if (box_hit(ray, lo, hi)) {\n"
         "          node = node + 1;\n          lo = clo;\n"
         "          hi = chi;\n        } else {\n          node = skip;\n"
         "          lo = slo;\n          hi = shi;\n        }\n", 1),
    ])


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    names = list(dict.fromkeys(sys.argv[1:] or ["base"]))
    base = open(kpk.KERNEL.source).read()
    libs = build_all("k4", {n: source(n, base) for n in names},
                     kpk._declare)
    base_widths = kpk.WIDTHS

    def use(n):
        kpk.KERNEL.lib, kpk.KERNEL.fn = libs[n], libs[n].lbt_packet_traverse
        kpk.WIDTHS = WIDTHS_OF.get(n, base_widths)

    inputs = cs.k4_inputs()
    plain = {}
    for name, packed, o, d, a in inputs:
        for n in names:
            use(n)
            for w in kpk.WIDTHS:
                if w not in plain:
                    plain[w] = kpk.packet_traverse_plain(
                        *packed, o, d, active=a, width=w)
                got = kpk.packet_traverse(*packed, o, d, active=a, width=w)
                if not (torch.equal(got[0], plain[w][0])
                        and torch.equal(got[1], plain[w][1])):
                    raise SystemExit(f"variant {n} differs from the plain "
                                     f"version on {name} at width {w}")
        plain.clear()
    print(json.dumps({"exact": names}), flush=True)
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            use(n)
            res = cs.k4_chunk(inputs=inputs)
            print(json.dumps({"variant": n, "round": rnd, "ms": {
                name: {k: min(v["events_ms"]) for k, v in r.items()
                       if isinstance(v, dict) and "events_ms" in v}
                for name, r in res.items() if isinstance(r, dict)},
                "k4_chunk": res}), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
