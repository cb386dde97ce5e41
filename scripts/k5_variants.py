#!/usr/bin/env python3
"""Time variants of the beam-cull kernel K5 beside each other on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 scripts/k5_variants.py base lanes=32 lanes=64 unpostponed

Each variant is a text change of `lidar_brdf_tpu_torch/kernels/csrc/
beam_cull.cu` (or none), built and loaded by `variant_harness.py` and
launched through the package's own wrapper (`cull.KERNEL` pointed at the
variant's library), with the lanes a beam given for each chunk:

    base          the source as it is, on `cull.schedule`'s paths (a block
                  of 128 lanes a tile beam, a thread a pulse beam)
    thread        the source as it is, one thread a beam on the `tls`
                  chunk too (the earlier design's schedule, with one walk
                  instead of two)
    lanes=N       N lanes a beam (2, 4, 8, 16, 32: up to a warp; 64, 256: a
                  block) on both chunks: the group walk built for N as well
    unpostponed   the thread walk as the host walks: a lane runs the
                  ternary search as soon as its node fails the slab test,
                  while the warp's other lanes wait; the `als` chunk on it,
                  the `tls` chunk as scheduled
    postponed=K   the warp runs the postponed search once K lanes wait (the
                  base: 32, that is once every live lane waits)

Inputs: `chip_smoke.k5_small_cases()` and the `tls` and `als` chunks
(`chip_smoke.k5_chunk_inputs`), built once.  Every variant must give the
plain version's lists bit for bit on each of them, at its lanes
(`chip_smoke.compare_k5`).  Then each variant is timed on the `tls` and
`als` chunks (CUDA events over `chip_smoke.K5_REPS` calls, and by launch
with the profiler), two rounds taken in turns (the second in reverse
order).  Prints one JSON line per (variant, round) and the card's name and
power limit.
"""

from __future__ import annotations

import json
import sys

from variant_harness import ROOT, apply_edits, build_all, card_line

# the thread walk before the ternary search was postponed (`unpostponed`)
THREAD_WALK = """  int n = 0;
  int node = active ? 0 : p.n_nodes;
  while (node < p.n_nodes) {
    Box box;
    int skip, face;
    load_node(p, node, box, skip, face);
    if (beam_box_overlap(b, box, p.t_max)) {
      if (face >= 0) {
        out.put(n++, face, near_distance(b, box));
        node = skip;
      } else {
        node = node + 1;
      }
    } else {
      node = skip;
    }
  }
  return n;
"""

# the base source's thread walk, which `unpostponed` replaces
POSTPONED_WALK = """  int n = 0;
  int node = active ? 0 : p.n_nodes;
  bool wait = false;            // the node's slab test failed: search due
  Box box{}, g{};
  int skip = 0, face = -1;
  for (;;) {
    bool decided = false, hit = false;
    if (node < p.n_nodes && !wait) {
      load_node(p, node, box, skip, face);
      g = grow(b, box);
      decided = slab_accept(b, g, p.t_max);
      hit = decided;
      wait = !decided;
    }
    const unsigned live = __ballot_sync(FULL, node < p.n_nodes);
    const unsigned waiting = __ballot_sync(FULL, wait);
    if (live != 0 && (waiting == live || __popc(waiting) >= POSTPONE) &&
        wait) {
      hit = ternary_accept(b, g, p.t_max);
      decided = true;
      wait = false;
    }
    if (decided) {
      if (hit && face >= 0) {
        out.put(n++, face, near_distance(b, box));
        node = skip;
      } else {
        node = hit ? node + 1 : skip;
      }
    }
    if (live == 0) break;
  }
  return n;
"""

LANES = (2, 4, 8, 16, 32, 64, 256)   # the lanes the base source lacks


def source(name: str, base: str) -> str:
    """The variant ``name`` of K5's source ``base``."""
    if name in ("base", "thread"):
        return base
    if name.startswith("lanes="):
        n = int(name.split("=")[1])
        if n not in LANES:
            raise SystemExit(f"lanes must be one of {LANES}")
        return apply_edits(name, base, [
            ("    case 128:\n",
             f"    case {n}:\n      return launch<{n}>(p, place, s);\n"
             "    case 128:\n", 1)])
    if name == "unpostponed":
        return apply_edits(name, base, [(POSTPONED_WALK, THREAD_WALK, 1)])
    if name.startswith("postponed="):
        k = int(name.split("=")[1])
        return apply_edits(name, base, [
            ("constexpr int POSTPONE = 32;",
             f"constexpr int POSTPONE = {k};", 1)])
    raise SystemExit(f"unknown variant {name}")


def lanes_of(name: str, chunk: str):
    """Lanes a beam of variant ``name`` on ``chunk`` ("tls", "als" or a
    small case); None: `cull.schedule`'s."""
    if name == "thread":
        return 1
    if name.startswith("lanes="):
        return int(name.split("=")[1])
    if name == "unpostponed" or name.startswith("postponed="):
        return None if chunk == "tls" else 1
    return None


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lidar_brdf_tpu_torch.kernels import cull
    names = list(dict.fromkeys(sys.argv[1:] or ["base"]))
    base = open(cull.KERNEL.source).read()
    libs = build_all("k5", {n: source(n, base) for n in names},
                     cull._declare)

    def use(n):
        cull.KERNEL.lib, cull.KERNEL.fn = libs[n], libs[n].lbt_beam_cull_walk

    small = cs.k5_small_cases()
    chunks = {"tls": cs.k5_chunk_inputs(cs.tls_workload("cuda"),
                                        "tls chunk"),
              "als": cs.k5_chunk_inputs(cs.als_workload("cuda"),
                                        "als chunk")}
    for n in names:
        use(n)
        for case in small:
            opts = dict(case[8])
            opts.setdefault("lanes", lanes_of(n, "small"))
            cs.compare_k5(f"{n}: {case[0]}", *case[1:4], kind=case[4],
                          beams=case[5], face_box=case[6], **opts)
        for key, case in chunks.items():
            cs.compare_k5(f"{n}: {case[0]}", *case[1:4], kind=case[4],
                          beams=case[5], face_box=case[6],
                          lanes=lanes_of(n, key))
    print(json.dumps({"exact": names}), flush=True)
    depth = {k: cull.tree_depth(c[1][1], c[1][2]) for k, c in chunks.items()}
    for rnd, order in enumerate((names, names[::-1])):
        for n in order:
            use(n)
            res = {}
            for key, case in chunks.items():
                _, nodes, ins, t_max = case[:4]
                call = lambda: cull.beam_cull(
                    nodes, *ins, t_max, depth=depth[key],
                    lanes=lanes_of(n, key))
                by = cs.device_ms_by_kernel(call, 2)
                res[key] = dict(
                    ms=cs.cuda_ms(call, cs.K5_REPS),
                    lanes=lanes_of(n, key) or cull.schedule(
                        ins[0].shape[0])[0],
                    launch_ms={k: v["ms_per_launch"] for k, v in by.items()
                               if any(x in k for x in cs.K5_KERNELS)})
            print(json.dumps({"variant": n, "round": rnd, "k5": res}),
                  flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
