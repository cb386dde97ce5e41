"""Where the program's hits and the reference's part, on the card:

    python3 perfbench/hitdiff.py --workload <fit cell> --seeds 1 2

For each seed: the cell's chunk culled by the program (`bench.cull`), its
traversal (K1 or K2) over the chunk's rays, the reference's nearest hits
over the same rays, and, for the rays where they part, the port's
full-tree walk K4 (`geom/intersect.py::intersect_bvh`, no cull) as a
second witness.  One JSON line a seed: rays that differ, ties (same t,
another face), hits only one side has, and which side K4 takes.  Not run
by `run.py`.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def compare(spec, seed, device="cuda") -> dict:
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api, bench
    from lidar_brdf_tpu_torch.core.config import SensorConfig
    from lidar_brdf_tpu_torch.core.types import (MaterialTable, RayBundle,
                                                 TriangleScene)
    from lidar_brdf_tpu_torch.geom.intersect import intersect_bvh
    from perfbench.drivers import fit
    from perfbench.reference.traverse import tree_for
    inp = fit.inputs(spec["config"], seed)
    t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in d.items()}
    scene = api.attach_face_neighbors(TriangleScene(**t(inp["scene"])))
    bvh = api.build_scene_bvh(scene)
    ws = bench.cull(scene, bvh, SensorConfig.from_json(json.dumps(
        inp["sensor"])), RayBundle(**inp["rays"]),
        MaterialTable(**t(inp["materials"])), spec["config"]["fit"][
            "traverser"], device)
    o = ws.rays.origin.reshape(-1, 3)
    d = ws.rays.direction.reshape(-1, 3)
    hp = ws.traverser(ws.rays.origin, ws.rays.direction, ws.data)
    fp, tp = hp.face.reshape(-1).long(), hp.t.reshape(-1).float()
    t_max = inp["sensor"]["max_range"] * spec["traffic"]["t_max_factor"]
    tr, fr = tree_for(ws.scene.vertices, ws.scene.faces).nearest_hits(
        o, d, t_max)
    diff = fp != fr
    both = diff & (fp >= 0) & (fr >= 0)
    tie = both & ((tp - tr).abs() <= 1e-5 * tr.abs().clamp(min=1))
    ref_only = diff & (fp < 0)
    sel = diff.nonzero()[:, 0]
    fk = intersect_bvh(ws.scene, bvh, o[sel], d[sel]).face.reshape(-1).long()
    return dict(seed=seed, rays=int(fp.numel()), differ=int(diff.sum()),
                ties=int(tie.sum()), program_only=int((diff & (fr < 0))
                                                      .sum()),
                reference_only=int(ref_only.sum()),
                k4_with_reference=int((fk == fr[sel]).sum()),
                k4_with_program=int((fk == fp[sel]).sum()),
                k4_on_reference_only=int(((fk == fr[sel]) & (fp[sel] < 0))
                                         .sum()),
                reference_only_t=tr[ref_only][:8].tolist(),
                other_dt=(tp - tr)[both & ~tie][:8].tolist())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from perfbench import core
    spec = core.resolve(core.load_benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps(compare(spec, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
