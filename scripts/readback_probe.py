"""What a cold culled scan's ``readback_s`` holds, on the card.

`Simulator.run` slices (and, on the pulse path, hashes) chunk i+1 on a
worker thread while chunk i is uploaded, culled (K5), traced and read
back on the main thread.  This script runs the `als` and `water` scans of
`chip_smoke.py` (full size, one `Simulator` each, caches cleared before
every run, so each run is cold) in four variants, in the order A B C D D
C B A, and prints each run's ``stats=`` split and wall (`Simulator.run` only,
no construction) and the part of ``readback_s`` spent unpacking the rows
on the host (``unpack_s``):

- ``as_is``: the code as it stands;
- ``worker_idle``: the executor runs each slice at submission, on the main
  thread, so nothing runs beside the readback;
- ``no_hash``: the ladder cache off, so the worker slices and hashes
  nothing (no ray-content key);
- ``cull_on_worker``: the worker also uploads and culls the chunk it
  slices (`Simulator._prep_cached`, K5 queued from that thread on the
  card's one default stream), as the host cull ran there before the cull
  moved to the card; the main thread only traces and reads back.

Run on the card from the repository root:

    python scripts/readback_probe.py [--reps 1] [--threads N]

``--threads N`` sets PyTorch's host threads (`torch.set_num_threads`)
first.

The last line is one JSON object of every run's numbers.
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import Future

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from variant_harness import card_line  # noqa: E402


class _NowExecutor:
    """A ThreadPoolExecutor stand-in that runs each call when submitted."""

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kw):
        fut = Future()
        fut.set_result(fn(*args, **kw))
        return fut


class _Culled:
    """A chunk that the worker has already uploaded and culled."""

    def __init__(self, res):
        self.res = res


def _cull_on_worker(Simulator):
    """(patched, real) `_host_slice` / `_prep_cached` pairs: the worker's
    slice is culled there, and the main thread takes its result."""
    real_slice, real_prep = Simulator._host_slice, Simulator._prep_cached

    def host_slice(self, rays, lo, hi, chunk, key):
        sl, key, key_s = real_slice(self, rays, lo, hi, chunk, key)
        return _Culled(real_prep(self, sl, key)), key, key_s

    def prep_cached(self, sl, key, metrics=None):
        if isinstance(sl, _Culled):
            return sl.res
        return real_prep(self, sl, key, metrics)

    return (host_slice, prep_cached), (real_slice, real_prep)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=1,
                    help="A B C D D C B A rounds per scene")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch.set_num_threads first (0: PyTorch's own)")
    args = ap.parse_args()
    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    from lidar_brdf_tpu_torch.runtime import simulate
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.DEVICE = "cuda"
    print(card_line(), f"; PyTorch host threads {torch.get_num_threads()}",
          flush=True)
    unpack = {"s": 0.0}
    real_unpack = simulate.unpack_compact

    def timed_unpack(rows):
        t0 = time.perf_counter()
        out = real_unpack(rows)
        unpack["s"] += time.perf_counter() - t0
        return out

    simulate.unpack_compact = timed_unpack
    real_pool = simulate.ThreadPoolExecutor
    on_worker, real_methods = _cull_on_worker(Simulator)
    als = chip_smoke.als_workload("cuda")
    scans = {"als": als, "water": chip_smoke.water_workload(als)}
    out = []
    for name, (scene, bvh, cfg, mats, rays) in scans.items():
        sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        device="cuda")
        sim.run(chip_smoke.head(rays, cfg.chunk_pulses))    # builds kernels
        order = ["as_is", "worker_idle", "no_hash", "cull_on_worker"]
        for variant in (order + order[::-1]) * args.reps:
            sim._ladder_cache.clear()
            sim._count_hints.clear()
            sim._bsp_cache.clear()
            sim.cache_ladders = variant != "no_hash"
            simulate.ThreadPoolExecutor = (_NowExecutor
                                           if variant == "worker_idle"
                                           else real_pool)
            Simulator._host_slice, Simulator._prep_cached = (
                on_worker if variant == "cull_on_worker" else real_methods)
            unpack["s"] = 0.0
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cloud = sim.run(rays, stats=stats)
            wall = time.perf_counter() - t0
            simulate.ThreadPoolExecutor = real_pool
            Simulator._host_slice, Simulator._prep_cached = real_methods
            rec = dict(scan=name, variant=variant, wall_s=wall,
                       unpack_s=unpack["s"],
                       points=int(cloud.mask.sum()), **stats)
            out.append(rec)
            print(f"[{name}] {variant}: wall {wall:.4f} s, order "
                  f"{stats['order_s']:.4f}, cull {stats['cull_s']:.4f}, "
                  f"device {stats['device_s']:.4f}, readback "
                  f"{stats['readback_s']:.4f} (unpack {unpack['s']:.4f}), "
                  f"{rec['points']} points", flush=True)
    print(json.dumps({"runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
