"""Where the time of a `tls` share's training step goes, on the card.

`lidar_brdf_tpu_torch/bench_scaling.py::measured_step` steps each rank's
share of a bench config one after another on one card.  On `tls` a share
of 16,384 pulses (one of 8) has stepped in 23-46 ms against 26-34 ms for
the whole 131,072 pulses, its device busy only 0.1-0.2 of that.  This
script steps the whole `tls` config and each of its ``--world`` shares
(`multihost.pulse_range`), in the order whole, share 0, ..., share N-1,
whole, each culled once by the bench (`bench.cull`, one traverser shared)
and warmed by two steps, and prints for each:

- ``steps``: ``--steps`` steps, a synchronize after each: the wall, the
  main thread's CPU time (`time.thread_time`) and the seconds Python's
  garbage collector ran (`gc.callbacks`), each a step: median, least,
  most;
- ``gc_off``: the same steps with the collector off (`gc.disable`);
- ``windows``: 4 windows of 5 steps between two synchronizes, each a mean
  (what a single window of 5 reported before);
- ``host``: 3 steps under `torch.profiler` (CPU activity only): the
  operators' self CPU time a step, the 6 largest, and the calls that wait
  for the card (stream / device synchronizes, device-to-host copies,
  ``aten::item``) a step;
- the cull's buckets, rows and candidates.

Run on the card from the repository root:

    python scripts/share_probe.py [--world 8] [--steps 20]

The last line is one JSON object of every row.
"""

import argparse
import gc
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from lidar_brdf_tpu_torch import bench, bench_scaling as bs  # noqa: E402
from lidar_brdf_tpu_torch.parallel import multihost  # noqa: E402

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense")


class GcClock:
    """Seconds the garbage collector ran since the last `take`."""

    def __init__(self):
        self.total, self._t0 = 0.0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    def take(self) -> float:
        t, self.total = self.total, 0.0
        return t


def _stats(xs) -> dict:
    return dict(median_ms=statistics.median(xs) * 1e3, min_ms=min(xs) * 1e3,
                max_ms=max(xs) * 1e3)


def per_step(step, steps: int, clock: GcClock) -> dict:
    wall, cpu, gcs = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        clock.take()
        t0, c0 = time.perf_counter(), time.thread_time()
        step()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        cpu.append(time.thread_time() - c0)
        gcs.append(clock.take())
    return dict(wall=_stats(wall), thread_cpu=_stats(cpu), gc=_stats(gcs),
                gc_total_ms=sum(gcs) * 1e3)


def windows(step, n: int = 4, iters: int = 5) -> list:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters * 1e3)
    return out


def host_profile(step, reps: int = 3) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    self_us = sum(e.self_cpu_time_total for e in rows)
    top = sorted(rows, key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(
        self_cpu_ms=self_us / reps * 1e-3,
        ops=sum(e.count for e in rows) / reps,
        top=[(e.key[:60], e.self_cpu_time_total / reps * 1e-3,
              e.count / reps) for e in top[:6]],
        waits={e.key: (e.count / reps, e.self_cpu_time_total / reps * 1e-3)
               for e in rows if e.key in WAITS})


def probe(name, setup, lo, hi, steps, clock) -> dict:
    scene, bvh, cfg, rays, mats = setup.workload
    ws = bench.cull(scene, bvh, cfg.with_(chunk_pulses=hi - lo),
                    bs._pulses(rays, lo, hi), mats, setup.kind, setup.device,
                    traverser=setup.traverser)
    step, _ = bench.make_step(ws, "full")
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    row = dict(name=name, lo=lo, hi=hi, steps=per_step(step, steps, clock))
    gc.collect()
    gc.disable()
    try:
        row["gc_off"] = per_step(step, steps, clock)
    finally:
        gc.enable()
    row["windows_ms"] = windows(step)
    row["host"] = host_profile(step)
    shapes = [tuple(b[1].shape) for b in ws.data]
    row.update(buckets=len(shapes), rows=sum(b for b, _ in shapes),
               candidates=sum(b * c for b, c in shapes))
    s, g = row["steps"], row["gc_off"]
    print(f"# {name} [{lo}, {hi}): step {s['wall']['median_ms']:.2f} ms "
          f"[{s['wall']['min_ms']:.2f}, {s['wall']['max_ms']:.2f}], thread "
          f"CPU {s['thread_cpu']['median_ms']:.2f}, gc "
          f"{s['gc_total_ms']:.2f} ms in {steps} steps; gc off "
          f"{g['wall']['median_ms']:.2f} [{g['wall']['min_ms']:.2f}, "
          f"{g['wall']['max_ms']:.2f}]; windows of 5 "
          f"{[round(w, 2) for w in row['windows_ms']]}; host self "
          f"{row['host']['self_cpu_ms']:.2f} ms a step, "
          f"{row['host']['ops']:.0f} ops, waits {row['host']['waits']}; "
          f"{row['buckets']} buckets, {row['rows']} rows, "
          f"{row['candidates']} candidates", flush=True)
    del ws, step
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    setup = bs.config_setup("tls", "cuda")
    total = setup.workload[3].num_pulses
    print(f"# {setup.card}; torch threads {torch.get_num_threads()}, "
          f"{os.cpu_count()} cores", flush=True)
    clock = GcClock()
    rows = [probe("whole", setup, 0, total, args.steps, clock)]
    for i in range(args.world):
        lo, hi = multihost.pulse_range(total, args.world, i)
        rows.append(probe(f"share {i} of {args.world}", setup, lo, hi,
                          args.steps, clock))
    rows.append(probe("whole again", setup, 0, total, args.steps, clock))
    print(json.dumps({"card": setup.card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
