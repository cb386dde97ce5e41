#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`lidar_brdf_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Card and build: prints the card's name and power limit, builds the CUDA
   tile kernel (K1), pulse-ladder kernel (K2), the bench's pre-flight
   kernel (K3), the packet-walk kernel (K4), the beam-cull kernel (K5) and
   the table-gradient scatter-add (K6) from
   `lidar_brdf_tpu_torch/kernels/csrc/` into `build/kernels/` (one nvcc
   each, started together) and launches each once (K1, K2 and K4 on a
   one-triangle input, K5 on the one-node tree over it, K6 on two cells).
2. Kernel vs plain version on the card: K3 equal bit for bit on the
   bench's (8, 128) tile, on 1M elements and on sizes that are no multiple
   of 4, timed beside `torch.addcmul` (CUDA events and host time per
   call); for K1 and K2 every face equal, t to rtol 1e-6 where a face is
   hit.  K1 on random tiles (lists of 4,096), a fan of rays over boxes, a
   tie planted across two blocks of 8 and the `tls` workload's real
   bucket chunk (one launch per call; CUDA events on a queued stream, also
   without the chunk's dummy rows, and back to back); K2 on a fan over
   boxes (group 1 and 4), a grazing fan with fat ladders, a chunk with
   padded pulses, the planted tie (ladders of 64 and 128, groups of 8 and
   128 rays), whole blocks of padding inside hand-built ladders and
   tail-padded ladders, and one real `als` chunk of 131,072 pulses culled as
   `Simulator._prep` does it (one launch per call; the chunks are culled
   on the card by K5).  Both timed with CUDA
   events on their real chunk; then K1, K2 and K4 (no cull, scan order)
   on the same pulses of both scenes (the traverser-choice figures; K2 on
   the `tls` chunk back to back and on a queue).
3. The `tls` forward scan at full width through `api.simulate` (1,310,720
   rays over a ~40k-face city), warm, then timed; the launch counts are
   reset just before the timed run: K1 once per chunk, K5 `LAUNCHES`
   (3) times per chunk (the cull on the card), K2 not; the cull's host
   reads are counted and printed.
4. The `als` forward scan at full width through `api.simulate` (1,048,576
   pulses x 10 rays, 2 returns, over the 4,999,122-face terrain, in chunks
   of 131,072), warm on one chunk, then timed: K2 once per chunk, K5 3
   times per chunk, K1 not.
4b. The topo-bathymetric scan at full width through `api.simulate`: the
   `als` terrain under a water plane (5,007,314 faces), 532 nm,
   bathymetric, 3 returns, the `als` cell's 1,048,576 pulses (eight
   chunks of 131,072), warm on 8,192, then timed: K2 once per chunk (level 0), K4 twice (levels 1 and
   2), K5 3 times per chunk, K1 not; it must give bottom returns.  Then
   the `tls` scan through `Simulator(use_culled=False)` (no cull): K4 once
   per chunk, no K1, no K5.
   The water chunk's bounce levels must hand the walk their active masks.
   K4 against its plain version, faces and t bit for bit and walks as
   long, on every ray and with a mask: a fan over boxes, the grazing fan
   and zero-direction rays at every packet width (1, 128), the `tls`
   rays in scan order and the water chunk's level-1 and level-2 rays at
   `PACKET`; a masked call under `torch.cuda.set_sync_debug_mode("error")`
   (no host sync); K4 timed with CUDA events on the water levels (masked
   and every ray) and the `tls` rays, beside both bounds.
5. Card vs CPU at a small size (L = 1 and 2): same seed, same rays, for
   the TLS tile path and the ALS pulse path (at L = 2 also with
   ``use_culled=False``: K4 for every ray); `tests/test_water.py`'s
   bathymetric scan (L = 3, K1 and K4); an ANALYTIC scan whose materials
   take all eight model ids; and a water scene loaded from OBJ files,
   bathymetric at 532 nm (L = 3, K4 for the bounces).  The card reads
   back compacted, so clouds are compared after `compact_host`.
6. The fwd+bwd training step through the port's bench
   (`lidar_brdf_tpu_torch/bench.py`): its pre-flight K3, then the `tls`
   step at full width (131,072 pulses x 10 rays over the ~40k-face city,
   L = 1, face pack built) and the `als` step over the 4,999,122-face
   terrain of phase 4 at 131,072 pulses (L = 2, no face pack; the flight's
   pulse count cut so that the one cull stays ~5 s).  Launch counts
   are reset before each: K1 must launch once per `tls` step and K2 not, K2
   once per `als` step and K1 not, and K6 (the BRDF table's gradient,
   `physics/brdf.py::TableRead`) once per step of every `BENCH_GRADS`
   setting but ``none``, where it must not launch.  Gradients w.r.t. the
   BRDF table, the ray origins and the vertices must be finite, each with
   a non-zero entry.  Prints rays/s fwd+bwd, the `BENCH_GRADS` split, host
   syncs per step, and the device time by kernel of a profiled ``table``
   and ``full`` step (the ``table`` step must launch no
   `indexing_backward` kernel: the table's reads have no index backward);
   one step's backward hands its K6 inputs to phase 15.
7. Card vs CPU gradients at the sizes of phase 5: loss to rtol 1e-5, each
   gradient within atol 1e-4 * max|g| (scatter-add order on the card is not
   fixed, so gradients are not bitwise reproducible); and through the water
   scan of phase 5 (532 nm, bathymetric, L = 3, K4 for every level), where
   origins are compared ray by ray on pulses whose winners agree and summed
   over each pulse's rays elsewhere (parallel rays tie at the flat bottom).
9. Scenes from files at full width: the `tls` city written as a scene
   directory (OBJ/MTL, PNG textures, `.LiDARMaterial` / `.semanticASPRS`
   sidecars) and a measured-BRDF directory of `.bsdf` files, scanned by
   `python -m lidar_brdf_tpu_torch.cli simulate` (in process, through
   `cli.main`) at 1064 and 1065 nm: K1 once per chunk per wavelength, K2
   and K4 never.  Then the parse, the `.lidar_cache.npz` write and reload
   (no parse, same arrays), the BVH, the measured tables' build, one
   `api.simulate` a wavelength (points, positions and intensities equal
   to the CLI's PLY; the PLY written again has the same bytes; the
   `stats=` split), the scan read back dense and compacted (bytes and
   seconds; equal clouds), the device time of `pack_compact` and of the
   analytic factor at the scan's size, a full-width ANALYTIC scan (as
   many points, finite non-negative intensities) and the `render-ortho`
   and `render-overlays` commands; the CLI's cull per wavelength (the
   second wavelength from the ladder cache: K5 3 times per chunk of the
   first only).  Runs before phase 8.
10. The rest of the runtime, before phase 8: (a) the port's bench with
   ``BENCH_CONFIG=forward`` in process (1,048,576 pulses x 10 rays over the
   city in 8 chunks; warm, cold, cached with metrics, cached): K1 8 times
   in each scan, K5 3 times per chunk in the warm and cold scans and not
   in the cached ones, the cached clouds equal to the cold one bit for
   bit, the JSON line and the `stats=` split of a cold and a cached scan;
   (b) phase 4's `als` scan twice on one `Simulator`: K5 3 times per chunk
   in the first and not launched in the second (every chunk from the
   ladder cache), K2 8 times in each, equal clouds, device memory, and
   chunk 0's cached (permuted) slice and ladders against a fresh cull; (c)
   `Simulator.benchmark` on the `tls` workload, its report printed; (d)
   checkpoint/resume on the forward config cut to 2 chunks (state cut to 1
   chunk, resumed by a new `Simulator`: K1 once, K5 3 times, the
   uninterrupted cloud);
   (e) the three fit examples at their step counts (K4 once a step, K6
   once a step of `fit_brdf` and never in the others, finite falling
   losses, step-0 loss equal to the CPU port's to rtol 1e-5).
11. Multi-rank scans and training steps on `torch.distributed`
   (`lidar_brdf_tpu_torch/parallel/`), before phase 8: (a) one rank over
   NCCL in this process: the `tls` workload at full width (131,072 pulses
   x 10 rays over the city) through `sharded_forward` (tile, packet) and a
   ``"full"`` `sharded_train_step`: the cloud equal to `simulate_chunk`'s
   bit for bit, gradients within phase 7's tolerance of a step with no
   collective, K1 once per call, K5 3 times in each culled path's
   preparation, K6 once per step; (b) 4 ranks over gloo sharing the card,
   started as subprocesses by `parallel/worker.py::launch` (scenes handed
   over as one `.npz` each): the `tls` workload (K1 once per rank per
   forward and per step, K4 once per rank) and the `als` ladder path at
   131,072 pulses over the 4,999,122-face terrain (K2 once per rank per
   forward and per step, one global `t_max`); every rank's PLY shards
   byte-equal to the parent's own shards, losses and gradients bit-equal
   across ranks and within phase 7's tolerance of the sum of the parent's
   shards; K5 3 times in each rank's culled preparation, K6 once per
   step.  `[multirank]`
   lines: per rank wall, cull, forward and step times, each all_reduce's
   time and bytes.
12. The JAX package's last entry points on the card, and the scans with
   no cull, before phase 8: (a) `geom/intersect.py::intersect_bvh`
   and `geom/packet.py::intersect_packed` (tile 1 and 128) on the fan over
   boxes, the grazing fan and the `tls` rays in scan order, each call one
   launch of K4; `geom/beamcull.py::intersect_culled` and
   `CulledTraverser` (dense and bucketed) on phase 2's random tiles and
   `tls` chunk, each call one launch of K1; every call's (t, face)
   bit-equal to the same call with the plain versions, the walks' faces
   equal to the brute force on the small inputs (but at ties and
   barycentric thresholds, checked in float64); (b) the `als`, `water`
   and `forward` cells through `Simulator(use_culled=False)` at full
   width (K4 once a chunk, once a level on `water`): wall, the `stats=`
   split, K4 launches and peak device memory beside the culled scan's,
   and each cloud against the culled cloud of its cell (`als` slot for
   slot, the others by counts and sorted intensities; printed figures,
   not gates).  `[entry]` and `[no-cull]` lines.
13. K5, the beam cull, against its plain version, after phase 4b: counts,
   offsets, faces and near distances bit for bit, then the buckets and
   bounds (tiles) or the ladders, permutation and renumbered ladders
   (pulses) built from either's lists, on a fan over boxes (tiles of 128,
   pulses of 4), beams planted at 0, 0.95 and 1.05 times the slack beside
   leaf boxes (a wide beam's 20,000-face list over the scratch's capacity:
   walked again, sorted in device memory), a chain too deep for shared
   stacks, each on its scheduled path (`kernels/cull.py::schedule`), then
   a thread a beam where a group was scheduled and the overflow path
   forced on both; the `tls` chunk (2,048 tiles), one `als` chunk
   (131,072 pulses) and the water scene's level-0 chunk, with the beams
   over capacity of each; timed by CUDA events and by launch (profiler)
   on those three chunks, beside the port's host culler on the same beams
   (`tls`, `als`), the bound (the plain version's node tests and ternary
   searches times the source's operations) and the longest list.  `[K5]`
   lines.
   Each culled scan's point count and peak device memory are printed
   beside the host cull's, as `PERF.md` section 5 records them
   (`[points]`).
14. The multi-card scaling evidence (`lidar_brdf_tpu_torch/
   bench_scaling.py`), before phase 8: each rank's share of the `tls` and
   `als` fwd+bwd steps (`multihost.pulse_range`) at 1, 2, 4 and 8 ranks,
   every share stepped on the card one after another through the port's
   bench (the `als` terrain of phase 4 shared): K1 (`tls`) or K2 (`als`)
   and K6 once a step and K5 3 times in each share's cull, every share's loss
   finite; the bytes one step all-reduces, leaf by leaf, equal to what a
   world-1 `sharded_train_step` hands to `all_reduce` on the card; the ring
   all-reduce model (`analysis`: stated link rates, phase 11a's 1-rank
   all_reduce time charged on every hop) and its weak and strong bounds
   at 2, 4 and 8 cards and 2 nodes, each beside the bound from the bytes
   alone.  `[scaling]` lines: share steps (the median of 3 windows of 3
   steps, with their spread), buckets, busy shares, peak device bytes,
   bytes, bounds, each beside the card's name and power limit.
15. K6, the table gradient's scatter-add, against its plain version
   (`kernels/scatter.py::table_scatter_add_plain`, `index_add_`), after
   phase 7: uniform random cells, every contribution on one cell
   (2,097,152 x 8), two cells alternating, a count that is no multiple of
   32 (W = 8, 4 and 1), a call with N = 0 (no launch), the masked-slot
   pattern (most cotangents zero on one cell, one NaN), and the real
   (idx, g) of the `tls` and `als` steps of phase 6, captured from one
   step's backward: every cell within count_c * 2^-23 * sum_c |g| of the
   plain version (count_c contributions to cell c; float atomics sum in
   no fixed order), NaN at the same cells.  Timed by CUDA events on a
   queue beside `index_put_(accumulate=True)` (autograd's index backward,
   the port's path before K6) and `index_add_` on the same inputs, with
   the bound of N W 8 + 8 n_cells bytes at 3.35 TB/s.  `[K6]` lines.
8. Profiles, last so that they disturb no timed phase: K1's device time on
   the `tls` chunk, K2's on the `als` chunk (as the Simulator calls it, and
   with the wrapper's two output fills instead), and K3's and
   `torch.addcmul`'s, by `torch.profiler`; each step of K3's wrapper on the
   host over 10,000 calls.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.  It imports nothing of JAX.

`python3 chip_smoke.py --k1-chunk` runs K1 alone on the `tls` chunk,
`--k2-chunk` K2 alone on the `als` chunk and on the `tls` chunk's
ladders, and `--k4-chunk` K4 alone on the water chunk's level-1 and
level-2 rays, the `tls` rays and the `als` chunk's rays at every packet
width, masked and not, beside both bounds; each prints one JSON line
(launches per call, CUDA-event and profiler times).  `--water-scan` runs
the topo-bathymetric scan of phase 4b alone, twice, and prints each
run's wall, cull and device seconds.  `--k5-chunk` builds the kernels and
runs phase 13 without the water chunk; a copy of the script in the root
of an older tree (one whose `beam_cull` takes no ``lanes``, ``capacity``
or ``depth``) skips the forced paths and times that tree's K5.  A copy of the script in the
root of another tree of the repo measures that tree's kernel or scan the
same way (a tree whose K4 takes no mask: every ray, in its 128-ray
tiles).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# f32 operations outside the tensor cores, one per lane per clock: 132 SMs x
# 128 f32 lanes x 1.98 GHz boost (H100 SXM data sheet and Hopper white
# paper).  The sheet's 67 TFLOP/s counts an FMA as two; the kernels are
# built with --fmad=false, so their multiplies and adds run one by one.
H100_F32_OPS_PER_S = 132 * 128 * 1.98e9
OPS_PER_PAIR = 50               # f32 operations per (ray, candidate) test
# f32 operations a ray of a K4 walk step: the slab test of an internal
# node (6 sub, 6 mul, 6 min/max per axis pair, 4 min/max across axes, a
# max with 0, 2 compares) and the Moller-Trumbore test of a leaf (2 cross
# products, 4 dot products, the reciprocal, 4 mul, 3 sub, 8 compares)
OPS_BOX = 26
OPS_TRI = 60
TLS_PULSES = 131072
TLS_RAYS_PULSE = 10
TLS_TRIS = 40_000
ALS_PULSES = 1_048_576          # the flight plan's 1,109,056, sliced
ALS_TRIS = 5_000_000
ALS_CHUNK = 131072
ALS_SUB_PULSES = 8192           # K1 vs K2 on the same als pulses
ALS_STEP_PULSES = 131072        # the als fwd+bwd step: one chunk
WATER_PULSES = 1_048_576        # the topo-bathymetric scan: eight chunks
WATER_WARM = 8192               # its warm run
WATER_CELLS = 64                # water plane cells a side (8,192 faces)
STEP_ITERS = 5                  # timed training steps per measurement
K4_REPS = 10                    # K4 calls a CUDA-event timing (2, 4b)
K3_BIG = 1 << 20                # K3 vs plain on 1M elements as well
FORWARD_PULSES = 1_048_576      # the bench's forward config (phase 10a)
FORWARD_CHUNK = 131072          # its chunks (8); 2 for the checkpoint
BENCH_EXECS = 3                 # Simulator.benchmark repetitions (10c)
EXAMPLE_STEPS = None            # None: each fit example's own step count
MULTI_RANKS = 4                 # phase 11b: ranks sharing the card
MULTI_PULSES = 131072           # phase 11: tls at full width, the als step's
MULTI_TIMEOUT = 600             # phase 11b: seconds the ranks may take
DEVICE = "cuda"                 # a rehearsal on the CPU may set "cpu"


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls, by
    CUDA events.  Where the calls' host work outlasts their device work,
    this is the host's rate.  With ``queued``, the card first sleeps
    (`torch.cuda._sleep`) while the host enqueues all the calls, so the
    events time the device work alone."""
    import torch
    fn()
    sync()
    if DEVICE != "cuda":         # rehearsal only: no device time exists
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        sync()
        # ~2e9 cycles a second: outlast the host's enqueue twice over
        torch.cuda._sleep(int(2 * reps * host_s * 2e9) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean microseconds for ``fn()`` to return on the host, over ``reps``
    back-to-back calls (the card drains the queue after the clock stops)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    sync()
    return us


def device_ms_by_kernel(fn, reps: int) -> dict:
    """Device time of ``fn()`` by kernel name (`torch.profiler`, ``reps``
    calls): ms per call, launches per call and ms per launch; {} in a CPU
    rehearsal (no device time exists there)."""
    import torch
    if DEVICE != "cuda":
        fn()
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() * 1e-3, n + 1)
    return {k: dict(ms=ms / reps, launches=n / reps, ms_per_launch=ms / n)
            for k, (ms, n) in out.items()}


def device_ms(by: dict, match: str = ""):
    """Device ms per call of the kernels of ``by`` (`device_ms_by_kernel`)
    whose name holds ``match``, from each kernel's ms per launch and its
    whole launches per call (at least one): a trace that lost a few
    launches' events, as one late in a long run can, still gives the time
    of a call; None in a CPU rehearsal."""
    if not by:
        return None
    return sum(v["ms_per_launch"] * max(1, round(v["launches"]))
               for k, v in by.items() if match in k)


def k2_device_split(fn, reps: int) -> dict:
    """Device ms per call of ``fn()``: K2's, the output fills' (None each
    in a CPU rehearsal), and every kernel's."""
    by = device_ms_by_kernel(fn, reps)
    return dict(k2_ms=device_ms(by, "pulse_traverse_kernel"),
                fills_ms=device_ms(by, "Fill"), kernels=by)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def tls_workload(device):
    """The `tls` configuration as bench.py builds it (bench.py:153-190)."""
    import numpy as np
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    scene = synthetic.city_scene(np.random.default_rng(0),
                                 num_buildings=(TLS_TRIS - 128) // 12)
    bvh = api.build_scene_bvh(scene)
    vres = 64
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 10.0, 0.0),
        tls_fov_horizontal=360.0, tls_fov_vertical=100.0,
        tls_middle_angle_vertical=-35.0,
        tls_resolution_horizontal=TLS_PULSES // vres,
        tls_resolution_vertical=vres, rays_per_pulse=TLS_RAYS_PULSE,
        max_returns=1, chunk_pulses=TLS_PULSES,
        shading_mode=ShadingMode.MEASURED, include_shiny_surface_error=True)
    mats = MaterialLibrary.default().table_at(1064)
    rays = api.build_rays(cfg, scene, device=device)
    return scene, bvh, cfg, mats, rays


def als_workload(device):
    """The `als` configuration as bench.py builds it (bench.py:153-176,
    200-201), except that it runs in chunks of ALS_CHUNK pulses."""
    import numpy as np
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    from lidar_brdf_tpu_torch.core.types import as_numpy
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    from lidar_brdf_tpu_torch.sensors.als import build_als_rays, plan_flight
    from lidar_brdf_tpu_torch.utils import noise as noise_mod
    scene = synthetic.rough_terrain(np.random.default_rng(0),
                                    num_tris=ALS_TRIS, half=500.0)
    scene = api.attach_face_neighbors(scene)
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 120.0, 0.0),
        als_fov_horizontal=70.0, als_fov_vertical=4.5,
        als_scan_frequency=40, als_pulse_frequency=2560, als_speed=30.0,
        max_range=400.0, rays_per_pulse=10, max_returns=2,
        chunk_pulses=ALS_CHUNK, shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=True)
    mats = MaterialLibrary.default().table_at(1064)
    # what api.build_rays does, with the slice to ALS_PULSES as the count
    lo, hi = scene.aabb()
    plan = plan_flight(cfg, as_numpy(lo), as_numpy(hi),
                       np.random.default_rng(cfg.seed))
    rays = build_als_rays(cfg, plan,
                          noise_mod.make_raygen_noise(cfg.seed + 1).to(device),
                          count=min(ALS_PULSES, plan.num_pulses))
    log(f"[setup] als: {scene.num_faces} faces, flight plan "
        f"{plan.num_pulses} pulses, {rays.num_pulses} used")
    return scene, bvh, cfg, mats, rays


def head(rays, n):
    """The first ``n`` pulses of a RayBundle."""
    from lidar_brdf_tpu_torch.core.types import RayBundle
    return RayBundle(origin=rays.origin[:n], direction=rays.direction[:n],
                     gps_time=rays.gps_time[:n])


def host_rays(rays) -> dict:
    return {k: getattr(rays, k).cpu().numpy()
            for k in ("origin", "direction", "gps_time")}


def fan_rays(n_side):
    import numpy as np
    o0 = np.array([0.0, 9.0, 0.0], np.float32)
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(-1.2, -0.2, n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


def planted_tie(n_cand: int, seed: int = 0):
    """A tie across two of K1's blocks of 8: one 128-ray tile and one list of
    ``n_cand`` >= 64 candidates holding two coincident triangles in
    different blocks of 8, the earlier one with the larger id (face 40 in
    block 1, face 12 in block 6), among 62 small random ones, -1 padded.
    The serial walk gives the tied rays face 40.  Returns numpy (wald
    (64, 12) f32, origins (128, 3), directions (128, 3), ids (n_cand,)
    int32)."""
    import numpy as np
    from lidar_brdf_tpu_torch.geom.beamcull import wald_rows_np
    rng = np.random.default_rng(seed)
    big = np.array([[-20, -20, 5], [20, -20, 5], [0, 30, 5]], np.float64)
    verts = [big if f in (12, 40) else
             rng.uniform([-4, -4, 2], [4, 4, 9]) + rng.normal(0, 0.8, (3, 3))
             for f in range(64)]
    wald = wald_rows_np(np.concatenate(verts),
                        np.arange(192).reshape(64, 3)).astype(np.float32)
    slots = [s for s in range(64) if s not in (8 + 3, 48 + 5)]
    ids = np.full(n_cand, -1, np.int32)
    ids[slots] = [f for f in rng.permutation(64) if f not in (12, 40)]
    ids[8 + 3], ids[48 + 5] = 40, 12
    o = np.zeros((128, 3), np.float32)
    o[:, :2] = rng.uniform(-3, 3, (128, 2))
    d = np.stack([rng.normal(0, 0.15, 128), rng.normal(0, 0.15, 128),
                  np.ones(128)], -1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return wald, o, d, ids


def random_tiles(rng):
    import numpy as np
    from lidar_brdf_tpu_torch.io import synthetic
    scene = synthetic.random_triangles(rng, num_tris=3000, spread=30.0)
    n = 64 * 256
    o = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return scene, o, d


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card_and_build():
    import numpy as np
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from lidar_brdf_tpu_torch.geom.beamcull import wald_rows_np
    from lidar_brdf_tpu_torch.kernels import cuda_build
    from lidar_brdf_tpu_torch.kernels import cull
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import scatter
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    log(card)
    from lidar_brdf_tpu_torch.kernels import smoke
    # one nvcc per kernel source, started together
    libs = (("K1", tr.KERNEL), ("K2", pp.KERNEL), ("K3", smoke.KERNEL),
            ("K4", kpk.KERNEL), ("K5", cull.KERNEL), ("K6", scatter.KERNEL))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(k.build, True) for _, k in libs]:
            fut.result()
    log(f"[build] K1-K6 built in {time.perf_counter() - t0:.2f} s "
        f"({cuda_build.NVCC_FLAGS})")
    for name, k in libs:
        log(f"[build] {name} {os.path.basename(k.source)}: "
            f"{k.build_seconds:.2f} s")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}", line.strip())
    # one triangle at z = 50: K3's compile-and-launch role
    v = np.array([[-1, -1, 50], [1, -1, 50], [0, 1, 50]], np.float32)
    wald = torch.from_numpy(wald_rows_np(v, np.array([[0, 1, 2]]))).cuda()
    o = torch.zeros((128, 3), device="cuda")
    d = torch.tensor([[0.0, 0.0, 1.0]], device="cuda").repeat(128, 1)
    ladder = torch.tensor([[0] + [-1] * 7], dtype=torch.int32, device="cuda")
    bucket = (torch.zeros(1, dtype=torch.int32, device="cuda"), ladder,
              torch.zeros((1, 1), device="cuda"))
    t, f = tr.tile_traverse(wald, o, d, [bucket], 100.0, 128)
    torch.cuda.synchronize()
    if not (bool((f == 0).all()) and bool(((t - 50.0).abs() < 1e-5).all())):
        fail(f"K1 one-tile launch gave faces {f.unique().tolist()}")
    # 128 pulses x 1 ray, each with the one-candidate ladder
    bucket = (torch.arange(128, dtype=torch.int32, device="cuda"),
              ladder.repeat(128, 1))
    t, f = pp.pulse_traverse(wald, o, d, [bucket], 100.0, 1)
    torch.cuda.synchronize()
    if not (bool((f == 0).all()) and bool(((t - 50.0).abs() < 1e-5).all())):
        fail(f"K2 one-ladder launch gave faces {f.unique().tolist()}")
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    y = smoke.affine_smoke(x)
    torch.cuda.synchronize()
    if not torch.equal(y, x * 2.0 + 1.0):
        fail("K3 one-tile launch did not give 2x + 1")
    # a one-leaf tree over the same triangle: 128 rays
    from lidar_brdf_tpu_torch.geom.packet import triangle_rows
    tri = triangle_rows(torch.from_numpy(v).cuda(),
                        torch.tensor([[0, 1, 2]], device="cuda"))
    box = torch.tensor([[-1.0, -1.0, 50.0, 1.0, 1.0, 50.0]], device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    nodes = kpk.node_records(box, torch.ones(1, **i32), torch.zeros(1, **i32))
    t, f = kpk.packet_traverse(*nodes, tri, o, d)
    torch.cuda.synchronize()
    if not (bool((f == 0).all()) and bool(((t - 50.0).abs() < 1e-5).all())):
        fail(f"K4 one-leaf launch gave faces {f.unique().tolist()}")
    # the same one-leaf tree: a beam along z meets it, one beside it not
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")
    lists = cull.beam_cull(nodes, f32([[0.0, 0.0, 0.0], [9.0, 0.0, 0.0]]),
                           f32([[0.0, 0.0, 1.0]] * 2), f32([0.01, 0.01]),
                           f32([0.1, 0.1]),
                           torch.ones(2, dtype=torch.uint8, device="cuda"),
                           100.0)
    torch.cuda.synchronize()
    if lists.counts.tolist() != [1, 0] or lists.faces.tolist() != [0]:
        fail(f"K5 one-node launch gave counts {lists.counts.tolist()}, "
             f"faces {lists.faces.tolist()}")
    # two cells: 1 on cell 0, 2 + 3 + 4 on cell 1 (exact in f32)
    out = scatter.table_scatter_add(
        torch.tensor([[0, 1], [1, 1]], dtype=torch.int32, device="cuda"),
        f32([[1.0, 2.0], [3.0, 4.0]]), 3)
    torch.cuda.synchronize()
    if out.tolist() != [1.0, 9.0, 0.0]:
        fail(f"K6 two-cell launch gave {out.tolist()}")
    log("[build] K1 one-tile, K2 one-ladder, K3 one-tile, K4 one-leaf, "
        "K5 one-node and K6 two-cell launches ok")
    return card


def barycentric_margin(wald, o, d, face):
    """min(u, v, 1-u-v) of ray (o, d) against a face, in float64."""
    import numpy as np
    if face < 0:
        return float("nan")
    r = wald[face].astype(np.float64)
    t = (r[3] - r[0:3] @ o) / (r[0:3] @ d)
    u = r[4:7] @ o + r[7] + t * (r[4:7] @ d)
    v = r[8:11] @ o + r[11] + t * (r[8:11] @ d)
    return float(min(u, v, 1 - u - v))


def compare_kernel(name, tt, o, d, data, tile_rays):
    """K1 vs the plain version on one input set; returns the max |dt|."""
    import torch
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    t_k, f_k = tr.tile_traverse(tt.wald, o, d, data, tt.t_max, tile_rays)
    t_p, f_p = tr.tile_traverse_plain(tt.wald, o, d, data, tt.t_max,
                                      tile_rays)
    sync()
    diff = (f_k != f_p).nonzero().flatten()
    if diff.numel():
        w = tt.wald.cpu().numpy()
        for i in diff[:5].tolist():
            oi, di = o[i].cpu().numpy(), d[i].cpu().numpy()
            log(f"[kernel] {name}: ray {i} K1 face {int(f_k[i])} "
                f"(margin {barycentric_margin(w, oi, di, int(f_k[i])):.3e})"
                f" vs plain face {int(f_p[i])} "
                f"(margin {barycentric_margin(w, oi, di, int(f_p[i])):.3e})")
        fail(f"{name}: {diff.numel()} faces differ between K1 and plain")
    hit = f_p >= 0
    if not torch.allclose(t_k[hit], t_p[hit], rtol=1e-6, atol=0.0):
        fail(f"{name}: t differs beyond rtol 1e-6")
    err = float((t_k[hit] - t_p[hit]).abs().max()) if bool(hit.any()) \
        else 0.0
    log(f"[kernel] {name}: {o.shape[0]} rays, {int(hit.sum())} hits, "
        f"{sum(len(b[0]) for b in data)} bucket rows: faces equal, "
        f"max |dt| {err:.3e}")
    return err


def work_counts(data, t_best, t_max, tile_rays, n_faces, n_rays):
    """(pairs needed, pairs without exit, bytes) for one traversal call.

    A pair is needed when its block's lower bound does not exceed the ray's
    final best t (t_max for a miss): no bound-based exit can skip it.
    """
    import torch
    tb = torch.clamp(t_best, max=t_max).view(-1, tile_rays)
    needed = 0
    padded = 0
    nbytes = n_faces * 12 * 4 + n_rays * (6 * 4 + 8)   # wald, rays, out
    for tidx, cand, bnd in data:
        keep = tidx < tb.shape[0]
        rows_t = tb[tidx[keep].long()]                         # (B, R)
        live = bnd[keep][:, None, :] <= rows_t[:, :, None]     # (B, R, CB)
        needed += int(live.sum()) * 8
        padded += int(keep.sum()) * tile_rays * cand.shape[1]
        nbytes += cand.numel() * 4 + bnd.numel() * 4 + tidx.numel() * 4
    return needed, padded, nbytes


def bound(pairs, nbytes):
    """(bound ms, "bytes" or "operations", ops ms, bytes ms)."""
    ops_ms = pairs * OPS_PER_PAIR / H100_F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def tls_chunk(tls):
    """The `tls` workload's one chunk, BSP-ordered and culled as
    `Simulator._prep` does it: (traverser, origins, directions, buckets,
    cull seconds)."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator, bsp_order
    scene, bvh, cfg, mats, rays = tls
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    order = bsp_order(rays, sim.block_pulses)
    host = {k: v[order] for k, v in host_rays(rays).items()}
    t0 = time.perf_counter()
    sl, data, _ = sim._prep(host, 0, rays.num_pulses, rays.num_pulses)
    cull_s = time.perf_counter() - t0
    return (sim.traverser, sl.origin.reshape(-1, 3).contiguous(),
            sl.direction.reshape(-1, 3).contiguous(), data, cull_s)


def k1_chunk(reps: int = 20) -> dict:
    """K1 alone on the `tls` chunk, for comparing two trees on one card
    (``python3 chip_smoke.py --k1-chunk``, from a copy of this script in
    the root of either tree): launches per call, CUDA-event ms per call
    (three runs of ``reps``), profiler device ms per call."""
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    tls = tls_workload(DEVICE)
    tr_, og, dg, data, _ = tls_chunk(tls)
    call = lambda: tr.tile_traverse(tr_.wald, og, dg, data, tr_.t_max,
                                    tr_.tile_rays)
    per_call = launches_in(tr.KERNEL, call)
    events = [cuda_ms(call, reps, queued=True) for _ in range(3)]
    call_ms = cuda_ms(call, reps)
    return dict(source=os.path.dirname(os.path.abspath(__file__)),
                buckets=[tuple(c.shape) for _, c, _ in data],
                launches_per_call=per_call, events_ms=events,
                call_ms=call_ms, device_ms=device_ms(
                    device_ms_by_kernel(call, reps), "tile_traverse_kernel"))


def k2_chunk(reps: int = 20) -> dict:
    """K2 alone, for comparing two trees on one card (``python3
    chip_smoke.py --k2-chunk``, from a copy of this script in the root of
    either tree): on the `als` chunk as the Simulator calls it (``main``)
    and with the uncovered groups not named (``fills``: the wrapper fills
    the outputs first), and on the `tls` city chunk's ladders (``tls``, the
    traverser-choice input).  Each: launches per call, CUDA-event ms per
    call (three runs of ``reps`` queued, one back to back), profiler device
    ms of K2 and of the output fills."""
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    _, tr_, og, dg, data, cull_s = als_chunk(als_workload(DEVICE))
    tls = tls_pulse_chunk(tls_workload(DEVICE))
    out = dict(source=os.path.dirname(os.path.abspath(__file__)),
               buckets=[tuple(c.shape) for _, c in data],
               uncovered=getattr(data, "uncovered", None), cull_s=cull_s,
               tls_buckets=[tuple(c.shape) for _, c in tls[3]])
    for name, (t, o, d, b) in (("main", (tr_, og, dg, data)),
                               ("fills", (tr_, og, dg, pp.PulseLadders(data))),
                               ("tls", tls[:4])):
        call = lambda: pp.pulse_traverse(t.wald, o, d, b, t.t_max,
                                         t.kernel_rays)
        out[name] = dict(
            launches_per_call=launches_in(pp.KERNEL, call),
            events_ms=[cuda_ms(call, reps, queued=True) for _ in range(3)],
            call_ms=cuda_ms(call, reps), device=k2_device_split(call, reps))
    return out


def phase_kernel_vs_plain(tls):
    """K1 against its plain version on every input, timed on the `tls`
    chunk.  Returns (K1's record, the chunk: traverser, origins,
    directions, buckets)."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser
    errs = []
    rng = np.random.default_rng(7)
    scene, o, d = random_tiles(rng)
    tt = TileTraverser(scene, tile_rays=256, device=DEVICE)
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=80.0)
    errs.append(compare_kernel("random tiles", tt,
                               torch.from_numpy(o).to(DEVICE),
                               torch.from_numpy(d).to(DEVICE), data, 256))
    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    o, d = fan_rays(64)
    tt = TileTraverser(scene, tile_rays=128, device=DEVICE)
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=500.0)
    errs.append(compare_kernel("fan over boxes", tt,
                               torch.from_numpy(o).to(DEVICE),
                               torch.from_numpy(d).to(DEVICE), data, 128))
    # a tie across two blocks of 8, beside a dummy row, in lists of one
    # and of four 128-candidate stages
    for n_cand in (128, 512):
        wald, o, d, ids = (torch.from_numpy(a).to(DEVICE)
                           for a in planted_tie(n_cand))
        bucket = (torch.tensor([0, 1], dtype=torch.int32, device=DEVICE),
                  torch.stack([ids, ids]),
                  torch.zeros((2, n_cand // 8), device=DEVICE))
        errs.append(compare_kernel(
            f"planted tie, {n_cand} candidates",
            types.SimpleNamespace(wald=wald, t_max=100.0), o, d, [bucket],
            128))

    # one real chunk of the tls workload: BSP order + cull as the
    # Simulator does it
    tr_, og, dg, data, cull_s = tls_chunk(tls)
    chunk = (tr_, og, dg, data)
    R = tr_.tile_rays
    errs.append(compare_kernel("tls chunk", tr_, og, dg, data, R))
    sizes = [tuple(c.shape) for _, c, _ in data]
    real = [int((t < og.shape[0] // R).sum()) for t, _, _ in data]
    log(f"[kernel] tls chunk: cull {cull_s:.3f} s, {len(data)} buckets "
        f"(rows x candidates) {sizes}, real rows {real}")
    call = lambda: tr.tile_traverse(tr_.wald, og, dg, data, tr_.t_max, R)
    plain = lambda: tr.tile_traverse_plain(tr_.wald, og, dg, data,
                                           tr_.t_max, R)
    before = tr.KERNEL.launches
    t_best, _ = call()
    sync()
    per_call = tr.KERNEL.launches - before
    if DEVICE == "cuda" and per_call != 1:
        fail(f"K1 launched {per_call} times in one tls chunk call")
    ms = cuda_ms(call, 20, queued=True)
    plain_ms = cuda_ms(plain, 3)
    ms2 = cuda_ms(call, 20, queued=True)
    call_ms = cuda_ms(call, 20)
    # the same buckets without their dummy rows (real rows come first):
    # what the dummy rows' empty blocks cost
    trimmed = [(t[:n], c[:n], b[:n]) for (t, c, b), n in zip(data, real)]
    ms_trim = cuda_ms(lambda: tr.tile_traverse(tr_.wald, og, dg, trimmed,
                                               tr_.t_max, R), 20, queued=True)
    needed, padded, nbytes = work_counts(data, t_best, tr_.t_max, R,
                                         tr_.wald.shape[0], og.shape[0])
    bound_ms, bound_by, bound_ops_ms, bound_bytes_ms = bound(needed, nbytes)
    log(f"[kernel] tls chunk: K1 {ms:.4f} / {ms2:.4f} ms (CUDA events on "
        f"a queue of 20 calls, two runs), without dummy rows "
        f"{ms_trim:.4f} ms; back-to-back "
        f"calls {call_ms:.4f} ms each (the wrapper's host path); plain "
        f"{plain_ms:.4f} ms; launches per call "
        f"{per_call}; pairs needed {needed} of {padded} without exit, bytes "
        f"{nbytes}, bound {bound_ms:.4f} ms (ops {bound_ops_ms:.4f}, bytes "
        f"{bound_bytes_ms:.4f}), {needed / (ms * 1e-3) / 1e9:.2f} G "
        f"pairs/s")
    return dict(name="tile_traverse", route="cuda",
                source="lidar_brdf_tpu_torch/kernels/csrc/tile_traverse.cu",
                replaces="lidar_brdf_tpu/kernels/traverse_pallas.py:117",
                launches=None, max_abs_err=max(errs), ms=min(ms, ms2),
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, launches_per_chunk=per_call,
                call_ms=call_ms,
                ms_without_dummy_rows=ms_trim,
                pairs_needed=needed,
                pairs_without_exit=padded, cull_s=cull_s), chunk


def compare_k2(name, wald, o, d, data, t_max, R):
    """K2 vs its plain version on one input set; returns the max |dt|."""
    import torch
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    t_k, f_k = pp.pulse_traverse(wald, o, d, data, t_max, R)
    t_p, f_p = pp.pulse_traverse_plain(wald, o, d, data, t_max, R)
    sync()
    diff = (f_k != f_p).nonzero().flatten()
    if diff.numel():
        w = wald.cpu().numpy()
        for i in diff[:5].tolist():
            oi, di = o[i].cpu().numpy(), d[i].cpu().numpy()
            log(f"[kernel] {name}: ray {i} K2 face {int(f_k[i])} "
                f"(margin {barycentric_margin(w, oi, di, int(f_k[i])):.3e})"
                f" vs plain face {int(f_p[i])} "
                f"(margin {barycentric_margin(w, oi, di, int(f_p[i])):.3e})")
        fail(f"{name}: {diff.numel()} faces differ between K2 and plain")
    hit = f_p >= 0
    if not torch.allclose(t_k[hit], t_p[hit], rtol=1e-6, atol=0.0):
        fail(f"{name}: t differs beyond rtol 1e-6")
    if not bool((t_k[~hit] == t_p[~hit]).all()):
        fail(f"{name}: a miss's t is not BIG")
    err = float((t_k[hit] - t_p[hit]).abs().max()) if bool(hit.any()) \
        else 0.0
    log(f"[kernel] {name}: {o.shape[0]} rays, {int(hit.sum())} hits, "
        f"{len(data)} buckets (rows x candidates) "
        f"{[tuple(c.shape) for _, c in data]}: faces equal, max |dt| "
        f"{err:.3e}")
    return err


def k2_work(data, n_groups, R):
    """(real pairs, padded pairs, bytes, distinct faces) of one K2 call.

    Bytes count each input the function needs once and each output once:
    the rays of groups in a bucket (24 B each), the buckets, the Wald rows
    of the distinct real candidates (48 B each) and the (t, face) of every
    ray (8 B each).
    """
    import torch
    real = padded = covered = nbytes = 0
    faces = []
    for pidx, cand in data:
        keep = (pidx >= 0) & (pidx < n_groups)
        c = cand[keep]
        real += int((c >= 0).sum()) * R
        padded += c.numel() * R
        covered += int(keep.sum())
        nbytes += pidx.numel() * 4 + cand.numel() * 4
        faces.append(c[c >= 0])
    uniq = int(torch.unique(torch.cat(faces)).numel()) if faces else 0
    nbytes += covered * R * 24 + uniq * 48 + n_groups * R * 8
    return real, padded, nbytes, uniq


def k2_tie_cases():
    """`planted_tie` laid out for K2: [(name, wald, origins, directions,
    buckets, kernel_rays)].  The tile's 128 rays as 16 groups of 8 sharing
    the tie's ladder, beside a dummy row (pidx 16 = P), in ladders of 64 and
    128 candidates (one and eight of K2's 16-candidate stages), and as one
    group of 128 rays."""
    import torch
    out = []
    for n_cand, R in ((64, 8), (128, 8), (128, 128)):
        wald, o, d, ids = (torch.from_numpy(a).to(DEVICE)
                           for a in planted_tie(n_cand))
        P = 128 // R
        bucket = (torch.arange(P + 1, dtype=torch.int32, device=DEVICE),
                  ids.repeat(P + 1, 1))
        out.append((f"K2 planted tie, {n_cand} candidates, groups of {R}",
                    wald, o, d, [bucket], R))
    return out


def k2_padding_cases():
    """K2's ladder contract: [(name, wald, origins, directions, buckets,
    kernel_rays)].  The planted tie's 64 real ids with whole blocks of 8
    of padding before real ones (one block in a row's first stage, two in
    another's third) in a hand-built bucket, which K2 must skip; and the
    tie's ladders of 128 (64 real, then padding) as a `PulseLadders`, as
    the traverser uploads them.  16 groups of 8 rays."""
    import torch
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    out = []
    for n_cand in (64, 128):
        wald, o, d, ids = (torch.from_numpy(a).to(DEVICE)
                           for a in planted_tie(n_cand))
        pidx = torch.arange(16, dtype=torch.int32, device=DEVICE)
        if n_cand == 128:
            out.append(("K2 tail-padded ladders", wald, o, d,
                        pp.PulseLadders([(pidx, ids.repeat(16, 1))]), 8))
            continue
        gap = torch.full((8,), -1, dtype=torch.int32, device=DEVICE)
        rows = torch.stack([torch.cat([ids[:8], gap, ids[8:], gap, gap]),
                            torch.cat([gap, ids[:40], gap, gap, ids[40:]])])
        out.append(("K2 interior padding, hand-built bucket", wald, o, d,
                    [(pidx, rows.repeat(8, 1))], 8))
    return out


def als_chunk(als):
    """One real `als` chunk, culled and permuted as `Simulator._prep` does
    it: (simulator, traverser, origins, directions, `PulseLadders`, host
    cull seconds)."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = als
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    if not sim.use_pulse:
        fail("the auto rule did not pick the ladders for the als scene")
    n = min(ALS_CHUNK, rays.num_pulses)
    t0 = time.perf_counter()
    sl, data, _ = sim._prep(host_rays(head(rays, n)), 0, n, n)
    cull_s = time.perf_counter() - t0
    return (sim, sim.traverser, sl.origin.reshape(-1, 3).contiguous(),
            sl.direction.reshape(-1, 3).contiguous(), data, cull_s)


def tls_pulse_chunk(tls):
    """The `tls` workload's one chunk on the pulse ladders, culled and
    permuted as `Simulator._prep` does it (scan order): (traverser,
    origins, directions, buckets, cull seconds)."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = tls
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE, use_pulse=True)
    n = rays.num_pulses
    t0 = time.perf_counter()
    sl, data, _ = sim._prep(host_rays(rays), 0, n, n)
    cull_s = time.perf_counter() - t0
    return (sim.traverser, sl.origin.reshape(-1, 3).contiguous(),
            sl.direction.reshape(-1, 3).contiguous(), data, cull_s)


def launches_in(kernel, call) -> int:
    """Launches of ``kernel`` (a `CudaLibrary`) in one ``call()``."""
    before = kernel.launches
    call()
    sync()
    return kernel.launches - before


def phase_k2_vs_plain(als):
    """K2 against its plain version on every input, timed on the `als`
    chunk.  Returns (the Simulator, K2's record, the chunk: traverser,
    origins, directions, buckets)."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    errs = []

    def case(name, scene, o, d, R, group=1):
        tt = pp.PulseLadderTraverser(scene, rays_per_pulse=R, group=group,
                                     device=DEVICE)
        data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=500.0)
        errs.append(compare_k2(name, tt.wald, put(o), put(d), data,
                               tt.t_max, tt.kernel_rays))
        return data

    boxes = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    o, d = fan_rays(16)                                 # 64 pulses of 4
    for group in (1, 4):
        case(f"K2 fan over boxes, group {group}", boxes, o, d, 4, group)
    # tests/test_pallas.py:208-236: grazing fan, fat ladders
    rough, og, dg = grazing_fan()
    data = case("K2 grazing fan", rough, og, dg, 2)
    if max(c.shape[1] for _, c in data) < 64:
        fail("the grazing fan made no fat ladder")
    # the last two pulses padded as Simulator pads a chunk, group 4
    o2, d2 = o.copy(), d.copy()
    o2[-8:], d2[-8:] = 1e10, 0.0
    case("K2 padded chunk", boxes, o2, d2, 4, 4)
    # a tie across two blocks of 8 (and two stages at 128 candidates);
    # padding inside ladders, and padding at their tail
    for name, wald, ot, dt, data, R in k2_tie_cases() + k2_padding_cases():
        errs.append(compare_k2(name, wald, ot, dt, data, 100.0, R))

    # one real als chunk, culled and permuted as Simulator._prep does it;
    # its `PulseLadders` name the uncovered tail, which K2 fills itself
    sim, tr_, og, dg, data, cull_s = als_chunk(als)
    n = og.shape[0] // tr_.rays_per_pulse
    R = tr_.kernel_rays
    errs.append(compare_k2("K2 als chunk", tr_.wald, og, dg, data,
                           tr_.t_max, R))
    call = lambda: pp.pulse_traverse(tr_.wald, og, dg, data, tr_.t_max, R)
    plain = lambda: pp.pulse_traverse_plain(tr_.wald, og, dg, data,
                                            tr_.t_max, R)
    per_call = launches_in(pp.KERNEL, call)
    if DEVICE == "cuda" and per_call != 1:
        fail(f"K2 launched {per_call} times in one als chunk call")
    ms = cuda_ms(call, 20, queued=True)
    plain_ms = cuda_ms(plain, 3)
    ms2 = cuda_ms(call, 20, queued=True)
    call_ms = cuda_ms(call, 20)
    real, padded, nbytes, uniq = k2_work(data, og.shape[0] // R, R)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(real, nbytes)
    log(f"[kernel] als chunk ({n} pulses x {R} rays, "
        f"{tr_.wald.shape[0]} faces): cull {cull_s:.3f} s; K2 "
        f"{ms:.4f} / {ms2:.4f} ms (CUDA events on a queue of 20 calls, two "
        f"runs), back-to-back calls {call_ms:.4f} ms each, plain "
        f"{plain_ms:.4f} ms, launches per call {per_call}, uncovered groups "
        f"{data.uncovered}, real pairs {real} of {padded} padded, {uniq} "
        f"distinct faces, bytes {nbytes}, bound {bound_ms:.4f} ms (ops "
        f"{ops_ms:.4f}, bytes {bytes_ms:.4f}), "
        f"{real / (min(ms, ms2) * 1e-3) / 1e9:.2f} G real pairs/s")
    return sim, dict(
        name="pulse_traverse", route="cuda",
        source="lidar_brdf_tpu_torch/kernels/csrc/pulse_traverse.cu",
        replaces="lidar_brdf_tpu/kernels/pulse_pallas.py:114",
        launches=None, max_abs_err=max(errs), ms=min(ms, ms2),
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, launches_per_chunk=per_call, call_ms=call_ms,
        pairs_real=real, pairs_padded=padded, bytes=nbytes,
        cull_s=cull_s), (tr_, og, dg, data)


def phase_traverser_choice(tls, als, k1, als_sim):
    """K1, K2 and K4 on the same pulses of both scenes: device ms and host
    cull seconds (K4 culls nothing: its scene's pack seconds instead, once
    a scene).  Figures only; the auto rule stays the JAX package's."""
    from lidar_brdf_tpu_torch.geom.packet import pack_scene
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator, bsp_order

    def k4(scene, bvh, rays):
        """K4 on ``rays`` in scan order, no cull: (queued ms, pack s)."""
        t0 = time.perf_counter()
        packed = pack_scene(scene.to(DEVICE), bvh)
        sync()
        pack_s = time.perf_counter() - t0
        o = rays.origin.reshape(-1, 3).contiguous()
        d = rays.direction.reshape(-1, 3).contiguous()
        ms = cuda_ms(lambda: kpk.packet_traverse(*packed, o, d), K4_REPS,
                     queued=True)
        return ms, pack_s

    out = {}
    # tls chunk: K1 figures from phase 2; K2 on ladders in scan order
    scene, rays = tls[0], tls[4]
    n = rays.num_pulses
    t2, og, dg, data, cull2 = tls_pulse_chunk(tls)
    k2 = lambda: pp.pulse_traverse(t2.wald, og, dg, data, t2.t_max,
                                   t2.kernel_rays)
    ms2 = cuda_ms(k2, 20)
    ms4, pack4 = k4(scene, tls[1], rays)
    out["tls"] = dict(faces=scene.num_faces, pulses=n, k1_ms=k1["ms"],
                      k1_cull_s=k1["cull_s"], k2_ms=ms2, k2_cull_s=cull2,
                      k4_ms=ms4, k4_cull_s=0.0, k4_pack_s=pack4,
                      k2_queued_ms=cuda_ms(k2, 20, queued=True),
                      k2_launches_per_call=launches_in(pp.KERNEL, k2),
                      k2_buckets=[tuple(c.shape) for _, c in data])
    # als sub-chunk: K1 on BSP order as the tile Simulator orders it, K2
    # on ladders in scan order
    scene, bvh, cfg, mats, rays = als
    sub = head(rays, min(ALS_SUB_PULSES, rays.num_pulses))
    n = sub.num_pulses
    sim1 = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                     device=DEVICE, use_pulse=False)
    t0 = time.perf_counter()
    host = host_rays(sub)
    order = bsp_order(sub, sim1.block_pulses)
    host1 = {k: v[order] for k, v in host.items()}
    sl1, data1, _ = sim1._prep(host1, 0, n, n)
    cull1 = time.perf_counter() - t0
    t1 = sim1.traverser
    o1 = sl1.origin.reshape(-1, 3).contiguous()
    d1 = sl1.direction.reshape(-1, 3).contiguous()
    ms1 = cuda_ms(lambda: tr.tile_traverse(t1.wald, o1, d1, data1, t1.t_max,
                                           t1.tile_rays), 10)
    t0 = time.perf_counter()
    sl2, data2, _ = als_sim._prep(host, 0, n, n)
    cull2 = time.perf_counter() - t0
    t2 = als_sim.traverser
    o2 = sl2.origin.reshape(-1, 3).contiguous()
    d2 = sl2.direction.reshape(-1, 3).contiguous()
    ms2 = cuda_ms(lambda: pp.pulse_traverse(t2.wald, o2, d2, data2, t2.t_max,
                                            t2.kernel_rays), 20)
    ms4, pack4 = k4(scene, bvh, sub)
    out["als"] = dict(faces=scene.num_faces, pulses=n, k1_ms=ms1,
                      k1_cull_s=cull1, k2_ms=ms2, k2_cull_s=cull2,
                      k4_ms=ms4, k4_cull_s=0.0, k4_pack_s=pack4,
                      k1_buckets=[tuple(c.shape) for _, c, _ in data1],
                      k2_buckets=[tuple(c.shape) for _, c in data2])
    for name, r in out.items():
        log(f"[choice] {name} ({r['faces']} faces, {r['pulses']} pulses): "
            f"K1 {r['k1_ms']:.4f} ms + cull {r['k1_cull_s']:.3f} s; "
            f"K2 {r['k2_ms']:.4f} ms + cull {r['k2_cull_s']:.3f} s; "
            f"K4 {r['k4_ms']:.4f} ms, no cull (pack {r['k4_pack_s']:.3f} s)")
    r = out["tls"]
    log(f"[choice] tls K2 (buckets {r['k2_buckets']}): "
        f"{r['k2_launches_per_call']} launch(es) per call; back-to-back "
        f"calls {r['k2_ms']:.4f} ms, CUDA events on a queue of 20 calls "
        f"{r['k2_queued_ms']:.4f} ms")
    return out


KERNELS = ("K1", "K2", "K4", "K5", "K6")  # the scans' and steps' kernels


def traversal_libs() -> dict:
    """The scans' and steps' kernels' `CudaLibrary` by id: the traversals,
    the beam cull and the table gradient's scatter-add."""
    from lidar_brdf_tpu_torch.kernels import cull
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import scatter
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    return {"K1": tr.KERNEL, "K2": pp.KERNEL, "K4": kpk.KERNEL,
            "K5": cull.KERNEL, "K6": scatter.KERNEL}


def phase_forward(name, workload, warm_pulses, per_chunk, **sim_kw):
    """One forward scan at full width, after a warm run on the first
    ``warm_pulses`` pulses: through `api.simulate`, or through a
    `Simulator` built with ``sim_kw`` when given.  The traversal kernels'
    launch counts are set to 0 just before the timed run and read just
    after: each kernel of ``per_chunk`` ({id: launches per chunk}) must
    have launched that often per chunk, every other one not."""
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.kernels import cull
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = workload
    n_rays = rays.num_pulses * rays.rays_per_pulse

    def scan(r, stats=None):
        if not sim_kw:
            return api.simulate(scene, cfg, materials=mats, bvh=bvh, rays=r,
                                device=DEVICE, stats=stats)
        return Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                         device=DEVICE, **sim_kw).run(r, stats=stats)

    t0 = time.perf_counter()
    scan(head(rays, warm_pulses))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()          # what every scan's wall holds of it
    Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg, device=DEVICE,
              **sim_kw)
    setup_s = time.perf_counter() - t0
    stats = {}
    sync()
    base = peak_reset()
    libs = traversal_libs()
    for lib in libs.values():                   # main path starts here
        lib.launches = 0
    reads = cull.READBACKS
    t0 = time.perf_counter()
    cloud = scan(rays, stats)
    wall = time.perf_counter() - t0
    launches = {k: lib.launches for k, lib in libs.items()}
    reads = cull.READBACKS - reads
    memory = peak_read(base)
    m = cloud.mask
    n_pts = int(m.sum())
    inten = cloud.intensity[m]
    log(f"[{name}] {n_rays} rays, {scene.num_faces} faces, L = "
        f"{cfg.max_returns}: {n_pts} valid points "
        f"({int((cloud.return_number[m] == 1).sum())} second returns); "
        f"warm run ({warm_pulses} pulses) {warm_s:.3f} s, timed run "
        f"{wall:.3f} s = {n_rays / wall:.0f} rays/s wall-clock; order "
        f"{stats['order_s']:.3f} s, cull {stats['cull_s']:.3f} s, "
        f"device {stats['device_s']:.3f} s, readback "
        f"{stats['readback_s']:.3f} s; a Simulator's construction (in the "
        f"wall, outside the split) {setup_s:.3f} s; launches {launches}; the "
        f"cull's host reads {reads}; device memory {fmt_memory(memory)}")
    chunks = -(-rays.num_pulses // cfg.chunk_pulses)
    want = {k: per_chunk.get(k, 0) * chunks for k in KERNELS}
    if DEVICE == "cuda" and launches != want:
        fail(f"the {name} forward scan launched {launches}: expected "
             f"{want} ({chunks} chunks)")
    if n_pts <= 0:
        fail(f"the {name} forward scan produced no points")
    if not (bool(torch.isfinite(inten).all()) and bool((inten >= 0).all())):
        fail(f"{name} intensities are not finite and non-negative")
    if not bool(torch.isfinite(cloud.position[m]).all()):
        fail(f"{name} positions are not finite")
    return launches, cloud, dict(
        rays=n_rays, faces=scene.num_faces, points=n_pts, wall_s=wall,
        rays_per_s=n_rays / wall, launches=launches, cull_readbacks=reads,
        sim_setup_s=setup_s,
        **memory, **stats)


def peak_reset():
    """Device bytes allocated now, after resetting the peak counter (None
    off the card)."""
    import torch
    if DEVICE != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_read(base) -> dict:
    """{base_bytes, peak_bytes}: the bytes allocated when `peak_reset` ran
    and `torch.cuda.max_memory_allocated()` since (None off the card)."""
    import torch
    if base is None:
        return dict(base_bytes=None, peak_bytes=None)
    torch.cuda.synchronize()
    return dict(base_bytes=base, peak_bytes=torch.cuda.max_memory_allocated())


def fmt_memory(m: dict) -> str:
    if m["peak_bytes"] is None:
        return "not measured (no card)"
    peak, base = m["peak_bytes"], m["base_bytes"]
    return (f"peak {peak:,} B, {peak - base:,} B above the {base:,} B held "
            f"before the scan")


def compare_clouds(what, g, c, bathymetric=False, analytic=False):
    """Card cloud ``g`` vs CPU cloud ``c``, point by point: the card reads
    back compacted (the valid slots in slot order), so both are compared
    after `compact_host`.  On a
    bathymetric scan the bottom returns' intensities are held to rtol 1e-2
    (atol 1e-20): the decay's exponent divides by the sine of the in-water
    angle, which the card's and the CPU's arccos and sine give within a
    few ulp of an ill-conditioned point for near-vertical rays.  With
    ``analytic``, the scan angles must agree to 4 ulp of 90; the analytic
    models take cos() of the angle in degrees (the reference's quirk), so
    where the two angles differ the intensity's tolerance gains the
    first-order term 2 |tan(a)| |da| (as `tests/test_torch_analytic.py`
    holds the port to JAX)."""
    import numpy as np
    import torch
    g, c = g.compact_host(), c.compact_host()
    if g.capacity != c.capacity:
        fail(f"card vs CPU ({what}): {g.capacity} points against "
             f"{c.capacity}")
    for k in ("mask", "comp_id", "return_number"):
        if not torch.equal(getattr(g, k), getattr(c, k)):
            fail(f"card vs CPU ({what}): {k} differs")
    if not torch.allclose(g.position, c.position, rtol=0, atol=1e-4):
        fail(f"card vs CPU ({what}): positions differ beyond 1e-4")
    if analytic:
        a = c.scan_angle_rank.double()
        da = (g.scan_angle_rank.double() - a).abs()
        if float(da.max()) > 4 * float(np.spacing(np.float32(90.0))):
            fail(f"card vs CPU ({what}): scan angles differ by "
                 f"{float(da.max()):.3e}")
        ic, ig = c.intensity.double(), g.intensity.double()
        err = (ig - ic).abs()
        tol = ic.abs() * (1e-4 + 2.0 * torch.tan(a).abs() * da)
        if not bool((err <= tol).all()):
            rel = (err / ic.abs().clamp(min=1e-30))[da == 0]
            fail(f"card vs CPU ({what}): {int((err > tol).sum())} "
                 f"intensities beyond the tolerance; max rel err where "
                 f"the angles agree "
                 f"{float(rel.max()) if rel.numel() else 0.0:.3e}, "
                 f"{int((da > 0).sum())} angles differ")
    bottom = ((c.asprs == 2) & (c.return_number >= 1) if bathymetric
              else torch.zeros_like(c.mask))
    if not analytic and not (
            torch.allclose(g.intensity[~bottom], c.intensity[~bottom],
                           rtol=1e-4, atol=0)
            and torch.allclose(g.intensity[bottom], c.intensity[bottom],
                               rtol=1e-2, atol=1e-20)):
        fail(f"card vs CPU ({what}): intensity differs beyond its rtol")
    m = c.mask
    log(f"[card-vs-cpu] {what}: {int(m.sum())} points "
        f"({int((c.return_number[m] == 1).sum())} second returns) "
        f"equal; max |dpos| "
        f"{float((g.position - c.position).abs().max()):.3e}, max "
        f"|dI| {float((g.intensity - c.intensity).abs().max()):.3e}")


def pad_tiles(o, d):
    """Rays (N, 3) padded to whole 128-ray tiles (origin 1e10, direction
    0), as the first K4 took them (the parent tree's, in `--k4-chunk`)."""
    import torch
    pad = (-o.shape[0]) % 128
    if pad:
        o = torch.cat([o, o.new_full((pad, 3), 1e10)])
        d = torch.cat([d, d.new_zeros((pad, 3))])
    return o.contiguous(), d.contiguous()


def once_ms(fn) -> float:
    """Milliseconds of one ``fn()``: CUDA events around it on the card, the
    host clock in a CPU rehearsal."""
    import torch
    sync()
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def compare_k4(name, packed, o, d, active=None, width=None):
    """K4 vs its plain version on rays ``o``/``d`` with the mask
    ``active`` (None: every ray) in packets of ``width`` (None: `PACKET`):
    faces equal, t equal bit for bit, every packet's walk as long, the rows
    of ``steps`` past the walked packets untouched by both.  Returns
    (steps (K, 2) of the K packets walked: node steps and leaf steps, the
    plain version's ms for the call, the max |dt| over the rays that hit
    in both)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    width = kpk.PACKET if width is None else width
    rows = kpk.packets(o.shape[0], width)
    steps_k = torch.full((rows, 2), -1, dtype=torch.int32, device=o.device)
    steps_p = steps_k.clone()
    t_k, f_k = kpk.packet_traverse(*packed, o, d, steps_k, active=active,
                                   width=width)
    out = {}
    plain_ms = once_ms(lambda: out.setdefault("p", kpk.packet_traverse_plain(
        *packed, o, d, steps_p, active=active, width=width)))
    t_p, f_p = out["p"]
    sync()
    what = f"{name}, {'masked' if active is not None else 'all rays'}, " \
        f"packets of {width}"
    diff = (f_k != f_p).nonzero().flatten()
    if diff.numel():
        fail(f"{what}: {diff.numel()} faces differ between K4 and plain "
             f"(first rays {diff[:5].tolist()})")
    hit = (f_k >= 0) & (f_p >= 0)
    err = float((t_k[hit] - t_p[hit]).abs().max()) if bool(hit.any()) \
        else 0.0
    if not torch.equal(t_k, t_p):
        fail(f"{what}: t not bit-equal between K4 and plain (max |dt| over "
             f"hits {err:.3e})")
    if not torch.equal(steps_k, steps_p):
        fail(f"{what}: walk lengths differ between K4 and plain")
    n_act = o.shape[0] if active is None else int(active.sum())
    walked = int((steps_k[:, 0] >= 0).sum())
    if walked != kpk.packets(n_act, width) or \
            not bool((steps_k[walked:] == -1).all()):
        fail(f"{what}: {walked} packets walked for {n_act} active rays")
    if active is not None and not bool((f_k[~active] == -1).all()):
        fail(f"{what}: an inactive ray was given a hit")
    steps = steps_k[:walked]
    log(f"[kernel] {what}: {o.shape[0]} rays ({n_act} active, {walked} "
        f"packets), {int(hit.sum())} hits: faces equal, max |dt| "
        f"{err:.3e}, t equal bit for bit; node steps "
        f"{int(steps[:, 0].sum())} (leaves {int(steps[:, 1].sum())}), "
        f"longest walk {int(steps[:, 0].max()) if walked else 0}; plain "
        f"{plain_ms:.1f} ms")
    return steps, plain_ms, err


def k4_walks(packed, o, d, active=None):
    """The walk lengths both K4 bounds count, from K4 itself: 128-ray tiles
    over every ray (what the first K4 walked) and each active ray alone
    (width 1).  Returns (tile steps (T, 2), solo steps (A, 2))."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    n = o.shape[0]
    n_act = n if active is None else int(active.sum())
    tile = torch.zeros((kpk.packets(n, 128), 2), dtype=torch.int32,
                       device=o.device)
    kpk.packet_traverse(*packed, o, d, tile, width=128)
    solo = torch.zeros((n, 2), dtype=torch.int32, device=o.device)
    kpk.packet_traverse(*packed, o, d, solo, active=active, width=1)
    sync()
    return tile, solo[:n_act]


def k4_ops(steps, lanes: int = 1) -> int:
    """f32 operations of walks: a box test at an internal node, a
    Moller-Trumbore test at a leaf, on ``lanes`` rays a step."""
    node, leaf = int(steps[:, 0].sum()), int(steps[:, 1].sum())
    return lanes * ((node - leaf) * OPS_BOX + leaf * OPS_TRI)


def k4_bound(tile_steps, solo_steps, n_rays, n_active) -> dict:
    """Both bounds of one K4 call, in ms.  ``work_ms``: what these inputs
    need, the sum over the rays the call answers of each one's solo walk
    (`k4_walks`) x its operations; ``yardstick_ms``: the first K4's
    128-ray tiles over every ray x 128 lanes (the figure PRs 6-9 held K4
    against, one figure for old and new times); ``bytes_ms``: 32 bytes an
    answered ray (rays in, (t, face) out) and 9 an inactive one (its mask
    byte and the miss written), the node and triangle records that rays
    share not counted.  ``bound_ms`` = max(work, bytes)."""
    work_ms = k4_ops(solo_steps) / H100_F32_OPS_PER_S * 1e3
    yard_ms = k4_ops(tile_steps, 128) / H100_F32_OPS_PER_S * 1e3
    nbytes = 32 * n_active + 9 * (n_rays - n_active)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return dict(bound_ms=max(work_ms, bytes_ms),
                bound_by="operations" if work_ms >= bytes_ms else "bytes",
                work_ms=work_ms, yardstick_ms=yard_ms, bytes_ms=bytes_ms,
                solo_node_steps=int(solo_steps[:, 0].sum()),
                solo_leaf_steps=int(solo_steps[:, 1].sum()),
                tile_node_steps=int(tile_steps[:, 0].sum()),
                tile_leaf_steps=int(tile_steps[:, 1].sum()))


def grazing_fan():
    """`tests/test_pallas.py:208-236`'s grazing fan over a rough terrain:
    (scene, origins, directions), 256 rays from 3 m up."""
    import numpy as np
    from lidar_brdf_tpu_torch.io import synthetic
    rough = synthetic.rough_terrain(np.random.default_rng(1234),
                                    num_tris=20_000, half=30.0)
    az = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    el = np.linspace(-0.25, -0.02, 16)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    dg = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                   np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    dg = (dg / np.linalg.norm(dg, axis=1, keepdims=True)).astype(np.float32)
    og = np.tile(np.array([0.0, 3.0, 0.0], np.float32), (dg.shape[0], 1))
    return rough, og, dg


def water_workload(als):
    """The topo-bathymetric `als` configuration: the `als` terrain
    (component 0, STONE, ASPRS 2) under a water plane at y = 0 over the
    same 1 km square (`ground_plane(half=500, cells=64)`: component 1,
    WATER, ASPRS 9; the relief spans +-6 m, so about half the pulses meet
    water first); the `als` sensor at 532 nm, bathymetric, water height 0,
    3 returns, `table_at(532)`; the flight's first WATER_PULSES pulses (the
    flight plan over this scene's box is the `als` one)."""
    import numpy as np
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.types import (SURFACE_TERRAIN,
                                                 SURFACE_WATER, as_numpy)
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    terrain, _, cfg, _, rays = als
    wv, wf = synthetic.ground_plane(half=500.0, y=0.0, cells=WATER_CELLS)
    tv, tf = as_numpy(terrain.vertices), as_numpy(terrain.faces)
    scene = synthetic.scene_from_arrays(
        np.concatenate([tv, wv]), np.concatenate([tf, wf + len(tv)]),
        comp_of_face=np.repeat(np.int32([0, 1]), [len(tf), len(wf)]),
        num_components=2, comp_material=np.int32([7, 6]),
        comp_surface=np.int32([SURFACE_TERRAIN, SURFACE_WATER]),
        comp_asprs=np.int32([2, 9]))
    scene = api.attach_face_neighbors(scene)
    bvh = api.build_scene_bvh(scene)
    cfg = cfg.with_(bathymetric=True, water_height=0.0,
                    wavelength_nm=(532, 532), max_returns=3)
    mats = MaterialLibrary.default().table_at(532)
    rays = head(rays, min(WATER_PULSES, rays.num_pulses))
    log(f"[setup] water: {scene.num_faces} faces ({len(wf)} water), "
        f"{rays.num_pulses} pulses x {rays.rays_per_pulse} rays, L = "
        f"{cfg.max_returns}, bathymetric at 532 nm")
    return scene, bvh, cfg, mats, rays


def capture_walk(packed):
    """A packet walk over ``packed`` that records what it is handed:
    (walk, list of (origins (N, 3), directions (N, 3), active (N,) or
    None)).  A tree whose walk takes no mask (before K4's packets, as
    `--k4-chunk` finds the parent) never hands it one."""
    from lidar_brdf_tpu_torch.geom import packet as gp
    seen = []

    def walk(o, d, active=None):
        seen.append((o.reshape(-1, 3), d.reshape(-1, 3),
                     None if active is None else active.reshape(-1)))
        kw = {} if active is None else dict(active=active)
        return gp.intersect_packed_scene(packed, o, d, **kw)

    return walk, seen


def water_levels(water):
    """The water scan's first chunk once more through a `Simulator` whose
    packet walk records what it is handed (`capture_walk`), in the chunk's
    bucket order as on the main path: per bounce level, (packed scene,
    origins, directions, active mask or None)."""
    from lidar_brdf_tpu_torch.geom.packet import pack_scene
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = water
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    packed = pack_scene(sim.scene, sim.bvh)
    sim.packet_fn, seen = capture_walk(packed)
    n = min(cfg.chunk_pulses, rays.num_pulses)
    sl, data, _ = sim._prep(host_rays(head(rays, n)), 0, n, n)
    sim.run_chunk(sl, 0, data)
    sync()
    if len(seen) != cfg.max_returns - 1:
        fail(f"the water chunk walked {len(seen)} bounce levels, not "
             f"{cfg.max_returns - 1}")
    return [(packed, *x) for x in seen]


def phase_water(water):
    """The topo-bathymetric scan through `api.simulate`, timed after a
    warm run: K2 once a chunk (level 0), K4 twice (the refracted levels 1
    and 2), K1 never; it must give bottom returns (ASPRS 2 at return
    number >= 1).  Then the first chunk once more (`water_levels`): the
    walk must be handed each bounce level's active mask.  Returns
    (launches, the scan's record, the levels' (packed scene, origins,
    directions, mask), the scan's cloud)."""
    import torch
    scene, bvh, cfg, mats, rays = water
    L = cfg.max_returns
    launches, cloud, res = phase_forward(
        "water", water, min(WATER_WARM, rays.num_pulses),
        {"K2": 1, "K4": L - 1, "K5": k5_launches()})
    m = cloud.mask
    bottom = int((m & (cloud.asprs == 2) & (cloud.return_number >= 1)).sum())
    surface = int((m & (cloud.asprs == 9)).sum())
    log(f"[water] {surface} water-surface returns, {bottom} bottom returns "
        f"(ASPRS 2, return number >= 1)")
    if bottom <= 0:
        fail("the water scan gave no bottom returns")
    res.update(surface_returns=surface, bottom_returns=bottom)
    levels = water_levels(water)
    shares = []
    for k, (_, o, _, a) in enumerate(levels, 1):
        if a is None or a.shape != o.shape[:1] or a.dtype != torch.bool:
            fail(f"the walk of bounce level {k} was handed no mask")
        shares.append(int(a.sum()) / a.shape[0])
        log(f"[water] bounce level {k}: {int(a.sum())} of {a.shape[0]} "
            f"rays active ({shares[-1]:.4f})")
    res.update(active_share=shares)
    return launches, res, levels, cloud


def phase_k4_vs_plain(tls, levels):
    """K4 against its plain version, faces and t bit-equal and walks as
    long, with and without a mask: on the fan over boxes, the grazing fan
    and zero-direction padding rays at every packet width (a random mask
    from a seed), the `tls` chunk in scan order (what ``use_culled=False``
    hands it) and the water scan's level-1 and level-2 rays (their own
    masks) at `PACKET`.  A masked call under `torch.cuda.
    set_sync_debug_mode("error")`: no host sync.  Timed with CUDA events
    on the water levels (masked, the main path, and every ray) and on the
    `tls` rays, beside both bounds (`k4_bound`).  Returns K4's record (its
    time and bound on the masked level-1 rays, the main path's input)."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.geom.packet import (intersect_packed_scene,
                                                  pack_scene)
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    mask = lambda n: put(np.random.default_rng(0).random(n) < 0.6)
    boxes = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    o, d = fan_rays(64)
    og, dg = o.copy(), d.copy()
    og[1000:1100], dg[1000:1100] = 1e10, 0.0     # zero-direction padding
    dg[3000:3050] = 0.0
    rough, o2, d2 = grazing_fan()
    errs = []
    for name, scene, oo, dd in (
            ("K4 fan over boxes", boxes, o, d),
            ("K4 grazing fan", rough, o2, d2),
            ("K4 fan with zero-direction rays", boxes, og, dg)):
        packed = pack_scene(scene.to(DEVICE), api.build_scene_bvh(scene))
        for width in kpk.WIDTHS:
            for a in (None, mask(oo.shape[0])):
                errs.append(compare_k4(name, packed, put(oo), put(dd), a,
                                       width)[2])
    scene, bvh, _, _, rays = tls
    ot, dt = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    cases = [("tls", pack_scene(scene.to(DEVICE), bvh), ot, dt, None),
             ("water", *levels[0]), ("water_level2", *levels[1])]
    out = {}
    for key, packed, oo, dd, a in cases:
        compares = (a, None) if a is not None else (None, mask(oo.shape[0]))
        steps = {}
        for aa in compares:
            st, plain_ms, err = compare_k4(f"K4 {key} rays", packed, oo, dd,
                                           aa)
            steps[aa is a] = (st, plain_ms)
            errs.append(err)
        tile, solo = k4_walks(packed, oo, dd, a)
        for aa, tag in ((a, ""), (None, "_all")) if a is not None \
                else ((None, ""),):
            call = lambda: kpk.packet_traverse(*packed, oo, dd, active=aa)
            per_call = launches_in(kpk.KERNEL, call)
            if DEVICE == "cuda" and per_call != 1:
                fail(f"K4 launched {per_call} times in one call")
            ms = [cuda_ms(call, K4_REPS, queued=True) for _ in range(2)]
            n_act = oo.shape[0] if aa is None else int(aa.sum())
            st, plain_ms = steps[aa is a]
            b = k4_bound(tile, solo if aa is a else k4_walks(
                packed, oo, dd)[1], oo.shape[0], n_act)
            out[key + tag] = dict(
                rays=oo.shape[0], active=n_act, ms=min(ms), ms_runs=ms,
                plain_ms=plain_ms, node_steps=int(st[:, 0].sum()),
                leaf_steps=int(st[:, 1].sum()),
                longest_walk=int(st[:, 0].max()) if st.numel() else 0, **b)
            log(f"[kernel] K4 {key} rays{' (every ray)' if tag else ''}: "
                f"{ms[0]:.4f} / {ms[1]:.4f} ms (CUDA events on a queue of "
                f"{K4_REPS} calls, two runs), plain {plain_ms:.1f} ms; {n_act} of "
                f"{oo.shape[0]} rays walk, {out[key + tag]['node_steps']} "
                f"node steps x {kpk.PACKET} lanes "
                f"({out[key + tag]['leaf_steps']} leaves); bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}: solo walks "
                f"{b['work_ms']:.4f}, bytes {b['bytes_ms']:.4f}); the first "
                f"K4's yardstick {b['yardstick_ms']:.4f} ms (128-ray tiles, "
                f"every ray)")
    packed, oo, dd, a = levels[0]
    if DEVICE == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            intersect_packed_scene(packed, oo, dd, active=a)
        except RuntimeError as e:
            fail(f"the masked packet walk synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log("[kernel] K4 masked call under set_sync_debug_mode('error'): no "
            "host sync")
    w = out["water"]
    return dict(name="packet_traverse", route="cuda",
                source="lidar_brdf_tpu_torch/kernels/csrc/packet_traverse.cu",
                replaces="lidar_brdf_tpu/geom/packet.py:148",
                launches=None, max_abs_err=max(errs), ms=w["ms"],
                plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None, packet=kpk.PACKET,
                **out)


def k4_inputs():
    """`--k4-chunk`'s inputs: [(name, packed scene, origins, directions,
    mask or None)] for the water chunk's level-1 and level-2 rays
    (`water_levels`), the `tls` rays in scan order and the `als` chunk's
    rays (scan order, no cull)."""
    from lidar_brdf_tpu_torch.geom.packet import pack_scene
    als = als_workload(DEVICE)
    water = water_workload(als)
    levels = water_levels(water)
    del water
    tls = tls_workload(DEVICE)
    flat = lambda r: (r.origin.reshape(-1, 3).contiguous(),
                      r.direction.reshape(-1, 3).contiguous())
    scene, bvh, _, _, rays = als
    return [("water_level1", *levels[0]), ("water_level2", *levels[1]),
            ("tls", pack_scene(tls[0].to(DEVICE), tls[1]), *flat(tls[4]),
             None),
            ("als", pack_scene(scene.to(DEVICE), bvh),
             *flat(head(rays, min(ALS_CHUNK, rays.num_pulses))), None)]


def k4_chunk(reps: int = 10, inputs=None, runs: int = 3) -> dict:
    """K4 alone, for comparing two trees on one card (``python3
    chip_smoke.py --k4-chunk``, from a copy of this script in the root of
    either tree), on `k4_inputs`.  In a tree whose K4 has packet widths
    (`kernels/packet.py::WIDTHS`) at each width, with the level's mask and
    on every ray; in a tree before them, its 128-ray tiles on every ray
    (padded).  Per input and variant: launches per call, CUDA-event ms per
    call (``runs`` runs of ``reps`` queued), node and leaf steps; in a
    tree with widths also both bounds (`k4_bound`)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    widths = getattr(kpk, "WIDTHS", None)
    i32 = dict(dtype=torch.int32, device=DEVICE)
    out = dict(source=os.path.dirname(os.path.abspath(__file__)),
               widths=widths)
    for name, packed, o, d, a in inputs or k4_inputs():
        n = o.shape[0]
        rec = dict(rays=n, active=n if a is None else int(a.sum()))
        if widths is None:
            o, d = pad_tiles(o, d)
            variants = [("tile128_all", 128, lambda st: dict(steps=st))]
        else:
            variants = [(f"w{w}_{tag}", w, lambda st, aa=aa, w=w: dict(
                steps=st, active=aa, width=w))
                for w in widths
                for tag, aa in (("active", a), ("all", None))
                if tag == "all" or a is not None]
        for key, w, kw in variants:
            st = torch.full((-(-o.shape[0] // w), 2), -1, **i32)
            kpk.packet_traverse(*packed, o, d, **kw(st))
            sync()
            st = st[st[:, 0] >= 0]
            call = lambda: kpk.packet_traverse(*packed, o, d, **kw(None))
            rec[key] = dict(
                launches_per_call=launches_in(kpk.KERNEL, call),
                events_ms=[cuda_ms(call, reps, queued=True)
                           for _ in range(runs)],
                node_steps=int(st[:, 0].sum()),
                leaf_steps=int(st[:, 1].sum()))
            log(f"[k4-chunk] {name} {key}: {rec[key]}")
        if widths is not None:
            tile, solo = k4_walks(packed, o, d, a)
            rec["bound"] = k4_bound(tile, solo, n, rec["active"])
            log(f"[k4-chunk] {name} bound: {rec['bound']}")
        out[name] = rec
    return out


def water_scan(runs: int = 2) -> dict:
    """The topo-bathymetric scan alone, for comparing two trees on one card
    (``python3 chip_smoke.py --water-scan``, from a copy of this script in
    the root of either tree): the workload built once, then ``runs`` times
    a warm run and a timed scan through `api.simulate` (`phase_forward`),
    each with its wall, cull and device seconds and its launches."""
    water = water_workload(als_workload(DEVICE))
    L, P = water[2].max_returns, water[4].num_pulses
    out = dict(source=os.path.dirname(os.path.abspath(__file__)), runs=[])
    for _ in range(runs):
        out["runs"].append(phase_forward(
            "water", water, min(WATER_WARM, P),
            {"K2": 1, "K4": L - 1, "K5": k5_launches()})[2])
    return out


# ---------------------------------------------------------------------------
# phase 13: K5, the beam cull on the card, against its plain version
# ---------------------------------------------------------------------------

# f32 operations of K5's walk, counted from `kernels/csrc/beam_cull.cu`: a
# node test on its slab path (the box grown by the radius, 6; per axis the
# guarded reciprocal, 2 sub, 2 mul and the min / max of t0, t1 into the
# running bounds, 12; the accept, 4); a test that goes on to the ternary
# search adds 24 steps (m1 and m2, 6; two gaps of 23: the point 6, the
# clamp 6, 3 sub, the squares 5, sqrt, s tan and the difference; the
# compare) and the last gap with the slack (27); a listed leaf adds its
# near distance (31).  The sort of the lists is not counted.
OPS_NODE = 46
OPS_TERNARY = 24 * (6 + 2 * 23 + 1) + 27
OPS_LEAF = 31
K5_REPS = 5                     # K5 calls a CUDA-event timing
SLACK_T_MAX = 120.0             # the reach of the planted-slack beams
CHAIN_DEPTH = 120               # a tree too deep for K5's shared stacks
# The culled scans with the host cull, as PERF.md section 5 records them
# (NVIDIA H100 80GB HBM3, 700.00 W): points, and peak device bytes above
# those held before the scan (`forward`: its cold scan)
HOST_CULL_POINTS = dict(tls=117_957, als=1_041_373, water=1_563_583,
                        forward=943_660)
HOST_CULL_PEAK = dict(tls=246_635_520, als=1_434_049_024,
                      water=2_068_422_144, forward=228_982_784)


def k5_launches() -> int:
    """K5's launches a culled chunk (`kernels/cull.py::LAUNCHES`)."""
    from lidar_brdf_tpu_torch.kernels import cull
    return cull.LAUNCHES


def cull_inputs(origin, direction, rays_per_beam):
    """(float64 beams, the walk's f32 inputs) of the beams of
    ``rays_per_beam`` consecutive rays, on the rays' device."""
    from lidar_brdf_tpu_torch.geom import beamcull as bc
    from lidar_brdf_tpu_torch.kernels import cull
    beams = bc.tile_beams_torch(origin, direction, rays_per_beam)
    return beams, cull.walk_inputs(beams)


def planted_slack_beams(bvh, t_max: float = SLACK_T_MAX, device="cpu"):
    """Beam 0 wide over the whole root box (it lists every leaf); then,
    for the first six leaves, beams of zero cone along +x and radius 0.5
    whose axis passes 0.5 + (0, 0.95, 1.05) times the slack (1e-4 + 1e-5
    ``t_max``) above the leaf's box in z: the grown box's gap is 0, just
    under the slack and just over it.  Returns (the walk's f32 / u8
    tensors on ``device``, the leaves' node ids)."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch.core.types import as_numpy
    lo = np.asarray(as_numpy(bvh.node_min), np.float64)
    hi = np.asarray(as_numpy(bvh.node_max), np.float64)
    leaves = np.nonzero(np.asarray(as_numpy(bvh.node_face)) >= 0)[0][:6]
    slack = 1e-4 + 1e-5 * t_max
    c, a = [0.5 * (lo[0] + hi[0])], [[0.0, -1.0, 0.0]]
    tan, r = [4.0], [float(np.linalg.norm(hi[0] - lo[0]))]
    for n in leaves:
        mid = 0.5 * (lo[n] + hi[n])
        for k in (0.0, 0.95, 1.05):
            c.append([lo[n][0] - 1.0, mid[1], hi[n][2] + 0.5 + k * slack])
            a.append([1.0, 0.0, 0.0])
            tan.append(0.0)
            r.append(0.5)
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                 device=device)
    return (f32(c), f32(a), f32(tan), f32(r),
            torch.ones(len(c), dtype=torch.uint8, device=device)), leaves


def k5_bound(stats, n_nodes, n_beams, total):
    """(bound ms, "operations" or "bytes", ops ms, bytes ms, ops, bytes)
    of one cull: the walk's f32 operations (`cull_plain`'s counts of node
    tests, tests that reached the ternary search and listed leaves, times
    OPS_*), and its bytes read once (node records, beams) and written once
    (counts, offsets, faces and near distances)."""
    ops = (stats["node_tests"] * OPS_NODE
           + stats["ternary_tests"] * OPS_TERNARY + stats["leaves"] * OPS_LEAF)
    nbytes = n_nodes * 32 + n_beams * 33 + n_beams * 4 + (n_beams + 1) * 8 \
        + total * 8
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms,
            bytes_ms, ops, nbytes)


def same_tensors(a, b) -> bool:
    """Tensors (or nested tuples of them, and ints) equal bit for bit."""
    import torch
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(same_tensors, a, b))
    return a == b


K5_KERNELS = ("walk_", "place_", "sort_kernel", "count_kernel",
              "fill_kernel")   # K5's kernels by name (and the parent's)


def k5_options(**opts) -> dict:
    """The keywords of `beam_cull` that this tree's `kernels/cull.py`
    takes (an older tree's takes none of ``lanes``, ``capacity``,
    ``depth``)."""
    import inspect
    from lidar_brdf_tpu_torch.kernels import cull
    params = inspect.signature(cull.beam_cull).parameters
    return {k: v for k, v in opts.items() if k in params and v is not None}


def compare_k5(name, nodes, ins, t_max, *, kind=None, beams=None,
               face_box=None, pad_to=8, timed=False, host_bvh=None,
               lanes=None, capacity=None) -> dict:
    """One K5 call (`kernels/cull.py::beam_cull`, `LAUNCHES` launches) and
    the plain version on the same beams: counts, offsets, faces and near
    distances bit-equal.  ``kind`` "tile" (with the f64 ``beams`` and the
    ``face_box`` of `TileTraverser.face_boxes`) also holds the buckets and
    bounds built from either's lists equal, "pulse" the ladders, the
    permutation and the renumbered ladders.  ``lanes`` and ``capacity``
    override `cull.schedule`'s (a path or the overflow path forced).  With
    ``timed``: K5 by CUDA events and by kernel (profiler), and the port's
    host culler on the same beams (``host_bvh``).  Returns the record."""
    import torch
    from lidar_brdf_tpu_torch.io import native
    from lidar_brdf_tpu_torch.kernels import cull
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    depth = (cull.tree_depth(nodes[1], nodes[2])
             if hasattr(cull, "tree_depth") else None)
    opts = k5_options(lanes=lanes, capacity=capacity, depth=depth)
    call = lambda: cull.beam_cull(nodes, *ins, t_max, pad_to, **opts)
    before, reads = cull.KERNEL.launches, cull.READBACKS
    got = call()
    sync()
    n = cull.KERNEL.launches - before
    reads = cull.READBACKS - reads
    if DEVICE == "cuda" and n != cull.LAUNCHES:
        fail(f"K5 {name}: {n} launches in one call, not {cull.LAUNCHES}")
    stats = {}
    t0 = time.perf_counter()
    plain = cull.cull_plain(nodes, *ins, t_max, stats=stats)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for what, g, w in zip(("counts", "offsets", "faces", "near distances"),
                          got[:4], plain):
        if not same_tensors(g, w):
            fail(f"K5 {name}: {what} differ from the plain version")
    want = cull.lists_of(*plain, pad_to)
    built = []
    if kind == "tile":
        T = got.counts.shape[0]
        bk, bp = (tr.buckets_from_lists(x, T) for x in (got, want))
        built = [("buckets", bk, bp), (
            "bounds", tr.bucket_bounds_torch(face_box, bk, beams),
            tr.bucket_bounds_torch(face_box, bp, beams))]
    elif kind == "pulse":
        P = got.counts.shape[0]
        lk, lp = (pp.ladders_from_lists(x, P) for x in (got, want))
        (perm_k, lay_k), (perm_p, lay_p) = (pp.permute_ladders_torch(x, P)
                                            for x in (got, want))
        built = [("ladders", lk, lp), ("permutation", perm_k, perm_p),
                 ("layout", lay_k, lay_p),
                 ("renumbered ladders", pp.renumber_ladders_torch(lk, perm_k),
                  pp.renumber_ladders_torch(lp, perm_p))]
    for what, g, w in built:
        if not same_tensors(g, w):
            fail(f"K5 {name}: the {what} built from K5's lists differ from "
                 f"those built from the plain version's")
    T, N = got.counts.shape[0], nodes[0].shape[0]
    total = int(got.faces.shape[0])
    longest = int(got.counts.max()) if T else 0
    bound_ms, bound_by, ops_ms, bytes_ms, ops, nbytes = k5_bound(
        stats, N, T, total)
    path = (cull.schedule(T) if hasattr(cull, "schedule") else (1, None))
    rec = dict(beams=T, nodes=N, candidates=total, longest=longest,
               launches=n, readbacks=reads, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, bound_ops_ms=ops_ms,
               bound_bytes_ms=bytes_ms, ops=ops, bytes=nbytes, **stats,
               ternary_share=stats["ternary_tests"] / max(
                   stats["node_tests"], 1),
               lanes=opts.get("lanes", path[0]),
               capacity=opts.get("capacity", path[1]), depth=depth,
               overflow=getattr(got, "overflow", None))
    what = " and ".join(w for w, *_ in built) or "CSR"
    line = (f"[K5] {name}: {T} beams over {N} nodes (depth {depth}), "
            f"{total} candidates (longest list {longest}), {rec['lanes']} "
            f"lane(s) a beam, capacity {rec['capacity']}, "
            f"{rec['overflow']} beam(s) over it, {n} launches and {reads} "
            f"host read(s) a call; lists, {what} bit-equal to the plain "
            f"version; node tests "
            f"{stats['node_tests']}, {rec['ternary_share']:.4f} of them to "
            f"the ternary search")
    if timed:
        rec["ms"] = cuda_ms(call, K5_REPS)
        rec["kernels"] = device_ms_by_kernel(call, 2)
        if host_bvh is not None and native.get_lib() is not None:
            arrays = [x.cpu().numpy() for x in ins]
            t0 = time.perf_counter()
            native.cull_candidates_native(host_bvh, *arrays, t_max)
            rec["host_ms"] = (time.perf_counter() - t0) * 1e3
        rec["launch_ms"] = {k: v["ms_per_launch"]
                            for k, v in rec["kernels"].items()
                            if any(x in k for x in K5_KERNELS)}
        line += (f"; K5 {rec['ms']:.4f} ms a call (CUDA events, {K5_REPS} "
                 f"calls), plain {plain_ms:.1f} ms, host culler "
                 f"{rec.get('host_ms', float('nan')):.1f} ms, bound "
                 f"{bound_ms:.4f} ms ({bound_by}: ops {ops_ms:.4f}, bytes "
                 f"{bytes_ms:.4f}); by launch " + ", ".join(
                     f"{k} {v:.4f} ms" for k, v in rec["launch_ms"].items()))
    log(line)
    return rec


def chain_tree(depth: int, device=None):
    """(node views, walk inputs) of a threaded BVH as deep as a tree of
    2 ``depth`` + 1 nodes can be: internal node 2k has the leaf 2k + 1
    (face k, a unit box at x = k) and the rest of the chain as children,
    the last leaf is 2 ``depth``; its group stacks do not fit shared
    memory.  Beams along +x from x = -1, each a little higher and wider
    than the last (the first ten list every leaf within reach), on
    ``device`` (None: `DEVICE`)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    N = 2 * depth + 1
    box = torch.zeros((N, 6), dtype=torch.float32)
    skip = torch.full((N,), N, dtype=torch.int32)
    face = torch.full((N,), -1, dtype=torch.int32)
    for k in range(depth + 1):
        leaf = min(2 * k + 1, N - 1)
        box[leaf] = torch.tensor([k, 0.0, 0.0, k + 1.0, 1.0, 1.0])
        face[leaf] = k
        if leaf < N - 1:
            skip[leaf] = leaf + 1
            box[2 * k] = torch.tensor([k, 0.0, 0.0, depth + 1.0, 1.0, 1.0])
    device = device or DEVICE
    nodes = kpk.node_records(box.to(device), skip.to(device),
                             face.to(device))
    T = 16
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    ins = (f32([[-1.0, 0.5, 0.5 + 0.05 * t] for t in range(T)]),
           f32([[1.0, 0.0, 0.0]] * T), f32([0.002 * t for t in range(T)]),
           f32([0.1] * T), torch.ones(T, dtype=torch.uint8, device=device))
    return nodes, ins


def k5_small_cases():
    """(name, nodes, inputs, t_max, kind, beams, face_box, bvh, options)
    of the small K5 inputs: tiles of 128 rays and pulses of 4 of a fan
    over boxes, and the planted-slack beams over the same boxes and over a
    20,000-face terrain (its wide beam's list, over the scratch's
    capacity, is walked again and sorted in device memory), each on the
    path `cull.schedule` gives it; then the other path and the overflow
    path forced (``options``: `compare_k5`'s ``lanes``, ``capacity``)."""
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser
    import numpy as np
    import torch
    boxes = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    bvh = api.build_scene_bvh(boxes)
    tt = TileTraverser(boxes, tile_rays=128, device=DEVICE)
    nodes = tt.nodes(bvh)
    o, d = (torch.from_numpy(x).to(DEVICE) for x in fan_rays(64))
    out = []
    for kind, R in (("tile", 128), ("pulse", 4)):
        beams, ins = cull_inputs(o, d, R)
        out.append((f"fan over boxes, beams of {R} rays", nodes, ins, 80.0,
                    kind, beams, tt.face_boxes(bvh), bvh, {}))
    ins, _ = planted_slack_beams(bvh, SLACK_T_MAX, DEVICE)
    out.append(("planted at the slack", nodes, ins, SLACK_T_MAX, None, None,
                None, bvh, {}))
    rough = synthetic.rough_terrain(np.random.default_rng(3),
                                    num_tris=20_000, half=30.0)
    rbvh = api.build_scene_bvh(rough)
    rnodes = TileTraverser(rough, tile_rays=128, device=DEVICE).nodes(rbvh)
    rins, _ = planted_slack_beams(rbvh, SLACK_T_MAX, DEVICE)
    out.append(("planted at the slack, 20,000 faces", rnodes, rins,
                SLACK_T_MAX, None, None, None, rbvh, {}))
    out.append((f"a chain of depth {CHAIN_DEPTH}", *chain_tree(CHAIN_DEPTH),
                SLACK_T_MAX, None, None, None, None, {}))
    forced = [(0, "a thread a beam", dict(lanes=1)),
              (1, "a thread a beam", dict(lanes=1)),
              (0, "capacity 4", dict(capacity=4)),
              (1, "a thread a beam, capacity 2", dict(lanes=1, capacity=2)),
              (3, "a thread a beam", dict(lanes=1))]
    for i, what, opts in forced:
        case = out[i]
        out.append((f"{case[0]}, {what}", *case[1:8], opts))
    return out


def k5_chunk_inputs(workload, name):
    """(name, nodes, inputs, t_max, kind, beams, face_box, bvh, options)
    of one real chunk culled as `Simulator._prep` culls it: the `tls` chunk
    (BSP-ordered tiles of 640 rays) or the first chunk of an `als` or
    water scan (pulses of 10 rays, scan order)."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator, bsp_order
    scene, bvh, cfg, mats, rays = workload
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    tr_ = sim.traverser
    n = min(cfg.chunk_pulses, rays.num_pulses)
    if not sim.use_pulse:
        import torch
        order = torch.as_tensor(bsp_order(head(rays, n), sim.block_pulses),
                                device=rays.origin.device)
        o, d = (getattr(rays, k)[:n][order] for k in ("origin", "direction"))
        R = tr_.tile_rays
    else:
        o, d = rays.origin[:n], rays.direction[:n]
        R = tr_.kernel_rays
    beams, ins = cull_inputs(o.reshape(-1, 3).contiguous(),
                             d.reshape(-1, 3).contiguous(), R)
    kind = "pulse" if sim.use_pulse else "tile"
    return (name, tr_.nodes(bvh), ins, sim.t_max, kind, beams,
            None if sim.use_pulse else tr_.face_boxes(bvh), bvh, {})


def k5_chunk(tls=None, als=None) -> dict:
    """K5 alone (``python3 chip_smoke.py --k5-chunk``): built, launched on
    a one-node tree, held bit for bit against its plain version on the
    small inputs (each path, and the overflow path, where this tree's
    `beam_cull` can be told) and on the `tls` and `als` chunks, and timed
    on those two beside the port's host culler and the bound."""
    out = dict(source=os.path.dirname(os.path.abspath(__file__)))
    for case in k5_small_cases():
        if case[8] and not k5_options(**case[8]):
            continue                       # an older tree: no such path
        out[case[0]] = compare_k5(*case[:4], kind=case[4], beams=case[5],
                                  face_box=case[6], **case[8])
    for name, wl in (("tls chunk", tls or tls_workload(DEVICE)),
                     ("als chunk", als or als_workload(DEVICE))):
        case = k5_chunk_inputs(wl, name)
        out[name] = compare_k5(*case[:4], kind=case[4], beams=case[5],
                               face_box=case[6], timed=True,
                               host_bvh=case[7])
    return out


def phase_k5_vs_plain(tls, als, water):
    """13: K5 against its plain version bit for bit (lists, then the
    buckets and bounds or ladders and permutation built from them) on a
    fan over boxes, beams planted at the slack of a box (on both paths and
    the overflow path), the `tls` chunk, one `als` chunk and the water
    scene's level-0 chunk; timed by CUDA events and by launch on the `tls`
    and `als` chunks beside the port's host culler and the bound.  Returns
    K5's record for the kernels line."""
    res = k5_chunk(tls, als)
    case = k5_chunk_inputs(water, "water level-0 chunk")
    res["water level-0 chunk"] = compare_k5(
        *case[:4], kind=case[4], beams=case[5], face_box=case[6],
        timed=True)
    t, a = res["tls chunk"], res["als chunk"]
    return dict(name="beam_cull", route="cuda",
                source="lidar_brdf_tpu_torch/kernels/csrc/beam_cull.cu",
                replaces="native/lidar_native.cpp:392 (lbt_cull, host C++; "
                         "not a TPU kernel)",
                launches=None, max_abs_err=0.0, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None,
                launches_per_chunk=k5_launches(), host_ms=t.get("host_ms"),
                launch_ms=t.get("launch_ms"), als_ms=a["ms"],
                als_launch_ms=a.get("launch_ms"), als_plain_ms=a["plain_ms"],
                als_host_ms=a.get("host_ms"), als_bound_ms=a["bound_ms"],
                als_bound_by=a["bound_by"],
                water_ms=res["water level-0 chunk"]["ms"],
                water_launch_ms=res["water level-0 chunk"].get("launch_ms"),
                overflow={
                    k: res[k]["overflow"] for k in
                    ("tls chunk", "als chunk", "water level-0 chunk")},
                cases={k: {x: y for x, y in v.items() if x != "kernels"}
                       for k, v in res.items() if isinstance(v, dict)})


def water_over_ground():
    """`tests/test_water.py`'s scene (ground at y = 0, water at y = 2, 30 m
    squares) and ALS scan (linear, 30 m up, 2 rays a pulse, 3 returns,
    bathymetric at 532 nm, no shiny-surface error)."""
    import numpy as np
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    from lidar_brdf_tpu_torch.core.types import SURFACE_TERRAIN, SURFACE_WATER
    from lidar_brdf_tpu_torch.io import synthetic
    gv, gf = synthetic.ground_plane(half=30.0, y=0.0)
    wv, wf = synthetic.ground_plane(half=30.0, y=2.0)
    scene = synthetic.scene_from_arrays(
        np.concatenate([gv, wv]), np.concatenate([gf, wf + len(gv)]),
        comp_of_face=np.repeat(np.int32([0, 1]), [len(gf), len(wf)]),
        num_components=2, comp_material=np.int32([7, 6]),
        comp_surface=np.int32([SURFACE_TERRAIN, SURFACE_WATER]),
        comp_asprs=np.int32([2, 9]))
    cfg = SensorConfig(
        lidar_type=LiDARType.AERIAL_LINEAR, als_position=(0.0, 30.0, 0.0),
        als_fov_horizontal=30.0, als_speed=10.0, als_scan_frequency=4,
        als_pulse_frequency=200, rays_per_pulse=2, max_returns=3,
        chunk_pulses=2048, shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=False, bathymetric=True,
        water_height=2.0, wavelength_nm=(532, 532))
    return scene, cfg


# ---------------------------------------------------------------------------
# scenes on disk: an OBJ text writer for this script and the tests (the
# packages have none), the `tls` city and a water scene as OBJ/MTL/PNG
# directories with sidecars, and a measured-BRDF directory of `.bsdf` files
# ---------------------------------------------------------------------------

def write_obj(path, groups, mtllib=None):
    """One `.obj` of ``groups``: (name, usemtl or None, vertices (V, 3),
    faces (F, 3 or 4) into them, uvs (V, 2) or None), 1-based indices.
    Coordinates are written with 9 significant digits, so float32 values
    read back exactly."""
    import numpy as np
    lines = [f"mtllib {mtllib}"] if mtllib else []
    base = 0
    for name, mtl, verts, faces, uvs in groups:
        lines.append(f"o {name}")
        if mtl:
            lines.append(f"usemtl {mtl}")
        lines += [f"v {x:.9g} {y:.9g} {z:.9g}"
                  for x, y, z in np.asarray(verts, np.float32).tolist()]
        if uvs is not None:
            lines += [f"vt {u:.9g} {v:.9g}"
                      for u, v in np.asarray(uvs, np.float32).tolist()]
        for face in (np.asarray(faces) + base + 1).tolist():
            lines.append("f " + " ".join(
                f"{i}/{i}" if uvs is not None else f"{i}" for i in face))
        base += len(verts)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _component(scene_np, comp):
    """A component's vertices (local), faces into them."""
    import numpy as np
    faces = scene_np["faces"][scene_np["face_comp"] == comp]
    used, local = np.unique(faces, return_inverse=True)
    return scene_np["vertices"][used], local.reshape(faces.shape)


def city_scene_dir(scene, root, seed: int = 0):
    """The `tls` city (`synthetic.city_scene`: ground component 0, one box
    of 12 faces per building) as a scene directory.  `ground.obj`: the
    ground as triangles, textured (`map_Kd`); `buildings.obj`: one object
    per building, each box face a quad, in three kinds named for the
    material and ASPRS hints (`building_wall_*` STONE / BUILDING,
    `building_metal_roof_*` IRON / BUILDING, `tower_glass_*`
    CRYSTAL_GLASS / no hint) under three `.mtl` materials, two of them
    textured, and sidecars: `buildings.LiDARMaterial` maps "metal" to
    ALUMINIUM, `buildings.semanticASPRS` "tower" to BUILDING.  Returns the
    directory."""
    import numpy as np
    from lidar_brdf_tpu_torch.io.png import write_png
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    s = scene.numpy()
    for name in ("asphalt", "brick", "glass"):
        write_png(os.path.join(root, f"{name}.png"),
                  rng.random((32, 32, 3)).astype(np.float32))
    with open(os.path.join(root, "city.mtl"), "w") as fh:
        fh.write("newmtl asphalt\nKd 0.3 0.3 0.3\nmap_Kd asphalt.png\n"
                 "newmtl brick\nKd 0.6 0.4 0.3\nKs 0.1 0.1 0.1\nNs 10\n"
                 "map_Kd brick.png\n"
                 "newmtl metal\nKd 0.5 0.5 0.55\nKs 0.6 0.6 0.6\nNs 40\n"
                 "newmtl glass\nKd 0.2 0.3 0.4\nKs 0.9 0.9 0.9\nNs 80\n"
                 "map_Kd glass.png\n")
    v, f = _component(s, 0)
    write_obj(os.path.join(root, "ground.obj"),
              [("ground_terrain", "asphalt", v, f, v[:, [0, 2]] / 16.0)],
              mtllib="city.mtl")
    kinds = (("building_wall_{}", "brick"), ("building_metal_roof_{}",
                                               "metal"),
             ("tower_glass_{}", "glass"))
    groups = []
    for comp in range(1, int(s["face_comp"].max()) + 1):
        v, f = _component(s, comp)
        quads = np.concatenate([f[0::2], f[1::2, 2:]], axis=1)
        name, mtl = kinds[comp % 3]
        uv = np.stack([(v[:, 0] + v[:, 2]) / 6.0, v[:, 1] / 6.0], axis=1)
        groups.append((name.format(comp), mtl, v, quads, uv))
    write_obj(os.path.join(root, "buildings.obj"), groups,
              mtllib="city.mtl")
    with open(os.path.join(root, "buildings.LiDARMaterial"), "w") as fh:
        fh.write("# keyword -> LiDAR material\nmetal ALUMINIUM\n")
    with open(os.path.join(root, "buildings.semanticASPRS"), "w") as fh:
        fh.write("tower BUILDING\n")
    return root


def water_scene_dir(root):
    """`water_over_ground`'s scene as files: `ground.obj` (ground at y = 0,
    30 m square, "ground_terrain"), `water.obj` (water at y = 2, "water_
    surface", so WATER / ASPRS WATER and the water flag) and two boxes in
    `boxes.obj` that stand out of the water ("building_wall_*").  Returns
    the directory."""
    import numpy as np
    from lidar_brdf_tpu_torch.io import synthetic
    os.makedirs(root, exist_ok=True)
    gv, gf = synthetic.ground_plane(half=30.0, y=0.0, cells=2)
    wv, wf = synthetic.ground_plane(half=30.0, y=2.0)
    write_obj(os.path.join(root, "ground.obj"),
              [("ground_terrain", None, gv, gf, None)])
    write_obj(os.path.join(root, "water.obj"),
              [("water_surface", None, wv, wf, None)])
    boxes = [synthetic.box((x, 2.5, 5.0), (2.0, 2.5, 2.0))
             for x in (-10.0, 10.0)]
    write_obj(os.path.join(root, "boxes.obj"),
              [(f"building_wall_{i}", None, v, f, None)
               for i, (v, f) in enumerate(boxes)])
    return root


def brdf_dir(root):
    """A measured-BRDF directory: one `synthetic_tensor_file` per
    measured material that `REFLECTIVITY_MEASURED_MAP` names, under its
    "_spec" name, each with its own seed.  Returns the directory."""
    from lidar_brdf_tpu_torch.io.materials import REFLECTIVITY_MEASURED_MAP
    from lidar_brdf_tpu_torch.io.rgl_bsdf import synthetic_tensor_file
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(sorted(set(REFLECTIVITY_MEASURED_MAP.values()))):
        synthetic_tensor_file(os.path.join(root, f"{name}_spec.bsdf"),
                              diffuse=0.2 + 0.04 * i, seed=i)
    return root


def all_models_case(library):
    """A ground of 16 x 16 cells of 5 m whose cells take eight components
    in a checker pattern (component i on material i), and ``library`` with
    material i on analytic model i (i < 8: ideal specular ... Oren-Nayar,
    and ZOHDI, which gives 0), so that an ANALYTIC scan from 9 m up picks
    every model id."""
    import dataclasses
    import numpy as np
    from lidar_brdf_tpu_torch.io import synthetic
    gv, gf = synthetic.ground_plane(half=40.0, y=0.0, cells=16)
    cell = np.arange(len(gf)) % (16 * 16)
    comp = ((cell // 16) + 3 * (cell % 16)) % 8
    scene = synthetic.scene_from_arrays(
        gv, gf, comp_of_face=comp, num_components=8,
        comp_material=np.arange(8), comp_asprs=np.full(8, 2))
    model = library.brdf_model.copy()
    model[:8] = np.arange(8, dtype=np.int32)
    return scene, dataclasses.replace(library, brdf_model=model)


def phase_card_vs_cpu():
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch.io import obj as obj_mod
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    mats = MaterialLibrary.default().table_at(1064)

    def both(scene, bvh, cfg, rays, **kw):
        return [Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                          device=dev, **kw).run(rays.to(dev))
                for dev in (DEVICE, "cpu")]

    scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=4)
    bvh = api.build_scene_bvh(scene)
    for L, radius in ((1, 0.001), (2, 0.1)):
        # 90 x 40 degrees keeps every tile beam narrow (no packet walk)
        cfg = SensorConfig(
            lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
            tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
            tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
            tls_resolution_horizontal=32, tls_resolution_vertical=16,
            rays_per_pulse=2, pulse_radius=radius, max_returns=L,
            chunk_pulses=512, shading_mode=ShadingMode.MEASURED)
        rays = api.build_rays(cfg, scene, device="cpu")
        compare_clouds(f"TLS L={L}", *both(scene, bvh, cfg, rays))

    # ALS zig-zag over a small rough terrain through the pulse ladders
    scene = synthetic.rough_terrain(np.random.default_rng(0),
                                    num_tris=20_000, half=30.0)
    bvh = api.build_scene_bvh(scene)
    for L in (1, 2):
        cfg = SensorConfig(
            lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 40.0, 0.0),
            als_fov_horizontal=70.0, als_fov_vertical=4.5,
            als_scan_frequency=40, als_pulse_frequency=2560, als_speed=30.0,
            max_range=400.0, rays_per_pulse=4, pulse_radius=0.3,
            max_returns=L, chunk_pulses=1024,
            shading_mode=ShadingMode.MEASURED,
            include_shiny_surface_error=True)
        rays = head(api.build_rays(cfg, scene, device="cpu"), 2048)
        before = pp.KERNEL.launches
        clouds = both(scene, bvh, cfg, rays, use_pulse=True)
        if DEVICE == "cuda" and pp.KERNEL.launches <= before:
            fail("the ALS card-vs-CPU run launched K2 no time")
        compare_clouds(f"ALS L={L}", *clouds)
    # the same pulses with no cull: the packet walk (K4) for every ray
    before = kpk.KERNEL.launches
    clouds = both(scene, bvh, cfg, rays, use_culled=False)
    if DEVICE == "cuda" and kpk.KERNEL.launches <= before:
        fail("the ALS use_culled=False card-vs-CPU run launched K4 no time")
    compare_clouds(f"ALS L={L}, use_culled=False", *clouds)

    # the water scene of tests/test_water.py: ALS, bathymetric at 532 nm,
    # 3 returns; the hybrid (K1 level 0, K4 bounces)
    scene, cfg = water_over_ground()
    bvh = api.build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(532)
    rays = api.build_rays(cfg, scene, device="cpu")
    before = kpk.KERNEL.launches
    clouds = [Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        device=dev).run(rays.to(dev))
              for dev in (DEVICE, "cpu")]
    if DEVICE == "cuda" and kpk.KERNEL.launches <= before:
        fail("the water card-vs-CPU run launched K4 no time")
    compare_clouds("water L=3", *clouds, bathymetric=True)

    # ANALYTIC shading with every model id in play (tile path, L = 2)
    scene, lib = all_models_case(MaterialLibrary.default())
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
        tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
        tls_resolution_horizontal=32, tls_resolution_vertical=16,
        rays_per_pulse=2, pulse_radius=0.1, max_returns=2,
        chunk_pulses=512, shading_mode=ShadingMode.ANALYTIC)
    rays = api.build_rays(cfg, scene, device="cpu")
    mats = lib.table_at(1064)
    clouds = [Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        device=dev).run(rays.to(dev))
              for dev in (DEVICE, "cpu")]
    picked = torch.unique(mats.brdf_model[
        scene.comp_material[clouds[1].comp_id[clouds[1].mask].long()]
        .long()])
    if picked.numel() < 8:
        fail(f"the ANALYTIC card-vs-CPU scan hit model ids "
             f"{picked.tolist()} only")
    compare_clouds("ANALYTIC L=2, model ids 0-7", *clouds, analytic=True)

    # a water scene loaded from OBJ files, bathymetric at 532 nm, L = 3
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_water_obj")
    scene = obj_mod.load_scene_dir(water_scene_dir(root))
    shutil.rmtree(root)
    _, cfg = water_over_ground()
    bvh = api.build_scene_bvh(scene)
    mats = MaterialLibrary.default().table_at(532)
    rays = api.build_rays(cfg, scene, device="cpu")
    before = kpk.KERNEL.launches
    clouds = [Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                        device=dev).run(rays.to(dev))
              for dev in (DEVICE, "cpu")]
    if DEVICE == "cuda" and kpk.KERNEL.launches <= before:
        fail("the OBJ water card-vs-CPU run launched K4 no time")
    compare_clouds("OBJ water L=3", *clouds, bathymetric=True)


def k3_host_steps(x, reps: int = 10_000) -> dict:
    """Host microseconds of each step of K3's wrapper (`kernels/smoke.py::
    affine_smoke`) on ``x``, each step alone over ``reps`` calls, beside
    the whole wrapper and `torch.addcmul`.  The launch step enqueues K3
    ``reps`` times through the C function (not counted as launches)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import smoke
    from lidar_brdf_tpu_torch.kernels.cuda_build import raw_stream
    one = torch.ones((), device=x.device)
    two = torch.full((), 2.0, device=x.device)
    y = torch.empty_like(x)
    fn = smoke.KERNEL.launcher()
    px, py, n, idx = x.data_ptr(), y.data_ptr(), x.numel(), x.get_device()
    s = raw_stream(idx)
    steps = {
        "check": lambda: (x.is_cuda and x.dtype is torch.float32
                          and x.is_contiguous()),
        "empty_like": lambda: torch.empty_like(x),
        "numel+data_ptr": lambda: (x.numel(), x.data_ptr(), y.data_ptr()),
        "raw_stream": lambda: raw_stream(x.get_device()),
        "launcher": smoke.KERNEL.launcher,
        "ctypes launch": lambda: fn(px, py, n, s),
    }
    out = {k: host_us(f, reps) for k, f in steps.items()}
    out["sum of steps"] = sum(out.values())
    out["affine_smoke"] = host_us(lambda: smoke.affine_smoke(x), reps)
    out["torch.addcmul"] = host_us(lambda: torch.addcmul(one, x, two), reps)
    return out


def k3_inputs():
    """K3's inputs on `DEVICE`: the bench's (8, 128) tile, K3_BIG + 3
    random elements, and `torch.addcmul`'s 0-d operands 1 and 2."""
    import torch
    tile = torch.arange(8 * 128, dtype=torch.float32,
                        device=DEVICE).reshape(8, 128)
    gen = torch.Generator().manual_seed(3)
    big = (torch.randn(K3_BIG + 3, generator=gen) * 1e3).to(DEVICE)
    return (tile, big, torch.ones((), device=DEVICE),
            torch.full((), 2.0, device=DEVICE))


def phase_k3_vs_plain():
    """K3 against its plain version, bit for bit, on the bench's (8, 128)
    tile, on K3_BIG elements and on sizes that are no multiple of 4 (the
    float4 body's scalar tail, and a misaligned view).  On the tile and at
    K3_BIG: CUDA-event ms over back-to-back calls and host us per call,
    beside the plain version and one PyTorch call (`torch.addcmul`), K3
    and `addcmul` taken in turns.  (Device times by the profiler and the
    wrapper's steps come in `phase_profiles`, after the timed phases.)"""
    import torch
    from lidar_brdf_tpu_torch.kernels import smoke
    tile, big, one, two = k3_inputs()
    for x in (big[:K3_BIG + 3], big[:1001], big[1:1002], big[:3]):
        if not torch.equal(smoke.affine_smoke(x), smoke.affine_smoke_plain(x)):
            fail(f"K3 differs from 2x + 1 on {x.numel()} elements at "
                 f"offset {x.storage_offset()}")
    out = {}
    for name, x in (("tile", tile), ("1M", big[:K3_BIG])):
        y = smoke.affine_smoke(x)
        want = smoke.affine_smoke_plain(x)
        lib = torch.addcmul(one, x, two)
        sync()
        if not torch.equal(y, want):
            fail(f"K3 differs from 2x + 1 on the {name} input")
        if not torch.equal(lib, want):
            fail(f"torch.addcmul differs from 2x + 1 on the {name} input")
        k3 = lambda: smoke.affine_smoke(x)
        ref = lambda: torch.addcmul(one, x, two)
        ms = [cuda_ms(f, 1000) for f in (k3, ref, k3, ref)]
        us = [host_us(f, 2000) for f in (k3, ref, k3, ref)]
        out[name] = dict(
            err=float((y - want).abs().max()), elements=x.numel(),
            ms=min(ms[0], ms[2]), library_ms=min(ms[1], ms[3]),
            ms_runs=ms[0::2], library_ms_runs=ms[1::2],
            plain_ms=cuda_ms(lambda: smoke.affine_smoke_plain(x), 1000),
            host_us=min(us[0], us[2]), library_host_us=min(us[1], us[3]))
    n = tile.numel()
    bound_ms, bound_by, ops_ms, bytes_ms = (
        max(2 * n / H100_F32_OPS_PER_S, 8 * n / H100_BYTES_PER_S) * 1e3,
        "bytes", 2 * n / H100_F32_OPS_PER_S * 1e3,
        8 * n / H100_BYTES_PER_S * 1e3)
    for name, r in out.items():
        log(f"[kernel] K3 {name} ({r['elements']} f32): equal to 2x + 1 "
            f"bit for bit; CUDA events (1000 calls, two runs each): K3 "
            f"{r['ms_runs'][0]:.5f} / {r['ms_runs'][1]:.5f} ms, "
            f"torch.addcmul {r['library_ms_runs'][0]:.5f} / "
            f"{r['library_ms_runs'][1]:.5f} ms, plain (x * 2 + 1) "
            f"{r['plain_ms']:.5f} ms; host per call (2000 calls) K3 "
            f"{r['host_us']:.3f} us, torch.addcmul "
            f"{r['library_host_us']:.3f} us")
    log(f"[kernel] K3 tile bound {bound_ms:.7f} ms ({bound_by}: {8 * n} "
        f"bytes; ops {ops_ms:.7f} ms): the launch, not the card, bounds it")
    return dict(
        name="affine_smoke", route="cuda",
        source="lidar_brdf_tpu_torch/kernels/csrc/affine_smoke.cu",
        replaces="bench.py:94", launches=None,
        max_abs_err=max(r["err"] for r in out.values()),
        ms=out["tile"]["ms"], plain_ms=out["tile"]["plain_ms"],
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=out["tile"]["library_ms"], ms_1m=out["1M"]["ms"],
        plain_ms_1m=out["1M"]["plain_ms"],
        library_ms_1m=out["1M"]["library_ms"],
        host_us=out["tile"]["host_us"],
        library_host_us=out["tile"]["library_host_us"],
        host_us_1m=out["1M"]["host_us"],
        library_host_us_1m=out["1M"]["library_host_us"])


def phase_profiles(chunk, k1, k3, k2_chunk_data, k2):
    """Measurements that would disturb the timed phases, taken last: K1's
    device time on phase 2's `tls` chunk, K2's on its `als` chunk (as the
    Simulator calls it, K2 writing the uncovered groups, and with the
    wrapper's two output fills instead), K3's and `torch.addcmul`'s on the
    tile and at K3_BIG by `torch.profiler`, and each step of K3's wrapper
    on the host over 10,000 calls.  Adds them to the ``k1``, ``k2`` and
    ``k3`` records."""
    import torch
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import smoke
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    t2, o2, d2, data2 = k2_chunk_data
    for key, data in (("", data2), ("_with_fills", pp.PulseLadders(data2))):
        split = k2_device_split(lambda: pp.pulse_traverse(
            t2.wald, o2, d2, data, t2.t_max, t2.kernel_rays), 20)
        k2["device_ms" + key] = split["k2_ms"]
        k2["fills_device_ms" + key] = split["fills_ms"]
        log(f"[profile] K2 als chunk{key.replace('_', ' ')}: device K2 "
            f"{fmt_ms(split['k2_ms'])} ms, fills {fmt_ms(split['fills_ms'])}"
            f" ms per call; by kernel {split['kernels']}")
    tr_, og, dg, data = chunk
    by = device_ms_by_kernel(lambda: tr.tile_traverse(
        tr_.wald, og, dg, data, tr_.t_max, tr_.tile_rays), 20)
    k1["device_ms"] = device_ms(by, "tile_traverse_kernel")
    log(f"[profile] K1 tls chunk: device {fmt_ms(k1['device_ms'])} ms per "
        f"call (by kernel {by}; CUDA events on a queue, fills included: "
        f"{k1['ms']:.4f} ms)")
    tile, big, one, two = k3_inputs()
    for suffix, x in (("", tile), ("_1m", big[:K3_BIG])):
        k3["device_ms" + suffix] = device_ms(device_ms_by_kernel(
            lambda: smoke.affine_smoke(x), 200))
        k3["library_device_ms" + suffix] = device_ms(device_ms_by_kernel(
            lambda: torch.addcmul(one, x, two), 200))
        log(f"[profile] K3 {x.numel()} f32: device K3 "
            f"{fmt_ms(k3['device_ms' + suffix])} ms, torch.addcmul "
            f"{fmt_ms(k3['library_device_ms' + suffix])} ms per call")
    k3["host_steps_us"] = steps = (k3_host_steps(tile) if DEVICE == "cuda"
                                   else {})
    log("[profile] K3 tile, host us per step over 10,000 calls: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))


def count_syncs(fn) -> int | None:
    """Host syncs the card reports while ``fn()`` runs (PyTorch's sync
    debug mode); None in a CPU rehearsal."""
    import warnings
    import torch
    if DEVICE != "cuda":
        fn()
        return None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def check_grads(name, ws):
    """One loss + backward through the bench's `step_loss`: finite
    gradients, each with a non-zero entry.  Returns (loss, max |g| each)."""
    import torch
    from lidar_brdf_tpu_torch import bench
    loss, grads = bench.loss_and_grads(ws)
    out = {}
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            fail(f"{name} step: the {k} gradient is not finite")
        if not bool((g != 0).any()):
            fail(f"{name} step: the {k} gradient is all zero")
        out[k] = float(g.abs().max())
    if not (math.isfinite(loss) and loss > 0):
        fail(f"{name} step: loss {loss} is not finite and positive")
    return loss, out


def capture_k6(fn) -> list:
    """[(idx, g, n_cells)] of each table-gradient scatter ``fn()`` makes
    through `physics/brdf.py::TableRead` (copies; the wrapper runs as
    usual)."""
    from lidar_brdf_tpu_torch.physics import brdf
    calls = []
    real = brdf.table_scatter_add

    def spy(idx, g, n_cells):
        calls.append((idx.clone(), g.clone(), n_cells))
        return real(idx, g, n_cells)

    brdf.table_scatter_add = spy
    try:
        fn()
    finally:
        brdf.table_scatter_add = real
    return calls


def step_kernels(by: dict) -> dict:
    """Device ms of one profiled step (`device_ms_by_kernel`): all of it,
    K6's, and autograd's index backwards' (ms, launches); Nones in a CPU
    rehearsal."""
    if not by:
        return dict(device_ms=None, k6_ms=None, index_backward_ms=None,
                    index_backward_launches=None)
    ib = {k: v for k, v in by.items() if "indexing_backward" in k}
    return dict(device_ms=device_ms(by),
                k6_ms=device_ms(by, "table_scatter_kernel"),
                index_backward_ms=device_ms(ib) if ib else 0.0,
                index_backward_launches=sum(round(v["launches"])
                                            for v in ib.values()))


def phase_fwd_bwd(name, ws, kernel):
    """Training steps on one culled workload: for each `BENCH_GRADS`
    setting, launch counts set to 0 just before its timed steps and read
    just after (``kernel`` once a step, the other traversal kernel not, K6
    once a step but under ``none``); gradient check; BENCH_GRADS split;
    device ms by kernel of a profiled ``table`` and ``full`` step (the
    ``table`` step launches no index backward).  Returns (the ``full``
    steps' launches, results, one step's K6 inputs)."""
    from lidar_brdf_tpu_torch import bench
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import scatter
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    loss, gmax = check_grads(name, ws)
    calls = capture_k6(lambda: bench.loss_and_grads(ws))
    if len(calls) != 1:
        fail(f"one {name} step scattered the table gradient {len(calls)} "
             f"times, not once")
    split, launches, kernels = {}, {}, {}
    syncs = prof = None
    other = "K2" if kernel == "K1" else "K1"
    for grads in ("none", "table", "table+origin", "full"):
        step, _ = bench.make_step(ws, grads)
        step()                                   # warm
        sync()
        if grads == "full":
            syncs = count_syncs(step)
        tr.KERNEL.launches = pp.KERNEL.launches = 0
        scatter.KERNEL.launches = 0
        t = bench.time_steps(step, DEVICE, STEP_ITERS, warm=1)
        n = launches[grads] = dict(K1=tr.KERNEL.launches,
                                   K2=pp.KERNEL.launches,
                                   K6=scatter.KERNEL.launches)
        want = {kernel: STEP_ITERS + 1, other: 0,
                "K6": 0 if grads == "none" else STEP_ITERS + 1}
        if DEVICE == "cuda" and n != want:
            fail(f"the {name} fwd+bwd steps ({grads}) launched {n}: "
                 f"expected {want} ({STEP_ITERS + 1} steps)")
        if grads == "full":
            prof = bench.profile_step(step, DEVICE)
        if grads in ("table", "full"):
            kernels[grads] = step_kernels(device_ms_by_kernel(step, 1))
        split[grads] = dict(step_s=t["step_s"],
                            rays_per_s=ws.num_rays / t["step_s"])
    if DEVICE == "cuda" and kernels["table"]["index_backward_launches"]:
        fail(f"the {name} table step launched "
             f"{kernels['table']['index_backward_launches']} index "
             f"backwards: the table's reads must have none")
    full = split["full"]
    log(f"[fwd+bwd] {name}: {ws.rays.num_pulses} pulses x "
        f"{ws.rays.rays_per_pulse} rays, {ws.scene.num_faces} faces, L = "
        f"{ws.cfg.max_returns}, cull {ws.cull_s:.3f} s; loss {loss:.6e}, "
        f"max |g| {gmax}; full step {full['step_s'] * 1e3:.2f} ms = "
        f"{full['rays_per_s']:.0f} rays/s fwd+bwd; host syncs per step "
        f"{syncs}; launches in 1 warm + {STEP_ITERS} timed steps {launches}")
    log(f"[fwd+bwd] {name} BENCH_GRADS split (ms per step): " + ", ".join(
        f"{k} {v['step_s'] * 1e3:.2f}" for k, v in split.items()))
    for grads, k in kernels.items():
        share = (k["k6_ms"] / k["device_ms"] if k["device_ms"] else None)
        log(f"[fwd+bwd] {name} profiled {grads} step: device "
            f"{fmt_ms(k['device_ms'])} ms, K6 {fmt_ms(k['k6_ms'])} ms "
            f"(share {'not measured' if share is None else f'{share:.4f}'}"
            f"), index backwards {fmt_ms(k['index_backward_ms'])} ms in "
            f"{k['index_backward_launches']} launches")
    if prof is not None:
        prof["busy"] = prof["device_s"] / full["step_s"]
        log(f"[fwd+bwd] {name} profiled full step: device "
            f"{prof['device_s'] * 1e3:.2f} ms, busy share {prof['busy']:.3f} "
            f"of the timed step (profiled wall {prof['wall_s'] * 1e3:.2f} "
            f"ms); top kernels (ms, calls): "
            + "; ".join(f"{n} {ms:.3f} x{c}" for n, ms, c in prof["top"]))
    return launches["full"], dict(
        rays=ws.num_rays, faces=ws.scene.num_faces, cull_s=ws.cull_s,
        loss=loss, grad_max=gmax, syncs_per_step=syncs, launches=launches,
        split=split, profile=prof, kernels=kernels), calls[0]


def phase_training(als):
    """The port's bench path: K3 pre-flight, the full-width `tls` step, the
    `als` step over phase 4's terrain.  Returns (K3 launches, the `tls`
    and `als` full steps' launches {K1, K2, K6}, results, each step's K6
    inputs {"tls", "als": (idx, g, n_cells)})."""
    from lidar_brdf_tpu_torch import bench
    from lidar_brdf_tpu_torch.kernels import smoke
    smoke.KERNEL.launches = 0                  # the bench path starts here
    bench.kernel_smoke(DEVICE)
    k3 = smoke.KERNEL.launches
    if DEVICE == "cuda" and k3 != 1:
        fail(f"the bench's pre-flight launched K3 {k3} times")
    t0 = time.perf_counter()
    spec = bench.CONFIGS["tls"]
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "tls", TLS_PULSES, TLS_RAYS_PULSE, spec["max_returns"], "city",
        TLS_TRIS)
    ws = bench.cull(scene, bvh, cfg, rays, mats, "tile", DEVICE)
    log(f"[setup] fwd+bwd tls workload built in "
        f"{time.perf_counter() - t0:.2f} s")
    tls_n, tls, tls_k6 = phase_fwd_bwd("tls", ws, "K1")
    del ws
    scene, bvh, cfg, mats, rays = als
    n = min(ALS_STEP_PULSES, rays.num_pulses)
    ws = bench.cull(scene, bvh, cfg.with_(chunk_pulses=n),
                    head(rays, n).to("cpu"), mats, "pulse", DEVICE)
    als_n, als_res, als_k6 = phase_fwd_bwd("als", ws, "K2")
    return (k3, tls_n, als_n, dict(tls=tls, als=als_res),
            dict(tls=tls_k6, als=als_k6))


def grad_cases(kind):
    """[(what, scene, cfg, rays)] of the card-vs-CPU gradient check at
    phase 5's sizes, L = 1 and 2: the TLS scan over boxes for ``kind="tile"``,
    the ALS scan over rough terrain for ``kind="pulse"``."""
    import numpy as np
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import (LiDARType, SensorConfig,
                                                  ShadingMode)
    from lidar_brdf_tpu_torch.io import synthetic
    cases = []
    if kind == "tile":
        scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                             num_boxes=4)
        for L, radius in ((1, 0.001), (2, 0.1)):
            cfg = SensorConfig(
                lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
                tls_position=(0.0, 9.0, 0.0), tls_fov_horizontal=90.0,
                tls_fov_vertical=40.0, tls_middle_angle_vertical=-45.0,
                tls_resolution_horizontal=32, tls_resolution_vertical=16,
                rays_per_pulse=2, pulse_radius=radius, max_returns=L,
                chunk_pulses=512, shading_mode=ShadingMode.MEASURED)
            cases.append((f"TLS L={L}", scene, cfg,
                          api.build_rays(cfg, scene, device="cpu")))
        return cases
    scene = synthetic.rough_terrain(np.random.default_rng(0),
                                    num_tris=20_000, half=30.0)
    for L in (1, 2):
        cfg = SensorConfig(
            lidar_type=LiDARType.AERIAL_ZIGZAG, als_position=(0.0, 40.0, 0.0),
            als_fov_horizontal=70.0, als_fov_vertical=4.5,
            als_scan_frequency=40, als_pulse_frequency=2560, als_speed=30.0,
            max_range=400.0, rays_per_pulse=4, pulse_radius=0.3,
            max_returns=L, chunk_pulses=2048,
            shading_mode=ShadingMode.MEASURED,
            include_shiny_surface_error=True)
        cases.append((f"ALS L={L}", scene, cfg,
                      head(api.build_rays(cfg, scene, device="cpu"), 2048)))
    return cases


def compare_grads(what, scene, cfg, rays, kind):
    """The bench's loss and gradients on `DEVICE` and on the CPU, from the
    same cull: loss to rtol 1e-5, each gradient finite and within
    atol 1e-4 * max|g| of the CPU's.  Returns max |dg| / max |g| each."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api, bench
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    mats = MaterialLibrary.default().table_at(1064)
    bvh = api.build_scene_bvh(scene)
    res = [bench.loss_and_grads(bench.cull(scene, bvh, cfg, rays, mats, kind,
                                           dev))
           for dev in (DEVICE, "cpu")]
    (lg, gg), (lc, gc) = res
    if not (np.isfinite(lc) and lc > 0 and abs(lg - lc) <= 1e-5 * lc):
        fail(f"card vs CPU grads ({what}): loss {lg} vs {lc}")
    errs = {}
    for k in gc:
        scale = float(gc[k].abs().max())
        err = float((gg[k].cpu() - gc[k]).abs().max())
        if not (bool(torch.isfinite(gg[k]).all()) and scale > 0
                and err <= 1e-4 * scale):
            fail(f"card vs CPU grads ({what}): {k} max |dg| {err:.3e} "
                 f"of max |g| {scale:.3e}")
        errs[k] = err / scale
    log(f"[card-vs-cpu grads] {what}: loss {lg:.6e} vs {lc:.6e}; "
        f"max |dg| / max |g| {errs}")
    return errs


def water_loss_and_grads(dev):
    """The summed masked intensity of `water_over_ground`'s scan (every
    level on the packet walk, K4 on the card) and its gradients w.r.t.
    the BRDF table, the ray origins, the vertices and ``peak_power``, on
    ``dev`` (rays made on the host); with the records' winners and
    mask."""
    import dataclasses
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.types import RayBundle, as_numpy
    from lidar_brdf_tpu_torch.geom.packet import make_packet_traverser
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    from lidar_brdf_tpu_torch.physics.returns import (SimScalars,
                                                      simulate_returns)
    from lidar_brdf_tpu_torch.runtime.simulate import simulate_chunk
    from lidar_brdf_tpu_torch.utils import noise as noise_mod
    scene, cfg = water_over_ground()
    bvh = api.build_scene_bvh(scene)
    rays = api.build_rays(cfg, scene, device="cpu").to(dev)
    min_y = float(as_numpy(scene.vertices)[:, 1].min())
    scene = scene.to(dev)
    mats = MaterialLibrary.default().table_at(532).to(dev)
    scalars = SimScalars.from_config(cfg, min_y, dev)
    noise = noise_mod.make_sim_noise(cfg.seed, device=dev)
    walk = make_packet_traverser(scene, bvh)
    xs = [x.detach().clone().requires_grad_(True)
          for x in (mats.brdf_table, rays.origin, scene.vertices,
                    scalars.peak_power)]
    table, origin, verts, peak = xs
    r = RayBundle(origin=origin, direction=rays.direction,
                  gps_time=rays.gps_time)
    cloud = simulate_chunk(
        dataclasses.replace(scene, vertices=verts),
        dataclasses.replace(mats, brdf_table=table), r, noise,
        dataclasses.replace(scalars, peak_power=peak), cfg,
        scene_has_water=True, packet_fn=walk)
    loss = torch.where(cloud.mask, cloud.intensity,
                       torch.zeros_like(cloud.intensity)).sum()
    loss.backward()
    with torch.no_grad():
        rec = simulate_returns(scene, mats, rays, noise, scalars, cfg,
                               scene_has_water=True, packet_fn=walk)[0]
    names = ("brdf_table", "origin", "vertices", "peak_power")
    return (float(loss.detach()),
            {k: x.grad.cpu() for k, x in zip(names, xs)},
            rec.winner_ray.cpu(), rec.mask.cpu())


def compare_water_grads():
    """Card vs CPU gradients through the water scan (532 nm, bathymetric,
    L = 3): the loss to rtol 1e-5; the vertex and ``peak_power``
    gradients within atol 1e-4 * max|g|; the table gradient zero on both
    (the scan's lookups sit on the tables' clipped retro peak).  A pulse's
    parallel rays reach the flat bottom at the same t in real arithmetic,
    so where the card's and the CPU's rounding pick different winners the
    pulse's origin gradient moves between its rays: origins are compared
    ray by ray on the pulses with the same winners and summed over each
    pulse's rays everywhere (within atol 1e-4 * max|g|)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    before = kpk.KERNEL.launches
    (lg, gg, wg, mg), (lc, gc, wc, mc) = [water_loss_and_grads(dev)
                                          for dev in (DEVICE, "cpu")]
    if DEVICE == "cuda" and kpk.KERNEL.launches <= before:
        fail("the water gradient run launched K4 no time")
    if not (lc > 0 and abs(lg - lc) <= 1e-5 * lc) or not torch.equal(mg, mc):
        fail(f"card vs CPU water grads: loss {lg} vs {lc}, masks "
             f"{'equal' if torch.equal(mg, mc) else 'differ'}")
    errs = {}
    for k, g in gg.items():
        if not bool(torch.isfinite(g).all()):
            fail(f"card vs CPU water grads: {k} is not finite")
    if gg["brdf_table"].any() or gc["brdf_table"].any():
        fail("card vs CPU water grads: a table gradient is not zero")
    flip = (mc & (wg != wc)).any(dim=0)
    same = ~flip
    pairs = dict(vertices=(gg["vertices"], gc["vertices"]),
                 peak_power=(gg["peak_power"], gc["peak_power"]),
                 origin=(gg["origin"][same], gc["origin"][same]),
                 origin_per_pulse=(gg["origin"].sum(1), gc["origin"].sum(1)))
    for k, (a, b) in pairs.items():
        scale = float(gc["origin" if k.startswith("origin") else k]
                      .abs().max())
        err = float((a - b).abs().max()) if a.numel() else 0.0
        if not (scale > 0 and err <= 1e-4 * scale):
            fail(f"card vs CPU water grads: {k} max |dg| {err:.3e} of max "
                 f"|g| {scale:.3e}")
        errs[k] = err / scale
    log(f"[card-vs-cpu grads] water L=3 (532 nm, bathymetric): loss "
        f"{lg:.6e} vs {lc:.6e}; winners differ on {int(flip.sum())} of "
        f"{flip.numel()} pulses; max |dg| / max |g| {errs}")
    return errs


def phase_card_vs_cpu_grads():
    """Card vs CPU gradients of the bench's loss at phase 5's sizes, and
    through the water scan."""
    for kind in ("tile", "pulse"):
        for case in grad_cases(kind):
            compare_grads(*case, kind)
    compare_water_grads()


FILES_WAVELENGTHS = (1064, 1065)    # phase 9's sweep: tables re-bound


def phase_files(tls):
    """Phase 9: the `tls` cell's city as a scene on disk, through the
    port's CLI on the card, to PLY files.  Writes the city as OBJ/MTL/PNG
    with sidecars (`city_scene_dir`), a measured-BRDF directory of `.bsdf`
    files (`brdf_dir`) and the `tls` config swept over FILES_WAVELENGTHS;
    runs `cli.main(["simulate", ...])` with the launch counts set to 0 just
    before (K1 once per chunk per wavelength, K2 and K4 never); then, in
    process: the parse, the `.lidar_cache.npz` write and reload of each
    file (the reload must not parse and must give the same arrays), the
    BVH, one `api.simulate` per wavelength on the same scene and table
    (each file's points equal to it: positions and intensities; the PLY
    written again from it has the same bytes), the scan read back dense
    and compacted (equal after `compact_host`), a full-width ANALYTIC scan
    (finite, non-negative intensities, as many points) and the
    `render-ortho` and `render-overlays` commands.  Returns the numbers."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api, cli
    from lidar_brdf_tpu_torch.core.config import ShadingMode
    from lidar_brdf_tpu_torch.core.types import pack_compact
    from lidar_brdf_tpu_torch.io import obj as obj_mod
    from lidar_brdf_tpu_torch.io import rgl_bsdf
    from lidar_brdf_tpu_torch.physics.brdf import analytic_brdf_factor
    from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
    from lidar_brdf_tpu_torch.io.ply import read_ply, write_ply
    from lidar_brdf_tpu_torch.io.png import read_png
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    city, _, cfg, _, rays = tls
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_files")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    t0 = time.perf_counter()
    sdir = city_scene_dir(city, os.path.join(root, "city"))
    bdir = brdf_dir(os.path.join(root, "brdf"))
    cfg = cfg.with_(wavelength_nm=FILES_WAVELENGTHS)
    cfg_path = os.path.join(root, "tls.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())
    res["write_files_s"] = time.perf_counter() - t0
    out = os.path.join(root, "cloud.ply")
    dev = ["--device", DEVICE]
    libs = traversal_libs()
    for lib in libs.values():                   # main path starts here
        lib.launches = 0
    cli_runs = []                               # `stats=` of each run
    run = Simulator.run

    def recorded(self, rays, *a, stats=None, **k):
        cli_runs.append({} if stats is None else stats)
        return run(self, rays, *a, stats=cli_runs[-1], **k)

    Simulator.run = recorded
    t0 = time.perf_counter()
    try:
        rc = cli.main(["simulate", "--scene", sdir, "--config", cfg_path,
                       "--brdf-dir", bdir, "--out", out] + dev)
    finally:
        Simulator.run = run
    res["cli_s"] = time.perf_counter() - t0
    launches = {k: lib.launches for k, lib in libs.items()}
    res["cli_cull_s"] = [r.get("cull_s") for r in cli_runs]
    log(f"[files] CLI scans, cull per wavelength "
        f"{dict(zip(FILES_WAVELENGTHS, res['cli_cull_s']))} s (the second "
        f"from the ladder cache)")
    if rc != 0:
        fail(f"the CLI simulate exited with {rc}")
    chunks = -(-rays.num_pulses // cfg.chunk_pulses)
    want = {"K1": chunks * len(FILES_WAVELENGTHS), "K2": 0, "K4": 0,
            "K5": chunks * k5_launches(),      # the second from the cache
            "K6": 0}
    if DEVICE == "cuda" and launches != want:
        fail(f"the CLI scan launched {launches}: expected {want}")
    res["launches"] = launches

    # in process: parse, cache, BVH
    t0 = time.perf_counter()
    scene = obj_mod.load_scene_dir(sdir)
    res["parse_s"] = time.perf_counter() - t0
    if scene.num_faces != city.num_faces \
            or scene.num_components != city.num_components:
        fail(f"the loaded city has {scene.num_faces} faces and "
             f"{scene.num_components} components, not {city.num_faces} "
             f"and {city.num_components}")
    parses = []
    parse_obj = obj_mod.parse_obj
    obj_mod.parse_obj = lambda *a, **k: parses.append(a) or parse_obj(*a,
                                                                      **k)
    try:
        res["cache_write_s"] = res["cache_reload_s"] = 0.0
        for name in ("ground.obj", "buildings.obj"):
            path = os.path.join(sdir, name)
            t0 = time.perf_counter()
            first = obj_mod.load_obj_scene(path)
            t1 = time.perf_counter()
            n_parsed = len(parses)
            again = obj_mod.load_obj_scene(path)
            t2 = time.perf_counter()
            res["cache_write_s"] += t1 - t0
            res["cache_reload_s"] += t2 - t1
            if len(parses) != n_parsed or not os.path.exists(
                    path + obj_mod.CACHE_SUFFIX):
                fail(f"the second load of {name} did not come from its "
                     f"cache")
            a, b = first.numpy(), again.numpy()
            if a.keys() != b.keys() or not all(
                    np.array_equal(a[k], b[k]) for k in a):
                fail(f"{name}: the cached scene differs from the parsed one")
    finally:
        obj_mod.parse_obj = parse_obj
    t0 = time.perf_counter()
    bvh = api.build_scene_bvh(scene)
    res["bvh_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in sorted(os.listdir(bdir)):
        if name.endswith(".bsdf"):
            rgl_bsdf.RGLBrdf(os.path.join(bdir, name)).retro_table()
    res["brdf_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    library = MaterialLibrary.default().with_measured(bdir)
    res["brdf_cache_s"] = time.perf_counter() - t0

    # each wavelength in process against its file
    rays = api.build_rays(cfg, scene, device=DEVICE)
    res["scans"] = {}
    clouds = {}
    for wl in FILES_WAVELENGTHS:
        stats = {}
        t0 = time.perf_counter()
        cloud = api.simulate(scene, cfg, materials=library.table_at(wl),
                             bvh=bvh, rays=rays, device=DEVICE, stats=stats)
        stats["wall_s"] = time.perf_counter() - t0
        clouds[wl] = cloud.compact_host()
        base, ext = os.path.splitext(out)
        path = f"{base}_{wl}{ext}"
        back = read_ply(path)
        pos = clouds[wl].position.numpy()
        if not (len(back["x"]) == clouds[wl].capacity > 0
                and np.array_equal(np.stack([back["x"], back["y"],
                                             back["z"]], 1), pos)
                and np.array_equal(back["intensity"],
                                   clouds[wl].intensity.numpy())):
            fail(f"{path}: {len(back['x'])} points, not equal to the "
                 f"in-process scan's {clouds[wl].capacity}")
        again = os.path.join(root, f"again_{wl}.ply")
        t0 = time.perf_counter()
        write_ply(again, cloud)
        stats["ply_s"] = time.perf_counter() - t0
        with open(path, "rb") as fa, open(again, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"{path}: the PLY written in process differs")
        stats["points"] = clouds[wl].capacity
        res["scans"][wl] = stats
        log(f"[files] {wl} nm: {stats['points']} points = the CLI's "
            f"{os.path.basename(path)}; order {stats['order_s']:.3f} s, "
            f"cull {stats['cull_s']:.3f} s, device {stats['device_s']:.3f} "
            f"s, readback {stats['readback_s']:.4f} s "
            f"({stats['readback_bytes']} B), PLY {stats['ply_s']:.3f} s")

    # the same scan read back dense and compacted
    mats = library.table_at(FILES_WAVELENGTHS[0])
    res["readback"] = {}
    got = {}
    for compact in (False, True):
        stats = {}
        cloud = Simulator(
            scene=scene, bvh=bvh, materials=mats, cfg=cfg, device=DEVICE,
            compact_readback=compact).run(rays, stats=stats)
        if not compact:
            dense = cloud.to(DEVICE)
        got[compact] = cloud.compact_host()
        res["readback"]["compact" if compact else "dense"] = dict(
            bytes=stats["readback_bytes"], s=stats["readback_s"],
            device_s=stats["device_s"])
    for f_ in ("position", "normal", "uv", "intensity", "distance",
               "return_number", "num_returns", "scan_angle_rank",
               "scan_direction", "gps_time", "comp_id", "semantic", "asprs"):
        if not torch.equal(getattr(got[False], f_), getattr(got[True], f_)):
            fail(f"compacted and dense readback differ in {f_}")
    r = res["readback"]
    log(f"[files] readback dense {r['dense']['bytes']} B in "
        f"{r['dense']['s']:.4f} s, compacted {r['compact']['bytes']} B in "
        f"{r['compact']['s']:.4f} s (device {r['dense']['device_s']:.3f} "
        f"vs {r['compact']['device_s']:.3f} s); clouds equal")

    # device time of the two element-wise passes at the scan's size: the
    # pack before a compacted readback, the analytic factor over its slots
    dm = scene.to(DEVICE), mats.to(DEVICE)
    mat = dm[0].comp_material[torch.clamp(dense.comp_id, min=0).long()]
    passes = {
        "pack_compact": lambda: pack_compact(dense),
        "analytic_brdf_factor": lambda: analytic_brdf_factor(
            dm[1], mat, dense.normal, prev_dir=dense.scan_direction,
            angle_deg=dense.scan_angle_rank, tangent=dense.scan_direction)}
    res["passes_device_ms"] = {}
    for name, fn in passes.items():
        by = device_ms_by_kernel(fn, 10)
        res["passes_device_ms"][name] = dict(
            ms=device_ms(by), launches=sum(v["launches"] for v in
                                           by.values()))
    log(f"[files] device time at {dense.capacity} slots: "
        + ", ".join(f"{k} {fmt_ms(v['ms'])} ms ({v['launches']:g} launches)"
                    for k, v in res["passes_device_ms"].items()))

    # ANALYTIC at full width
    stats = {}
    t0 = time.perf_counter()
    ana = api.simulate(scene, cfg.with_(shading_mode=ShadingMode.ANALYTIC),
                       materials=mats, bvh=bvh, rays=rays, device=DEVICE,
                       stats=stats).compact_host()
    stats["wall_s"] = time.perf_counter() - t0
    inten = ana.intensity
    if not (ana.capacity == got[True].capacity
            and bool(torch.isfinite(inten).all())
            and bool((inten >= 0).all()) and bool((inten > 0).any())):
        fail(f"the ANALYTIC scan gave {ana.capacity} points (measured "
             f"{got[True].capacity}) or intensities not finite and >= 0")
    stats["points"] = ana.capacity
    res["analytic"] = stats
    log(f"[files] ANALYTIC: {ana.capacity} points, intensity "
        f"{float(inten.min()):.3e}..{float(inten.max()):.3e}, device "
        f"{stats['device_s']:.3f} s, wall {stats['wall_s']:.3f} s")

    # the render commands on the loaded scene
    for cmd, extra in (("render-ortho", []),
                       ("render-overlays", ["--config", cfg_path] + dev)):
        png = os.path.join(root, f"{cmd}.png")
        t0 = time.perf_counter()
        rc = cli.main([cmd, "--scene", sdir, "--out", png] + extra)
        res[f"{cmd}_s"] = time.perf_counter() - t0
        if rc != 0 or read_png(png).size == 0:
            fail(f"{cmd} exited with {rc} or wrote no image")
    shutil.rmtree(root)
    log(f"[files] CLI {res['cli_s']:.2f} s (K launches {launches}); parse "
        f"{res['parse_s']:.2f} s, cache write {res['cache_write_s']:.2f} s, "
        f"reload {res['cache_reload_s']:.3f} s, BVH {res['bvh_s']:.2f} s, "
        f"measured tables {res['brdf_build_s']:.2f} s (cache "
        f"{res['brdf_cache_s']:.3f} s), render-ortho "
        f"{res['render-ortho_s']:.2f} s, render-overlays "
        f"{res['render-overlays_s']:.2f} s")
    return res


# ---------------------------------------------------------------------------
# phase 10: the rest of the runtime (caches, checkpoint/resume, benchmark),
# the bench's forward config and the fit examples
# ---------------------------------------------------------------------------

def same_clouds(a, b) -> bool:
    """Every field of two PointClouds equal bit for bit."""
    import torch
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in vars(a))


def launch_counts(fn):
    """(fn()'s result, {kernel id: launches}): the traversal kernels'
    counts set to 0 just before ``fn`` runs and read just after."""
    libs = traversal_libs()
    for lib in libs.values():
        lib.launches = 0
    out = fn()
    return out, {k: lib.launches for k, lib in libs.items()}


def expect_launches(what, launches, want):
    """Fails unless ``launches`` is ``want`` ({id: count}, others 0)."""
    want = {k: want.get(k, 0) for k in KERNELS}
    if DEVICE == "cuda" and launches != want:
        fail(f"{what} launched {launches}: expected {want}")


def runtime_forward_bench():
    """10a: `python -m lidar_brdf_tpu_torch.bench` with
    ``BENCH_CONFIG=forward`` in process (`bench.forward_main`) at full
    width after the bench's pre-flight K3: K1 once per chunk in each scan,
    the cold and cached clouds equal bit for bit; each scan's peak device
    memory.  The record holds the cold cloud under ``cold_cloud`` (phase
    12 compares its no-cull scan with it)."""
    import torch
    from lidar_brdf_tpu_torch import bench
    env = dict(BENCH_PULSES=str(FORWARD_PULSES), BENCH_TRIS=str(TLS_TRIS),
               BENCH_CHUNK=str(FORWARD_CHUNK))
    saved = {k: os.environ.get(k) for k in env}
    launches, memory = {}, {}

    def run_pass(name, run):
        base = peak_reset()
        cloud, launches[name] = launch_counts(run)
        memory[name] = peak_read(base)
        return cloud

    bench.kernel_smoke(DEVICE)
    os.environ.update(env)
    try:
        res, clouds, stats = bench.forward_main(torch.device(DEVICE),
                                                run_pass)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    chunks = -(-FORWARD_PULSES // FORWARD_CHUNK)
    for name, n in launches.items():     # cached scans cull nothing
        culled = name in ("warm", "cold")
        expect_launches(f"the forward bench's {name} scan", n,
                        {"K1": chunks, "K5": culled * chunks * k5_launches()})
    for name in ("cached_metrics", "cached"):
        if not same_clouds(clouds["cold"], clouds[name]):
            fail(f"the forward bench's {name} cloud differs from the cold "
                 f"one")
    if res["points"] <= 0:
        fail("the forward bench's scan gave no points")
    log(f"[forward bench] " + json.dumps(res))
    for name in ("cold", "cached"):
        log(f"[forward bench] {name} stats= split: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stats[name].items()))
    log(f"[forward bench] {FORWARD_PULSES * 10} rays in {chunks} chunks: "
        f"cold {res['wall_s_cold']:.3f} s = {res['cold_rays_per_s']:.0f} "
        f"rays/s, cached {res['wall_s_cached']:.3f} s = {res['value']:.0f} "
        f"rays/s; launches {launches}; clouds equal; cold scan's device "
        f"memory {fmt_memory(memory['cold'])}")
    return dict(line=res, stats=stats, launches=launches, memory=memory,
                cold_cloud=clouds["cold"])


def runtime_als_repeat(als):
    """10b: phase 4's `als` scan twice on one `Simulator`: the first run
    culls every chunk (K5), the second none (K5 not launched: every chunk
    from the ladder cache), both launch K2 once per chunk, and the second
    gives the first run's cloud (a hit reuses ladders, not results).
    Then the pulse path's cached slice: chunk 0's
    entry holds the permuted slice and the ladders a fresh cull of that
    chunk gives, under the key of its padded rays."""
    import torch
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = als
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    chunks = -(-rays.num_pulses // cfg.chunk_pulses)
    runs, clouds = [], []
    for i in range(2):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held0 = torch.cuda.memory_allocated()
        stats = {}
        t0 = time.perf_counter()
        cloud, launches = launch_counts(lambda: sim.run(rays, stats=stats))
        stats["wall_s"] = time.perf_counter() - t0
        expect_launches(f"the als scan's run {i + 1}", launches,
                        {"K2": chunks,
                         "K5": chunks * k5_launches() if i == 0 else 0})
        if DEVICE == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated()
            stats["held_bytes"] = torch.cuda.memory_allocated() - held0
        stats["launches"] = launches
        runs.append(stats)
        clouds.append(cloud)
    if len(sim._ladder_cache) != chunks:
        fail(f"the als cache holds {len(sim._ladder_cache)} chunks, not "
             f"{chunks}")
    if not same_clouds(clouds[0], clouds[1]):
        fail("the repeat als scan's cloud differs from the first")
    n = cfg.chunk_pulses
    host = host_rays(head(rays, n))
    key, (dev0, data0) = next(iter(sim._ladder_cache.items()))
    dev1, data1, _ = sim._prep(host, 0, n, n)

    def equal(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(map(equal, a, b))
        return a == b

    if not (key == sim._chunk_key(host["origin"], host["direction"])
            and same_clouds(dev0, dev1) and equal(tuple(data0), tuple(data1))
            and data0.uncovered == data1.uncovered):
        fail("the cached als chunk is not the slice and ladders a fresh "
             "cull of it gives")
    moved = not torch.equal(dev0.gps_time.cpu(),
                            torch.from_numpy(host["gps_time"]))
    for i, r in enumerate(runs):
        log(f"[cache] als run {i + 1}: wall {r['wall_s']:.3f} s, order "
            f"{r['order_s']:.3f} s, cull {r['cull_s']:.4f} s, device "
            f"{r['device_s']:.3f} s, readback {r['readback_s']:.3f} s; "
            f"launches {r['launches']}; device memory peak "
            f"{r.get('peak_bytes')} B, held after "
            f"{r.get('held_bytes')} B")
    log(f"[cache] als repeat: K5 not launched, cull "
        f"{runs[1]['cull_s']:.4f} s of {runs[0]['cull_s']:.3f} s; clouds "
        f"equal; chunk 0's cached slice "
        f"is the {'permuted' if moved else 'unpermuted'} slice a fresh "
        f"cull gives, its ladders equal")
    return runs


def runtime_benchmark(tls):
    """10c: `Simulator.benchmark` on the `tls` workload (BENCH_EXECS
    executions, the steady passes on its one chunk): K1 twice an execution
    (FIND_COLLISION, TOTAL) and once a steady pass, K5's cull once an
    execution (TRAVERSE_PREP) and once a steady pass (the cache off)."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = tls
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    metrics, launches = launch_counts(
        lambda: sim.benchmark(rays, num_execs=BENCH_EXECS))
    steady = -(-min(2 * cfg.chunk_pulses, rays.num_pulses)
               // cfg.chunk_pulses)
    expect_launches("Simulator.benchmark", launches,
                    {"K1": BENCH_EXECS * (2 + steady),
                     "K5": BENCH_EXECS * (1 + steady) * k5_launches()})
    for stage in ("RAY_BUILDING", "TRAVERSE_PREP", "FIND_COLLISION",
                  "REDUCE", "INTENSITY", "TOTAL", "READ"):
        if len(metrics.samples.get(stage, [])) != BENCH_EXECS:
            fail(f"Simulator.benchmark has no {BENCH_EXECS} samples of "
                 f"{stage}")
    log("[benchmark] tls, Simulator.benchmark(num_execs="
        f"{BENCH_EXECS}); launches {launches}:\n" + metrics.report())
    return {k: dict(mean_s=metrics.mean(k), std_s=metrics.std(k),
                    n=len(metrics._kept(k))) for k in metrics.samples}


def runtime_checkpoint():
    """10d: the forward config cut to two chunks, run with a checkpoint
    directory; its state cut back to one chunk; a new `Simulator` resumes
    (K1 once: the second chunk) and gives the uninterrupted run's cloud."""
    import json as json_mod
    from lidar_brdf_tpu_torch import bench
    from lidar_brdf_tpu_torch.runtime.checkpoint import ChunkCheckpointer
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    spec = bench.CONFIGS["forward"]
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "forward", 2 * FORWARD_CHUNK, spec["rays_pulse"],
        spec["max_returns"], spec["scene"], TLS_TRIS)
    cfg = cfg.with_(chunk_pulses=FORWARD_CHUNK)
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)

    def simulator():
        return Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                         device=DEVICE)

    t0 = time.perf_counter()
    full = simulator().run(rays, checkpoint_dir=ckdir)
    full_s = time.perf_counter() - t0
    ck = ChunkCheckpointer(ckdir)
    if ck.completed_chunks() != 2:
        fail(f"the checkpoint holds {ck.completed_chunks()} chunks, not 2")
    with open(ck.state_path, "w") as fh:
        json_mod.dump({"completed_chunks": 1}, fh)
    t0 = time.perf_counter()
    resumed, launches = launch_counts(
        lambda: simulator().run(rays, checkpoint_dir=ckdir))
    resumed_s = time.perf_counter() - t0
    expect_launches("the resumed scan", launches,
                    {"K1": 1, "K5": k5_launches()})
    if not same_clouds(full.compact_host(), resumed.compact_host()):
        fail("the resumed scan's cloud differs from the uninterrupted one")
    shutil.rmtree(ckdir)
    log(f"[checkpoint] forward config, 2 chunks of {FORWARD_CHUNK}: "
        f"uninterrupted {full_s:.3f} s, resumed after chunk 1 "
        f"{resumed_s:.3f} s (launches {launches}); {full.capacity} points, "
        f"clouds equal")
    return dict(full_s=full_s, resumed_s=resumed_s, points=full.capacity)


def runtime_examples():
    """10e: the three fit examples (`lidar_brdf_tpu_torch/examples`) at
    their step counts on the packet walk: finite, falling losses, K4 once
    a step, the step-0 loss equal to the CPU port's within rtol 1e-5."""
    import importlib
    import numpy as np
    from lidar_brdf_tpu_torch.examples import adam_fit
    out = {}
    for name in ("fit_brdf", "fit_pose", "fit_geometry"):
        mod = importlib.import_module(
            f"lidar_brdf_tpu_torch.examples.{name}")
        steps = EXAMPLE_STEPS or mod.STEPS
        loss_fn, x0 = mod.build_problem(DEVICE)
        res, launches = launch_counts(
            lambda: adam_fit(loss_fn, x0, mod.LR, steps))
        expect_launches(f"{name}'s {steps} steps", launches,
                        {"K4": steps, "K6": steps if name == "fit_brdf" else 0})
        cpu_fn, cx0 = mod.build_problem("cpu")
        cpu0 = float(cpu_fn(cx0).detach())
        losses = res["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"{name}: losses {losses[0]} -> {losses[-1]} are not "
                 f"finite and falling")
        if not abs(losses[0] - cpu0) <= 1e-5 * abs(cpu0):
            fail(f"{name}: step-0 loss {losses[0]} on {DEVICE} vs {cpu0} "
                 f"on the CPU")
        out[name] = dict(steps=steps, loss_first=losses[0],
                         loss_last=losses[-1], cpu_loss_first=cpu0,
                         s_per_step=res["s_per_step"], launches=launches)
        log(f"[examples] {name}: loss {losses[0]:.6g} -> {losses[-1]:.6g} "
            f"in {steps} steps, {res['s_per_step'] * 1e3:.2f} ms/step; CPU "
            f"step-0 loss {cpu0:.6g}; launches {launches}")
    return out


def phase_runtime(tls, als):
    """Phase 10 (10a-10e), each part's seconds under ``seconds``."""
    res, seconds = {}, {}
    for name, run in (("forward_bench", runtime_forward_bench),
                      ("als_repeat", lambda: runtime_als_repeat(als)),
                      ("benchmark", lambda: runtime_benchmark(tls)),
                      ("checkpoint", runtime_checkpoint),
                      ("examples", runtime_examples)):
        t0 = time.perf_counter()
        res[name] = run()
        seconds[name] = time.perf_counter() - t0
    res["seconds"] = seconds
    log(f"[runtime] phase 10 took {sum(seconds.values()):.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return res


# ---------------------------------------------------------------------------
# phase 11: multi-rank scans and training steps on torch.distributed
# ---------------------------------------------------------------------------

PATH_KERNEL = {"tile": "K1", "ladder": "K2", "packet": "K4"}


def prep_launches(path) -> dict:
    """A rank's launches while it prepares ``path``: K5's cull of its one
    chunk, none for the packet walk."""
    return {} if path == "packet" else {"K5": k5_launches()}


def bits_equal(a, b) -> bool:
    """Two f32 tensors equal bit for bit (a NaN equals the same NaN)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


def within_grad_tol(what, got, want) -> float:
    """Fails unless ``got`` is within phase 7's atol 1e-4 * max|want| of
    ``want`` where ``want`` is finite and non-finite exactly where
    ``want`` is; returns max |d| / max |want| over the finite entries."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        fail(f"{what}: non-finite at other entries than the reference's")
    scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    if not err <= 1e-4 * scale:
        fail(f"{what}: max |d| {err:.3e} of max |g| {scale:.3e}")
    return err / scale if scale else err


def fmt_reduce(all_reduce) -> str:
    return ", ".join(f"{k} {v['ms']:.3f} ms ({v['bytes']} B)"
                     for k, v in (all_reduce or {}).items())


def multirank_nccl(tls):
    """11a: the `tls` workload at full width through `sharded_forward` and
    a ``"full"`` `sharded_train_step` in this process, one rank over NCCL
    (gloo in a CPU rehearsal): the tile cloud equal bit for bit to
    `simulate_chunk`'s on the same rays and buckets, the loss to rtol 1e-5
    and each gradient within phase 7's atol 1e-4 * max|g| of the same step
    with no collective, K1 once per forward and per step, K4 once in the
    packet forward."""
    import torch
    import torch.distributed as dist
    from lidar_brdf_tpu_torch.parallel import multihost, shard, worker
    from lidar_brdf_tpu_torch.runtime.simulate import simulate_chunk
    scene, bvh, _, mats, _ = tls
    multihost.initialize_distributed(
        f"tcp://127.0.0.1:{worker.free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = shard.ray_mesh(None if DEVICE == "cuda" else "cpu")
        backend = dist.get_backend()
        scene_d, mats_d = shard.replicate((scene, mats), mesh)
        rep = (scene_d, bvh, mats_d)
        t0 = time.perf_counter()
        res = worker.run_workload("tls", mesh, rep, MULTI_PULSES, 0,
                                  MULTI_PULSES)
        wall_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    summary = res["summary"]["paths"]
    for path, s in summary.items():
        expect_launches(f"the one-rank {path} cull", s["prep_launches"],
                        prep_launches(path))
        expect_launches(f"the one-rank {path} forward", s["fwd_launches"],
                        {PATH_KERNEL[path]: 1})
    expect_launches("the one-rank tile step", summary["tile"]["step_launches"],
                    {"K1": 1, "K6": 1})
    fn, data, _ = res["traverse"]["tile"]
    args = (rep[0], rep[2], res["rays"], res["noise"], res["scalars"])
    with torch.no_grad():
        ref = simulate_chunk(*args, res["cfg"], scene_has_water=False,
                             traverse_fn=fn, traverse_data=data)
    cloud = res["clouds"]["tile"]
    if not same_clouds(cloud, ref):
        fail("the one-rank tile cloud differs from simulate_chunk's")
    target = torch.where(cloud.mask, cloud.intensity * 1.3,
                         torch.zeros_like(cloud.intensity))
    ref_loss, _, ref_grads = shard.sharded_train_step(
        shard.RayMesh(None, 0, 1, mesh.device), res["cfg"], traverse_fn=fn,
        grad_params="full")(*args, target, data)
    loss, _, grads = res["steps"]["tile"]
    if not abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)):
        fail(f"the one-rank step's loss {float(loss)} vs {float(ref_loss)}")
    ref_named = worker.named_grads(ref_grads)
    errs = {k: within_grad_tol(f"the one-rank step's {k} gradient", g,
                               ref_named[k])
            for k, g in worker.named_grads(grads).items()}
    tile = summary["tile"]
    log(f"[multirank] {backend}, 1 rank on {mesh.device}: tls "
        f"{MULTI_PULSES} pulses x {res['rays'].rays_per_pulse} rays, "
        f"{scene.num_faces} faces in {wall_s:.2f} s; tile cull "
        f"{tile['prep_s']:.3f} s, forward {tile['fwd_ms']:.2f} ms (first "
        f"{tile['fwd_first_ms']:.2f}), full step {tile['step_ms']:.2f} ms "
        f"(first {tile['step_first_ms']:.2f}), packet forward "
        f"{summary['packet']['fwd_ms']:.2f} ms (first "
        f"{summary['packet']['fwd_first_ms']:.2f}); loss {float(loss):.6e}; "
        f"cloud equal to simulate_chunk's, max |dg| / max |g| {errs}; "
        f"all_reduce {fmt_reduce(tile['all_reduce'])}")
    return dict(backend=backend, wall_s=wall_s, paths=summary, grad_err=errs)


def check_ranks(name, ranks, refs, outdir):
    """The ranks' results of workload ``name`` against the parent's shards
    (`worker.run_shards_alone`): each rank's range and PLY shards (bytes
    equal to the parent's shard written the same way), losses, replicated
    gradients, updated materials and checksums bit-equal across ranks (a
    NaN equal to the same NaN) and within phase 7's tolerance of the sum
    of the shards', origin gradients of each rank within it of its
    shard's (non-finite entries where the reference's are), one ladder
    ``t_max``, and (on the card) each path's kernel once per forward and
    per step.  Returns (max |dg| / max |g| by step path and gradient, the
    count of non-finite gradient entries where there are any)."""
    import filecmp
    import torch
    from lidar_brdf_tpu_torch.io.ply import write_ply
    from lidar_brdf_tpu_torch.parallel import worker
    got = [r["workloads"][name] for r in ranks]
    for k, (g, ref) in enumerate(zip(got, refs)):
        s = ref["summary"]
        if (g["lo"], g["hi"]) != (s["lo"], s["hi"]):
            fail(f"{name}: rank {k} took pulses [{g['lo']}, {g['hi']}), "
                 f"not [{s['lo']}, {s['hi']})")
        for path, cloud in ref["clouds"].items():
            mine = os.path.join(outdir, f"parent_{name}_{path}.{k}.ply")
            write_ply(mine, cloud)
            if not filecmp.cmp(mine, g["paths"][path]["ply"], shallow=False):
                fail(f"{name}: rank {k}'s {path} PLY shard differs from "
                     f"the parent's shard {k}")
            expect_launches(f"{name}: rank {k}'s {path} cull",
                            g["paths"][path]["prep_launches"],
                            prep_launches(path))
            expect_launches(f"{name}: rank {k}'s {path} forward",
                            g["paths"][path]["fwd_launches"],
                            {PATH_KERNEL[path]: 1})
        for path, _ in worker.WORKLOADS[name]["steps"]:
            expect_launches(f"{name}: rank {k}'s {path} step",
                            g["paths"][path]["step_launches"],
                            {PATH_KERNEL[path]: 1, "K6": 1})
    for path in worker.WORKLOADS[name]["paths"]:
        t_max = {g["paths"][path]["t_max"] for g in got}
        if path == "ladder" and t_max != {
                refs[0]["summary"]["paths"][path]["t_max"]}:
            fail(f"{name}: the ranks' ladder t_max {t_max} is not the "
                 f"global {refs[0]['summary']['paths'][path]['t_max']}")
    errs, nonfinite = {}, {}
    for path, _ in worker.WORKLOADS[name]["steps"]:
        saved = [torch.load(g["paths"][path]["step_file"], weights_only=True)
                 for g in got]
        sums = [g["paths"][path]["grad_sums"] for g in got]
        differ = []
        for r, (s, c) in enumerate(zip(saved, sums)):
            pairs = [("loss", s["loss"], saved[0]["loss"])] + [
                (f"{k} gradient", s["grads"][k], saved[0]["grads"][k])
                for k in s["grads"] if k != "origin"] + [
                (f"updated {k}", s["materials"][k], saved[0]["materials"][k])
                for k in worker.LEAVES]
            differ += [f"rank {r}'s {what} (max |d| "
                       f"{float((a.double() - b.double()).abs().max()):.3e})"
                       for what, a, b in pairs if not bits_equal(a, b)]
            differ += [f"rank {r}'s {k} checksum {c[k]} vs {sums[0][k]}"
                       for k in c if k != "origin" and not (
                           c[k] == sums[0][k]
                           or math.isnan(c[k]) and math.isnan(sums[0][k]))]
        if differ:
            fail(f"{name}: the {path} step differs between ranks: "
                 + "; ".join(differ))
        want = sum(float(ref["steps"][path][0]) for ref in refs)
        if not abs(float(saved[0]["loss"]) - want) <= 1e-5 * abs(want):
            fail(f"{name}: the ranks' {path} loss "
                 f"{float(saved[0]['loss'])} vs the shards' sum {want}")
        ref_grads = [worker.named_grads(ref["steps"][path][2])
                     for ref in refs]
        for key, g in saved[0]["grads"].items():
            bad = int((~torch.isfinite(g)).sum())
            if bad:
                nonfinite[f"{path}.{key}"] = bad
        for key in saved[0]["grads"]:
            what = f"{name}: the ranks' {path} {key} gradient"
            if key == "origin":
                errs[f"{path}.{key}"] = max(
                    within_grad_tol(what, s["grads"][key], r[key])
                    for s, r in zip(saved, ref_grads))
            else:
                errs[f"{path}.{key}"] = within_grad_tol(
                    what, saved[0]["grads"][key],
                    sum(r[key] for r in ref_grads))
    return errs, nonfinite


def multirank_gloo(tls, als):
    """11b: MULTI_RANKS ranks over gloo sharing the card, started as
    subprocesses (`worker.launch`): the `tls` workload at full width (K1
    once per rank per forward and per step, K4 once in the packet
    forward) and the `als` ladder path (K2 once per rank per forward and
    per step, through `prepare_sharded`), held against the same shards
    computed here (`check_ranks`).  The scenes, BVHs and materials go to
    the ranks as one `.npz` each, written once."""
    import tempfile
    import torch
    from lidar_brdf_tpu_torch.parallel import worker
    dev = torch.device(DEVICE)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as outdir:
        t0 = time.perf_counter()
        for name, (scene, bvh, _, mats, _) in (("tls", tls), ("als", als)):
            worker.write_replicated(os.path.join(outdir, f"{name}.npz"),
                                    scene, bvh, mats)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = worker.launch(MULTI_RANKS, outdir, ["tls", "als"],
                              device=DEVICE, backend="gloo",
                              pulses=MULTI_PULSES, timeout=MULTI_TIMEOUT)
        out["ranks_s"] = time.perf_counter() - t0
        out["errs"], out["nonfinite"], out["parent_s"] = {}, {}, {}
        for name, (scene, bvh, _, mats, _) in (("tls", tls), ("als", als)):
            t0 = time.perf_counter()
            rep = (scene.to(dev), bvh, mats.to(dev))
            total = worker.workload_pulses(name, scene, MULTI_PULSES)
            refs = worker.run_shards_alone(name, rep, total, MULTI_RANKS,
                                           DEVICE)
            out["errs"][name], out["nonfinite"][name] = check_ranks(
                name, ranks, refs, outdir)
            out["parent_s"][name] = time.perf_counter() - t0
            del refs, rep
    out["ranks"] = ranks
    for r in ranks:
        parts = []
        for name, w in r["workloads"].items():
            for path, p in w["paths"].items():
                parts.append(
                    f"{name} {path}: prep {p['prep_s']:.3f} s, forward "
                    f"{p['fwd_ms']:.2f} ms (first {p['fwd_first_ms']:.2f})"
                    + (f", {p['grad_params']} step {p['step_ms']:.2f} ms "
                       f"(first {p['step_first_ms']:.2f}), "
                       f"all_reduce {fmt_reduce(p['all_reduce'])}, "
                       f"{p['reduced_bytes']} B reduced"
                       if "step_ms" in p else ""))
            parts[-1] += (f" [{w['hi'] - w['lo']} pulses, load "
                          f"{w['load_s']:.2f} s, {w['seconds']:.2f} s]")
        log(f"[multirank] gloo rank {r['rank']} of {r['world']} on "
            f"{r['device']}: wall {r['wall_s']:.2f} s; " + "; ".join(parts))
    log(f"[multirank] gloo, {MULTI_RANKS} ranks sharing "
        f"{'one card' if DEVICE == 'cuda' else 'the CPU'} (not a "
        f"scaling figure): .npz written in {out['write_s']:.2f} s, ranks "
        f"{out['ranks_s']:.2f} s, parent's shards "
        + ", ".join(f"{k} {v:.2f} s" for k, v in out["parent_s"].items())
        + "; PLY shards equal the parent's, losses and replicated gradients "
        f"bit-equal across ranks; max |dg| / max |g| vs the shards' sums "
        f"{out['errs']}; non-finite gradient entries (the same on every "
        f"rank and in the parent's shards) {out['nonfinite']}")
    return out


def phase_multirank(tls, als):
    """Phase 11 (11a, 11b), with its seconds."""
    t0 = time.perf_counter()
    res = dict(nccl=multirank_nccl(tls), gloo=multirank_gloo(tls, als))
    res["seconds"] = time.perf_counter() - t0
    log(f"[multirank] phase 11 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 14: the multi-card scaling evidence, each rank's share of the step
# ---------------------------------------------------------------------------

SCALING_WORLDS = (1, 2, 4, 8)   # phase 14: ranks whose shares are stepped
SCALING_ITERS = 3               # phase 14: steps in a timed window
SCALING_WINDOWS = 3             # phase 14: timed windows a share


def scaling_alpha(multirank) -> dict:
    """Phase 14's alpha: the least of phase 11a's 1-rank all_reduce times
    (NCCL on the card), a whole call's overhead."""
    times = multirank["nccl"]["paths"]["tile"]["all_reduce"]
    return dict(alpha_s=min(v["ms"] for v in times.values()) * 1e-3,
                backend=multirank["nccl"]["backend"])


def phase_scaling(als, alpha: dict) -> dict:
    """Phase 14: `bench_scaling.run` for the `tls` and `als` configs at
    each N of SCALING_WORLDS (every share stepped on the card, one after
    another; the `als` scene of phase 4 shared) with ``alpha``
    (`scaling_alpha`): the bytes a step all-reduces (`allreduce_bytes`,
    which `run` holds against what a world-1 `sharded_train_step` hands to
    `all_reduce` on the card), the shares, `analysis`.  Fails where `run`
    raises, on a share whose loss is not finite, or on a share that
    launched other kernels than its traversal kernel once a step and K5 in
    its cull."""
    from lidar_brdf_tpu_torch import bench_scaling as bs
    t_start = time.perf_counter()
    scene, bvh, cfg, mats, rays = als
    setups = {
        "tls": bs.config_setup("tls", DEVICE, pulses=TLS_PULSES,
                               num_tris=TLS_TRIS),
        "als": bs.config_setup("als", DEVICE, num_tris=ALS_TRIS, workload=(
            scene, bvh, cfg.with_(chunk_pulses=rays.num_pulses),
            rays.to("cpu"), mats))}
    kinds = {c: PATH_KERNEL["tile" if s.kind == "tile" else "ladder"]
             for c, s in setups.items()}
    card = setups["tls"].card

    def check(config, n, m):
        for s in m["shares"]:
            if not math.isfinite(s["loss"]):
                fail(f"{config}: share {s['rank']} of {n} gave the "
                     f"loss {s['loss']}")
            steps = bs.steps_per_share(SCALING_ITERS, SCALING_WINDOWS)
            expect_launches(
                f"{config}: share {s['rank']} of {n}", s["launches"],
                {kinds[config]: steps, "K5": k5_launches(), "K6": steps})
            busy = "n/a" if s["busy"] is None else f"{s['busy']:.3f}"
            log(f"[scaling] {config} share {s['rank']} of {n}: "
                f"{s['pulses']} pulses, {s['buckets']} buckets of "
                f"{s['rows']} rows, cull {s['cull_s']:.3f} s, step "
                f"{s['step_s'] * 1e3:.2f} ms (median of {m['windows']} "
                f"windows of {m['iters']}, spread {s['spread']:.3f}), busy "
                f"{busy}, loss {s['loss']:.6e}, peak device bytes "
                f"{s['peak_bytes']} ({card})")
        log(f"[scaling] {config} at {n} share(s): slowest "
            f"{m['slowest_step_s'] * 1e3:.2f} ms (share "
            f"{m['slowest_rank']}), fastest "
            f"{m['fastest_step_s'] * 1e3:.2f} ms ({card})")

    try:
        res = bs.run(worlds=SCALING_WORLDS, iters=SCALING_ITERS,
                     windows=SCALING_WINDOWS, setups=setups, alpha=alpha,
                     check=check)
    except RuntimeError as exc:
        fail(str(exc))
    for config, r in res["allreduce_bytes"].items():
        log(f"[scaling] {config} all-reduced bytes a step, by collective: "
            + ", ".join(f"{k} {b}" for k, b in r["leaves"].items())
            + f"; total {r['total']} (the root script's two terms "
            f"{r['jax_terms']['total_psum_bytes']}: table "
            f"{r['jax_terms']['brdf_table_bytes']}, vertices "
            f"{r['jax_terms']['vertex_grad_bytes']}); equal to a world-1 "
            f"step's on {card}")
    for config, m in res["analysis"]["configs"].items():
        log(f"[scaling] {config} analysis, t1 {m['t1_s'] * 1e3:.2f} ms "
            f"(windows spread {m['t1_spread']:.3f}), alpha "
            f"{alpha['alpha_s'] * 1e3:.4f} ms (a 1-rank {alpha['backend']} "
            f"call, charged on every hop), links assumed (NVLink "
            f"{bs.NVLINK_BYTES_S:.3g} B/s, node link "
            f"{bs.NODE_LINK_BYTES_S:.3g} B/s): " + "; ".join(
                f"{name}: all-reduce {c['allreduce_s'] * 1e3:.4f} ms (bytes "
                f"alone {c['bandwidth_s'] * 1e3:.4f}), weak "
                f"{c['weak_bound']:.4f} (bytes alone "
                f"{c['weak_bound_bytes_only']:.4f}), strong "
                + ("not measured here" if c["strong_bound"] is None
                   else f"{c['strong_bound']:.4f} (bytes alone "
                        f"{c['strong_bound_bytes_only']:.4f})")
                for name, c in m["cases"].items()) + f" ({card})")
    res["seconds"] = time.perf_counter() - t_start
    log(f"[scaling] phase 14 took {res['seconds']:.1f} s")
    return res


def scaling_launches(scaling, config, kernel) -> dict:
    """{N: [``kernel``'s launches in each share]} of phase 14's
    ``config``."""
    return {n: [s["launches"][kernel] for s in m["shares"]]
            for n, m in scaling["measured"][config].items()}


# ---------------------------------------------------------------------------
# phase 12: the JAX package's last entry points on the card, and the scans
# with no cull end to end
# ---------------------------------------------------------------------------

def plain_call(fn):
    """``fn()`` with the wrappers of K1 and K4, where the entry points reach
    them (`kernels/traverse.py::tile_traverse`, `geom/packet.py::
    packet_traverse`), swapped for their plain versions: the same call on
    the same tensors with no kernel."""
    from lidar_brdf_tpu_torch.geom import packet as gp
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    saved = tr.tile_traverse, gp.packet_traverse
    tr.tile_traverse = tr.tile_traverse_plain
    gp.packet_traverse = kpk.packet_traverse_plain
    try:
        return fn()
    finally:
        tr.tile_traverse, gp.packet_traverse = saved


def brute_differences(name, scene, o, d, hit) -> int:
    """Faces of ``hit`` against `intersect_brute` on the same rays: equal,
    but where the two faces tie in t (to rtol 1e-5: rays along a shared
    edge) or the nearer face's barycentric margin is within 1e-5 in
    float64 (the walk and the brute force round the test in other
    orders).  Returns the count of such rays; fails on any other."""
    import numpy as np
    from lidar_brdf_tpu_torch.core.types import as_numpy
    from lidar_brdf_tpu_torch.geom.beamcull import wald_rows_np
    from lidar_brdf_tpu_torch.geom.intersect import intersect_brute
    hb = intersect_brute(scene, o, d)
    fa, ta = hit.face.cpu().numpy(), hit.t.cpu().numpy()
    fb, tb = hb.face.cpu().numpy(), hb.t.cpu().numpy()
    wald = wald_rows_np(as_numpy(scene.vertices), as_numpy(scene.faces))
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    differ = np.nonzero(fa != fb)[0]
    for i in differ:
        near, far = (fa[i], fb[i]) if ta[i] <= tb[i] else (fb[i], fa[i])
        lo, hi = min(ta[i], tb[i]), max(ta[i], tb[i])
        margin = barycentric_margin(wald, on[i], dn[i], int(near))
        if not (far >= 0 and hi - lo <= 1e-5 * hi) and abs(margin) > 1e-5:
            fail(f"{name}: ray {i} takes face {fa[i]} (t {ta[i]}), the brute "
                 f"force {fb[i]} (t {tb[i]}); nearer face's margin "
                 f"{margin:.3e}")
    return int(differ.size)


def entry_call(name, kernel, call, brute=None) -> dict:
    """One call of an entry point on the card: exactly one launch of
    ``kernel`` (a `CudaLibrary`), (t, face) bit-equal to the same call with
    the plain versions (`plain_call`); with ``brute`` = (scene, origins,
    directions), faces held against the brute force
    (`brute_differences`).  Returns the call's record."""
    import torch
    before = kernel.launches
    hit = call()
    sync()
    n = kernel.launches - before
    if DEVICE == "cuda" and n != 1:
        fail(f"{name}: {n} launches in one call, not 1")
    ms = once_ms(call)
    out = {}
    plain_ms = once_ms(lambda: out.setdefault("hit", plain_call(call)))
    ref = out["hit"]
    if not torch.equal(hit.face, ref.face):
        fail(f"{name}: {int((hit.face != ref.face).sum())} faces differ "
             f"from the plain version")
    if not torch.equal(hit.t, ref.t):
        fail(f"{name}: t not bit-equal to the plain version")
    ties = None if brute is None else brute_differences(name, *brute, hit)
    hits = int((hit.face >= 0).sum())
    log(f"[entry] {name}: {hit.face.numel()} rays, {hits} hits, {n} "
        f"launch: faces and t equal bit for bit to the plain version"
        + ("" if ties is None else f"; faces equal to the brute force but "
           f"{ties} rays at a tie or a barycentric threshold")
        + f"; {ms:.3f} ms a call, plain {plain_ms:.1f} ms")
    return dict(rays=hit.face.numel(), hits=hits, launches=n, ms=ms,
                plain_ms=plain_ms, brute_ties=ties)


def dense_candidates(buckets, n_tiles: int):
    """One (n_tiles, C) candidate array from (tidx, cand) buckets on the
    device: each tile's list, -1 padded; dummy rows (tidx == n_tiles) and
    tiles in no bucket hold none."""
    import torch
    cand0 = buckets[0][1]
    out = torch.full((n_tiles + 1, max(c.shape[1] for _, c in buckets)), -1,
                     dtype=torch.int32, device=cand0.device)
    for tidx, cand in buckets:
        out[tidx.long(), :cand.shape[1]] = cand
    return out[:n_tiles].contiguous()


def phase_entry_points(tls, chunk):
    """12a: the per-ray walk `intersect_bvh` and `intersect_packed` (tile 1
    and 128) on the fan over boxes, the grazing fan and the `tls` rays in
    scan order, each call one launch of K4; `intersect_culled` and
    `CulledTraverser` (dense and bucketed, ``chunk=8``) on phase 2's random
    tiles and its `tls` chunk (``chunk``: traverser, origins, directions,
    buckets), each call one launch of K1.  Every call bit-equal to its
    plain version; the walks' faces held against the brute force on the
    small inputs.  Returns the records by call."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.geom import beamcull as bc
    from lidar_brdf_tpu_torch.geom import packet as gp
    from lidar_brdf_tpu_torch.geom.intersect import intersect_bvh
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    boxes = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                         num_boxes=6)
    o, d = fan_rays(64)
    rough, o2, d2 = grazing_fan()
    scene, bvh, _, _, rays = tls
    res = {}
    for what, sc, tree, oo, dd, small in (
            ("fan over boxes", boxes, api.build_scene_bvh(boxes), put(o),
             put(d), True),
            ("grazing fan", rough, api.build_scene_bvh(rough), put(o2),
             put(d2), True),
            ("tls rays", scene, bvh, rays.origin.reshape(-1, 3),
             rays.direction.reshape(-1, 3), False)):
        sc = sc.to(DEVICE)
        brute = (sc, oo, dd) if small else None
        name = f"intersect_bvh, {what}"
        res[name] = entry_call(name, kpk.KERNEL,
                               lambda: intersect_bvh(sc, tree, oo, dd), brute)
        nodes, rows = gp.pack_bvh(tree, DEVICE), gp.pack_triangles(sc)
        for tile in (1, gp.DEFAULT_TILE):
            name = f"intersect_packed, tile {tile}, {what}"
            res[name] = entry_call(
                name, kpk.KERNEL,
                lambda: gp.intersect_packed(nodes, rows, oo, dd, tile=tile),
                brute)

    rng = np.random.default_rng(7)
    sc, o, d = random_tiles(rng)
    tree = api.build_scene_bvh(sc)
    cases = []
    ct = bc.CulledTraverser(sc, tile_rays=256, chunk=8, device=DEVICE)
    cases.append(("random tiles", ct, put(o), put(d),
                  ct.build_candidates(tree, o, d, t_max=80.0),
                  ct.prepare(tree, o, d, t_max=80.0)))
    tt, og, dg, data = chunk
    ct = bc.CulledTraverser(scene, tile_rays=tt.tile_rays, chunk=8,
                            device=DEVICE)
    buckets = tuple((t, c) for t, c, _ in data)
    cases.append(("tls chunk", ct, og, dg, dense_candidates(
        buckets, og.shape[0] // ct.tile_rays), buckets))
    for what, ct, og, dg, dense, buckets in cases:
        dense_t = torch.as_tensor(dense).to(DEVICE)
        T, R = dense_t.shape[0], ct.tile_rays
        name = f"intersect_culled, {what}"
        res[name] = entry_call(name, tr.KERNEL, lambda: bc.intersect_culled(
            ct.wald, dense_t, og.view(T, R, 3), dg.view(T, R, 3), chunk=8))
        for kind, data in (("dense", dense), ("buckets", buckets)):
            name = f"CulledTraverser, {kind}, {what}"
            res[name] = entry_call(name, tr.KERNEL,
                                   lambda: ct(og, dg, data))
        res[f"intersect_culled, {what}"]["candidates"] = list(dense_t.shape)
    return res


def bench_cold_scan(bench_fwd) -> tuple:
    """(cloud, record) of phase 10a's cold `forward` scan, the cloud taken
    out of the bench's record (it stays out of the JSON line): the record
    holds ``wall_s``, its ``stats=`` split and its device memory."""
    return bench_fwd.pop("cold_cloud"), dict(
        wall_s=bench_fwd["line"]["wall_s_cold"],
        **bench_fwd["memory"]["cold"], **bench_fwd["stats"]["cold"])


def forward_workload():
    """The bench's ``forward`` config as `bench.forward_main` builds it:
    (scene, BVH, config in chunks of FORWARD_CHUNK, materials, host rays)
    of FORWARD_PULSES pulses over the TLS_TRIS-face city."""
    from lidar_brdf_tpu_torch import bench
    spec = bench.CONFIGS["forward"]
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "forward", FORWARD_PULSES, spec["rays_pulse"], spec["max_returns"],
        spec["scene"], TLS_TRIS)
    cfg = cfg.with_(chunk_pulses=min(FORWARD_CHUNK, rays.num_pulses))
    return scene, bvh, cfg, mats, rays


def slot_keys(cloud, cfg):
    """(keys, cloud compacted on the host): one int64 per valid slot of an
    ALS cloud, pulse index x (L + 1) + return number; the pulse index is
    the slot's GPS time x the pulse rate, rounded (the time adds the
    return's travel, far below half a pulse period).  Fails unless the
    keys are unique."""
    import numpy as np
    c = cloud.compact_host()
    pulse = np.rint(c.gps_time.double().numpy() * cfg.als_pulse_frequency)
    keys = pulse.astype(np.int64) * (cfg.max_returns + 1) \
        + c.return_number.numpy()
    if np.unique(keys).size != keys.size:
        fail("ALS slot keys (pulse, return number) are not unique")
    return keys, c


def compare_slots(a, b, cfg) -> dict:
    """The no-cull cloud ``a`` against the culled cloud ``b`` of one ALS
    cell, slot for slot: valid slots in both and in one only, the share of
    common slots whose winning face differs (read from the slot's normal,
    the winner face's: the cloud holds no face id), and where the faces
    agree the largest range, position and relative intensity differences
    and the shares of slots whose intensity differs by over 1e-5 and 1e-2.
    Slots are paired by pulse and return number (`slot_keys`): the ladder
    path permutes each chunk's pulses (`Simulator._prep_pulse`), so its
    slots, and the noise draws that follow them, are in another order, and
    positions differ by the noise displacement where the range agrees."""
    import numpy as np
    ka, ca = slot_keys(a, cfg)
    kb, cb = slot_keys(b, cfg)
    _, ia, ib = np.intersect1d(ka, kb, assume_unique=True,
                               return_indices=True)
    same = (ca.normal.numpy()[ia] == cb.normal.numpy()[ib]).all(axis=1)
    pa, pb = ca.position.numpy()[ia], cb.position.numpy()[ib]
    dpos = np.abs(pa - pb).max(axis=1)[same]
    ddist = np.abs(ca.distance.numpy()[ia] - cb.distance.numpy()[ib])[same]
    ia_i, ib_i = ca.intensity.numpy()[ia], cb.intensity.numpy()[ib]
    rel = (np.abs(ia_i - ib_i) / np.maximum(np.abs(ib_i), 1e-30))[same]
    return dict(points=int(ka.size), culled_points=int(kb.size),
                common=int(ia.size), only_no_cull=int(ka.size - ia.size),
                only_culled=int(kb.size - ia.size),
                face_differs_share=float(1.0 - same.mean()) if ia.size
                else 0.0,
                max_ddist_same_face=float(ddist.max()) if ddist.size
                else 0.0,
                max_dpos_same_face=float(dpos.max()) if dpos.size else 0.0,
                max_rel_dI_same_face=float(rel.max()) if rel.size else 0.0,
                rel_dI_over_1e_5_share=float((rel > 1e-5).mean())
                if rel.size else 0.0,
                rel_dI_over_1e_2_share=float((rel > 1e-2).mean())
                if rel.size else 0.0)


def compare_multisets(a, b) -> dict:
    """The no-cull cloud ``a`` against the culled cloud ``b`` of a cell
    whose culled path reorders the pulses (BSP order moves the noise
    draws): valid counts; the share of ``a``'s intensities with no equal
    value left in ``b`` (multisets: each value matched once), and with no
    value of ``b`` within rel 1e-5; and the largest relative difference of
    the sorted intensities, slot for slot when the counts agree, else at
    1001 quantiles (one changed value shifts every sorted slot between its
    old and new place, so this reads the spread of neighbouring values as
    well)."""
    import numpy as np
    ia = np.sort(a.compact_host().intensity.numpy())
    ib = np.sort(b.compact_host().intensity.numpy())
    vals, inv = np.unique(np.concatenate([ia, ib]), return_inverse=True)
    na = np.bincount(inv[:ia.size], minlength=vals.size)
    nb = np.bincount(inv[ia.size:], minlength=vals.size)
    at = np.clip(np.searchsorted(ib, ia), 1, max(ib.size - 1, 1))
    near = np.minimum(np.abs(ia - ib[at - 1]), np.abs(ia - ib[at])) \
        if ib.size > 1 else np.abs(ia - ib[:1])
    out = dict(points=int(ia.size), culled_points=int(ib.size),
               unmatched_intensity_share=float(
                   np.maximum(na - nb, 0).sum() / max(ia.size, 1)),
               no_value_within_1e_5_share=float(
                   (near > 1e-5 * np.abs(ia)).mean()) if ia.size else 0.0)
    if ia.size != ib.size:
        q = np.linspace(0, 1, 1001)
        ia, ib = np.quantile(ia, q), np.quantile(ib, q)
    rel = np.abs(ia - ib) / np.maximum(np.abs(ib), 1e-30)
    out["max_rel_dI_sorted"] = float(rel.max()) if rel.size else 0.0
    return out


def phase_no_cull(als, water, forward, culled) -> dict:
    """12b: the `als`, `water` and `forward` scans through
    `Simulator(use_culled=False)` at full width (`phase_forward`: warm,
    then timed with its split and peak device memory): K4 once a chunk on
    `als` and `forward` (K2 and K1 never), once per level on `water`.  Each
    cloud against the culled cloud of the same cell (``culled``: {cell:
    (cloud, record with ``wall_s`` and ``peak_bytes``)}), printed, not
    gated: `als` slot for slot (`compare_slots`), `water` and `forward`
    by counts and sorted intensities (`compare_multisets`)."""
    res = {}
    for cell, workload, warm in (("als", als, ALS_CHUNK),
                                 ("water", water, WATER_WARM),
                                 ("forward", forward, FORWARD_CHUNK)):
        cfg, rays = workload[2], workload[4]
        per_chunk = {"K4": cfg.max_returns if cell == "water" else 1}
        _, cloud, rec = phase_forward(
            f"{cell}, use_culled=False", workload,
            min(warm, rays.num_pulses), per_chunk, use_culled=False)
        ref_cloud, ref = culled[cell]
        cmp = (compare_slots(cloud, ref_cloud, cfg) if cell == "als"
               else compare_multisets(cloud, ref_cloud))
        res[cell] = dict(rec, culled_wall_s=ref["wall_s"],
                         culled_peak_bytes=ref["peak_bytes"],
                         culled_cull_s=ref["cull_s"], **cmp)
        log(f"[no-cull] {cell}: wall {rec['wall_s']:.3f} s (culled "
            f"{ref['wall_s']:.3f} s, of it cull {ref['cull_s']:.3f} s); "
            f"peak device memory {rec['peak_bytes']} B (culled "
            f"{ref['peak_bytes']} B); against the culled cloud: "
            + ", ".join(f"{k} {v}" for k, v in cmp.items()))
    return res


# ---------------------------------------------------------------------------
# phase 15: K6, the table gradient's scatter-add, against its plain version
# ---------------------------------------------------------------------------

K6_ROWS = 1 << 20          # phase 15: rows (x 8) of the uniform, two-cell cases
K6_HOT_ROWS = 2_097_152    # phase 15: rows (x 8) all on one cell
K6_MS_BUDGET = 200.0       # phase 15: ms of device work a timing aims at
K6_TIMED = ("uniform", "one cell", "two cells", "tls step", "als step")


def k6_cases(steps: dict) -> dict:
    """{name: (idx (N, W) int32, g (N, W) f32, n_cells)} on `DEVICE`:
    synthetic cases over the default library's 15 tables, then each of
    ``steps``' captured step inputs ({"tls": (idx, g, n_cells), ...})."""
    import torch
    from lidar_brdf_tpu_torch.physics.brdf import TABLE_CELLS
    n_cells = 15 * TABLE_CELLS
    gen = torch.Generator().manual_seed(15)
    i32 = torch.int32

    def rand_idx(n, w):
        return torch.randint(0, n_cells, (n, w), generator=gen, dtype=i32)

    def rand_g(n, w):
        return torch.randn((n, w), generator=gen)

    n = K6_ROWS
    masked_idx, masked_g = rand_idx(4099, 8), rand_g(4099, 8)
    dead = torch.rand(4099, generator=gen) < 0.75   # masked slots: one
    masked_idx[dead] = 4242                          # cell, zero cotangents
    masked_g[dead] = 0.0
    masked_g[dead.nonzero()[::2, 0], 0] = -0.0
    masked_g[17, 3] = float("nan")
    cases = {
        "uniform": (rand_idx(n, 8), rand_g(n, 8)),
        "one cell": (torch.full((K6_HOT_ROWS, 8), 12345, dtype=i32),
                     rand_g(K6_HOT_ROWS, 8)),
        "two cells": (torch.tensor([777, 9001], dtype=i32).repeat(4 * n)
                      .reshape(n, 8), rand_g(n, 8)),
        "4099 x 8": (rand_idx(4099, 8), rand_g(4099, 8)),
        "1001 x 4": (rand_idx(1001, 4), rand_g(1001, 4)),
        "777 x 1": (rand_idx(777, 1), rand_g(777, 1)),
        "0 x 8": (rand_idx(0, 8), rand_g(0, 8)),
        "masked slots": (masked_idx, masked_g),
    }
    out = {k: (i.to(DEVICE), g.to(DEVICE), n_cells)
           for k, (i, g) in cases.items()}
    out.update({f"{k} step": v for k, v in steps.items()})
    return out


def k6_check(name, idx, g, n_cells) -> dict:
    """K6 against its plain version on one input: NaN at the same cells,
    every other cell within count_c * 2^-23 * sum_c |g| (float64), one
    launch (none for N = 0).  Returns the error and the input's shape."""
    import torch
    from lidar_brdf_tpu_torch.kernels import scatter
    before = scatter.KERNEL.launches
    got = scatter.table_scatter_add(idx, g, n_cells)
    sync()
    n = scatter.KERNEL.launches - before
    if DEVICE == "cuda" and n != (1 if g.numel() else 0):
        fail(f"K6 {name}: {n} launches in one call")
    want = scatter.table_scatter_add_plain(idx, g, n_cells)
    flat = idx.reshape(-1).long()
    count = torch.bincount(flat, minlength=n_cells).double()
    mag = torch.zeros(n_cells, dtype=torch.float64,
                      device=g.device).index_add_(
        0, flat, g.reshape(-1).abs().double())
    nan = want.isnan()
    if not torch.equal(got.isnan(), nan):
        fail(f"K6 {name}: NaN at {int(got.isnan().sum())} cells, the plain "
             f"version at {int(nan.sum())}")
    err = torch.where(nan, 0.0, (got.double() - want.double()).abs())
    bound = torch.where(nan, 0.0, count * 2.0 ** -23 * mag)
    over = int((err > bound).sum())
    if over:
        fail(f"K6 {name}: {over} cells beyond count * 2^-23 * sum |g| of "
             f"the plain version (max error {float(err.max()):.3e})")
    live = g.reshape(-1) != 0
    cells = torch.unique(flat[live]) if bool(live.any()) else flat[:0]
    zero_cells, zero_counts = torch.unique(flat[~live], return_counts=True)
    return dict(rows=g.shape[0], width=g.shape[1], contributions=g.numel(),
                live=int(live.sum()), cells=int(cells.numel()),
                hottest=int(count.max()) if n_cells else 0,
                zero_cells=int(zero_cells.numel()),
                zero_top_share=(float(zero_counts.max()) / max(1, int(
                    (~live).sum())) if zero_counts.numel() else None),
                max_abs_err=float(err.max()),
                max_err_over_bound=float((err / bound.clamp(
                    min=1e-300)).max()))


def k6_bound(rows, width, n_cells) -> float:
    """K6's least ms: N W 8 bytes read (index and cotangent) and the table
    zeroed and written (8 bytes a cell) at 3.35 TB/s; one add a
    contribution is far below the f32 rate."""
    return (rows * width * 8 + 2 * 4 * n_cells) / H100_BYTES_PER_S * 1e3


def k6_ms(fn) -> float:
    """CUDA-event ms of ``fn()`` on a queue, over as many calls as fit
    `K6_MS_BUDGET` (at least 1)."""
    once = cuda_ms(fn, 1)
    return cuda_ms(fn, max(1, min(100, int(K6_MS_BUDGET / max(once, 1e-3)))),
                   queued=True)


def phase_k6_vs_plain(steps: dict) -> dict:
    """Phase 15: K6 against its plain version on every case of `k6_cases`
    (``steps``: phase 6's captured step inputs), then timed beside
    `index_put_(accumulate=True)`, `index_add_` and the plain version on
    the large cases, in turns.  Returns K6's record for the kernels line
    (its time on the `tls` step's input)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import scatter
    t0 = time.perf_counter()
    res = {}
    for name, (idx, g, n_cells) in k6_cases(steps).items():
        r = res[name] = k6_check(name, idx, g, n_cells)
        r["bound_ms"] = k6_bound(r["rows"], r["width"], n_cells)
        if name in K6_TIMED:
            flat_i, flat_g = idx.reshape(-1), g.reshape(-1)
            flat_l = flat_i.long()
            zeros = lambda: torch.zeros(n_cells, device=g.device)
            fns = dict(
                k6=lambda: scatter.table_scatter_add(idx, g, n_cells),
                index_put=lambda: zeros().index_put_((flat_l,), flat_g,
                                                     accumulate=True),
                index_add=lambda: zeros().index_add_(0, flat_i, flat_g))
            runs = {k: [] for k in fns}
            for k in [*fns, *reversed(fns)]:
                runs[k].append(k6_ms(fns[k]))
            r.update({f"{k}_ms": min(v) for k, v in runs.items()},
                     runs=runs, plain_ms=k6_ms(
                         lambda: scatter.table_scatter_add_plain(
                             idx, g, n_cells)))
        log(f"[K6] {name}: {r['rows']} x {r['width']} ({r['live']} non-zero"
            f", {r['cells']} cells hit, the hottest cell "
            f"{r['hottest']} contributions; zero cotangents on "
            f"{r['zero_cells']} cells, the largest share "
            f"{r['zero_top_share']}); max |K6 - plain| "
            f"{r['max_abs_err']:.3e} ({r['max_err_over_bound']:.3e} of the "
            f"bound); bound {r['bound_ms']:.5f} ms"
            + ("" if "k6_ms" not in r else
               f"; CUDA events K6 {r['k6_ms']:.5f} ms (runs "
               f"{r['runs']['k6']}), index_put_(accumulate=True) "
               f"{r['index_put_ms']:.5f} ({r['runs']['index_put']}), "
               f"index_add_ {r['index_add_ms']:.5f} "
               f"({r['runs']['index_add']}), plain {r['plain_ms']:.5f}; "
               f"K6 at {r['k6_ms'] / r['bound_ms']:.1f}x its bound"))
    main = res["tls step"]
    log(f"[K6] phase 15 took {time.perf_counter() - t0:.1f} s")
    return dict(
        name="table_scatter_add", route="cuda",
        source="lidar_brdf_tpu_torch/kernels/csrc/table_scatter.cu",
        replaces="lidar_brdf_tpu/physics/brdf.py:199", launches=None,
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        ms=main["k6_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by="bytes",
        library_ms=main["index_add_ms"],
        index_put_ms=main["index_put_ms"], cases={
            k: {x: y for x, y in r.items() if x != "runs"}
            for k, r in res.items()})


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import torch
    import lidar_brdf_tpu_torch  # noqa: F401  (fails outside the repo)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--k1-chunk"]:
        log(json.dumps({"k1_chunk": k1_chunk()}))
        return 0
    if sys.argv[1:] == ["--k2-chunk"]:
        log(json.dumps({"k2_chunk": k2_chunk()}))
        return 0
    if sys.argv[1:] == ["--k4-chunk"]:
        log(json.dumps({"k4_chunk": k4_chunk()}))
        return 0
    if sys.argv[1:] == ["--water-scan"]:
        log(json.dumps({"water_scan": water_scan()}))
        return 0
    if sys.argv[1:] == ["--k5-chunk"]:
        phase_card_and_build()
        log(json.dumps({"k5_chunk": k5_chunk()}))
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]} (only --k1-chunk, "
             f"--k2-chunk, --k4-chunk, --k5-chunk or --water-scan)")
    t_start = time.perf_counter()
    card = phase_card_and_build()
    t0 = time.perf_counter()
    tls = tls_workload("cuda")
    log(f"[setup] tls workload built in {time.perf_counter() - t0:.2f} s")
    k3 = phase_k3_vs_plain()
    k1, k1_chunk_data = phase_kernel_vs_plain(tls)
    t0 = time.perf_counter()
    als = als_workload("cuda")
    log(f"[setup] als workload built in {time.perf_counter() - t0:.2f} s")
    als_sim, k2, k2_chunk_data = phase_k2_vs_plain(als)
    choice = phase_traverser_choice(tls, als, k1, als_sim)
    del als_sim
    launches, _, tls_fwd = phase_forward("tls", tls, TLS_PULSES,
                                         {"K1": 1, "K5": k5_launches()})
    k1["launches"] = launches["K1"]
    k5_main = launches["K5"]
    launches, als_cloud, als_fwd = phase_forward(
        "als", als, ALS_CHUNK, {"K2": 1, "K5": k5_launches()})
    k2["launches"] = launches["K2"]
    k5_als = launches["K5"]
    t0 = time.perf_counter()
    water = water_workload(als)
    log(f"[setup] water workload built in {time.perf_counter() - t0:.2f} s")
    water_launches, water_fwd, levels, water_cloud = phase_water(water)
    k5 = phase_k5_vs_plain(tls, als, water)
    k5.update(launches=k5_main, launches_als=k5_als,
              launches_water=water_launches["K5"])
    _, _, tls_walk = phase_forward("tls, use_culled=False", tls, TLS_PULSES,
                                   {"K4": 1}, use_culled=False)
    log(f"[tls] packet walk (K4, no cull) {tls_walk['rays_per_s']:.0f} "
        f"rays/s wall, device {tls_walk['device_s']:.3f} s; culled (K1) "
        f"{tls_fwd['rays_per_s']:.0f} rays/s, device "
        f"{tls_fwd['device_s']:.3f} s")
    k4 = phase_k4_vs_plain(tls, levels)
    del levels
    k4["launches"] = water_launches["K4"]
    k2["launches_water"] = water_launches["K2"]
    phase_card_vs_cpu()
    k3["launches"], tls_steps, als_steps, training, k6_steps = \
        phase_training(als)
    k1["launches_fwd_bwd"] = tls_steps["K1"]
    k2["launches_fwd_bwd"] = als_steps["K2"]
    phase_card_vs_cpu_grads()
    k6 = phase_k6_vs_plain(k6_steps)
    del k6_steps
    k6.update(launches=tls_steps["K6"], launches_als=als_steps["K6"],
              launches_by_grads={k: v["launches"] for k, v in
                                 training.items()})
    files = phase_files(tls)
    runtime = phase_runtime(tls, als)
    forward_culled = bench_cold_scan(runtime["forward_bench"])
    k1["launches_forward_bench"] = runtime["forward_bench"]["launches"]
    k2["launches_als_repeat"] = [
        r["launches"]["K2"] for r in runtime["als_repeat"]]
    k4["launches_examples"] = {
        k: v["launches"]["K4"] for k, v in runtime["examples"].items()}
    k6["launches_examples"] = {
        k: v["launches"]["K6"] for k, v in runtime["examples"].items()}
    multirank = phase_multirank(tls, als)
    gloo = [r["workloads"] for r in multirank["gloo"]["ranks"]]
    nccl = multirank["nccl"]["paths"]
    k1["launches_multirank"] = dict(
        one_rank=[nccl["tile"]["fwd_launches"]["K1"],
                  nccl["tile"]["step_launches"]["K1"]],
        per_rank=[[w["tls"]["paths"]["tile"]["fwd_launches"]["K1"],
                   w["tls"]["paths"]["tile"]["step_launches"]["K1"]]
                  for w in gloo])
    k2["launches_multirank"] = dict(per_rank=[
        [w["als"]["paths"]["ladder"]["fwd_launches"]["K2"],
         w["als"]["paths"]["ladder"]["step_launches"]["K2"]] for w in gloo])
    k6["launches_multirank"] = dict(
        one_rank=nccl["tile"]["step_launches"]["K6"],
        per_rank=[[w[n]["paths"][p]["step_launches"]["K6"]
                   for n, p in (("tls", "tile"), ("als", "ladder"))]
                  for w in gloo])
    k4["launches_multirank"] = dict(
        one_rank=nccl["packet"]["fwd_launches"]["K4"],
        per_rank=[w["tls"]["paths"]["packet"]["fwd_launches"]["K4"]
                  for w in gloo])
    t0 = time.perf_counter()
    entry = phase_entry_points(tls, k1_chunk_data)
    forward = forward_workload()
    no_cull = phase_no_cull(als, water, forward, {
        "als": (als_cloud, als_fwd), "water": (water_cloud, water_fwd),
        "forward": forward_culled})
    del water, forward, als_cloud, water_cloud, forward_culled
    k4["launches_no_cull"] = {k: v["launches"]["K4"]
                              for k, v in no_cull.items()}
    k5["launches_files"] = files["launches"]["K5"]
    k5["launches_forward_bench"] = {
        k: v["K5"] for k, v in runtime["forward_bench"]["launches"].items()}
    k5["launches_als_repeat"] = [
        r["launches"]["K5"] for r in runtime["als_repeat"]]
    k5["launches_multirank"] = dict(
        one_rank=nccl["tile"]["prep_launches"]["K5"],
        per_rank=[[w[n]["paths"][p]["prep_launches"]["K5"]
                   for n, p in (("tls", "tile"), ("als", "ladder"))]
                  for w in gloo])
    points = {"tls": tls_fwd["points"], "als": als_fwd["points"],
              "water": water_fwd["points"],
              "forward": runtime["forward_bench"]["line"]["points"]}
    log("[points] culled scans, this run against the host cull's: " + ", "
        .join(f"{k} {v} ({HOST_CULL_POINTS[k]}, "
              f"{v - HOST_CULL_POINTS[k]:+d})" for k, v in points.items()))
    peaks = {k: (m["peak_bytes"] - m["base_bytes"]
                 if m["peak_bytes"] is not None else None)
             for k, m in (("tls", tls_fwd), ("als", als_fwd),
                          ("water", water_fwd),
                          ("forward",
                           runtime["forward_bench"]["memory"]["cold"]))}
    log("[points] peak device bytes above those held, against the host "
        "cull's: " + ", ".join(f"{k} {v} ({HOST_CULL_PEAK[k]})"
                               for k, v in peaks.items()))
    log(f"[phase 12] took {time.perf_counter() - t0:.1f} s")
    scaling = phase_scaling(als, scaling_alpha(multirank))
    k1["launches_scaling"] = scaling_launches(scaling, "tls", "K1")
    k2["launches_scaling"] = scaling_launches(scaling, "als", "K2")
    k5["launches_scaling"] = {c: scaling_launches(scaling, c, "K5")
                              for c in ("tls", "als")}
    k6["launches_scaling"] = {c: scaling_launches(scaling, c, "K6")
                              for c in ("tls", "als")}
    phase_profiles(k1_chunk_data, k1, k3, k2_chunk_data, k2)
    log(json.dumps({"card": card, "tls_forward": tls_fwd,
                    "files": files, "runtime": runtime,
                    "multirank": multirank,
                    "als_forward": als_fwd, "water_forward": water_fwd,
                    "tls_packet_walk_forward": tls_walk,
                    "traverser_choice": choice, "fwd_bwd": training,
                    "entry_points": entry, "no_cull": no_cull,
                    "points": points, "scaling": scaling,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
