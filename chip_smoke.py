#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`lidar_brdf_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. Card and build: prints the card's name and power limit, builds the CUDA
   tile kernel (K1), pulse-ladder kernel (K2), the bench's pre-flight
   kernel (K3) and the packet-walk kernel (K4) from
   `lidar_brdf_tpu_torch/kernels/csrc/` into `build/kernels/` (one nvcc
   each, started together) and launches each once (K1, K2 and K4 on a
   one-triangle input).
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
   `Simulator._prep` does it (one launch per call).  Both timed with CUDA
   events on their real chunk; then K1 and K2 on the same pulses of both
   scenes (the traverser-choice figures; K2 on the `tls` chunk back to
   back and on a queue).
3. The `tls` forward scan at full width through `api.simulate` (1,310,720
   rays over a ~40k-face city), warm, then timed; the launch counts are
   reset just before the timed run: K1 once per chunk, K2 not.
4. The `als` forward scan at full width through `api.simulate` (1,048,576
   pulses x 10 rays, 2 returns, over the 4,999,122-face terrain, in chunks
   of 131,072), warm on one chunk, then timed: K2 once per chunk, K1 not.
4b. The topo-bathymetric scan at full width through `api.simulate`: the
   `als` terrain under a water plane (5,007,314 faces), 532 nm,
   bathymetric, 3 returns, the `als` cell's 1,048,576 pulses (eight
   chunks of 131,072), warm on 8,192, then timed: K2 once per chunk (level 0), K4 twice (levels 1 and
   2), K1 not; it must give bottom returns.  Then the `tls` scan through
   `Simulator(use_culled=False)` (no host cull): K4 once per chunk, no K1.
   K4 against its plain version, faces and t bit for bit and walks as
   long: a fan over boxes, the grazing fan, zero-direction rays, the `tls`
   rays in scan order and the water chunk's level-1 rays, the last two
   timed with CUDA events.
5. Card vs CPU at a small size (L = 1 and 2): same seed, same rays, for
   the TLS tile path and the ALS pulse path; `tests/test_water.py`'s
   bathymetric scan (L = 3, K1 and K4); an ANALYTIC scan whose materials
   take all eight model ids; and a water scene loaded from OBJ files,
   bathymetric at 532 nm (L = 3, K4 for the bounces).  The card reads
   back compacted, so clouds are compared after `compact_host`.
6. The fwd+bwd training step through the port's bench
   (`lidar_brdf_tpu_torch/bench.py`): its pre-flight K3, then the `tls`
   step at full width (131,072 pulses x 10 rays over the ~40k-face city,
   L = 1, face pack built) and the `als` step over the 4,999,122-face
   terrain of phase 4 at 131,072 pulses (L = 2, no face pack; the flight's
   pulse count cut so that the one host cull stays ~5 s).  Launch counts
   are reset before each: K1 must launch once per `tls` step and K2 not, K2
   once per `als` step and K1 not.  Gradients w.r.t. the BRDF table, the ray
   origins and the vertices must be finite, each with a non-zero entry.
   Prints rays/s fwd+bwd, the `BENCH_GRADS` split and host syncs per step.
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
   and `render-overlays` commands; the CLI's host cull per wavelength (the
   second wavelength from the ladder cache).  Runs before phase 8.
10. The rest of the runtime, before phase 8: (a) the port's bench with
   ``BENCH_CONFIG=forward`` in process (1,048,576 pulses x 10 rays over the
   city in 8 chunks; warm, cold, cached with metrics, cached): K1 8 times
   in each scan, the cached clouds equal to the cold one bit for bit, the
   JSON line and the `stats=` split of a cold and a cached scan; (b) phase
   4's `als` scan twice on one `Simulator`: the second's host cull under 1%
   of the first's, K2 8 times in each, equal clouds, device memory, and
   chunk 0's cached (permuted) slice and ladders against a fresh cull; (c)
   `Simulator.benchmark` on the `tls` workload, its report printed; (d)
   checkpoint/resume on the forward config cut to 2 chunks (state cut to 1
   chunk, resumed by a new `Simulator`: K1 once, the uninterrupted cloud);
   (e) the three fit examples at their step counts (K4 once a step, finite
   falling losses, step-0 loss equal to the CPU port's to rtol 1e-5).
8. Profiles, last so that they disturb no timed phase: K1's device time on
   the `tls` chunk, K2's on the `als` chunk (as the Simulator calls it, and
   with the wrapper's two output fills instead), and K3's and
   `torch.addcmul`'s, by `torch.profiler`; each step of K3's wrapper on the
   host over 10,000 calls.

The line before the last is `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`.  It imports nothing of JAX.

`python3 chip_smoke.py --k1-chunk` runs K1 alone on the `tls` chunk and
`--k2-chunk` K2 alone on the `als` chunk and on the `tls` chunk's
ladders; each prints one JSON line
(launches per call, CUDA-event and profiler times).  A copy of the script
in the root of another tree of the repo measures that tree's kernel the
same way.
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
K3_BIG = 1 << 20                # K3 vs plain on 1M elements as well
FORWARD_PULSES = 1_048_576      # the bench's forward config (phase 10a)
FORWARD_CHUNK = 131072          # its chunks (8); 2 for the checkpoint
BENCH_EXECS = 3                 # Simulator.benchmark repetitions (10c)
EXAMPLE_STEPS = None            # None: each fit example's own step count
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
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
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
            ("K4", kpk.KERNEL))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for fut in [pool.submit(k.build, True) for _, k in libs]:
            fut.result()
    log(f"[build] K1-K4 built in {time.perf_counter() - t0:.2f} s "
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
    # a one-leaf tree over the same triangle: 128 rays, one tile
    tri = torch.tensor([[-1.0, -1.0, 50.0, 2.0, 0.0, 0.0, 1.0, 2.0, 0.0]],
                       device="cuda")
    box = torch.tensor([[-1.0, -1.0, 50.0, 1.0, 1.0, 50.0]], device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    t, f = kpk.packet_traverse(box, torch.ones(1, **i32),
                               torch.zeros(1, **i32), tri, o, d)
    torch.cuda.synchronize()
    if not (bool((f == 0).all()) and bool(((t - 50.0).abs() < 1e-5).all())):
        fail(f"K4 one-leaf launch gave faces {f.unique().tolist()}")
    log("[build] K1 one-tile, K2 one-ladder, K3 one-tile and K4 one-leaf "
        "launches ok")
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
    host cull seconds)."""
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

    # one real chunk of the tls workload: BSP order + host cull as the
    # Simulator does it
    tr_, og, dg, data, cull_s = tls_chunk(tls)
    chunk = (tr_, og, dg, data)
    R = tr_.tile_rays
    errs.append(compare_kernel("tls chunk", tr_, og, dg, data, R))
    sizes = [tuple(c.shape) for _, c, _ in data]
    real = [int((t < og.shape[0] // R).sum()) for t, _, _ in data]
    log(f"[kernel] tls chunk: host cull {cull_s:.3f} s, {len(data)} buckets "
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
    origins, directions, buckets, host cull seconds)."""
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
        f"{tr_.wald.shape[0]} faces): host cull {cull_s:.3f} s; K2 "
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
    """K1 and K2 on the same pulses of both scenes: device ms and host cull
    seconds.  Figures only; the auto rule stays the JAX package's."""
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator, bsp_order
    out = {}
    # tls chunk: K1 figures from phase 2; K2 on ladders in scan order
    scene, rays = tls[0], tls[4]
    n = rays.num_pulses
    t2, og, dg, data, cull2 = tls_pulse_chunk(tls)
    k2 = lambda: pp.pulse_traverse(t2.wald, og, dg, data, t2.t_max,
                                   t2.kernel_rays)
    ms2 = cuda_ms(k2, 20)
    out["tls"] = dict(faces=scene.num_faces, pulses=n, k1_ms=k1["ms"],
                      k1_cull_s=k1["cull_s"], k2_ms=ms2, k2_cull_s=cull2,
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
    out["als"] = dict(faces=scene.num_faces, pulses=n, k1_ms=ms1,
                      k1_cull_s=cull1, k2_ms=ms2, k2_cull_s=cull2,
                      k1_buckets=[tuple(c.shape) for _, c, _ in data1],
                      k2_buckets=[tuple(c.shape) for _, c in data2])
    for name, r in out.items():
        log(f"[choice] {name} ({r['faces']} faces, {r['pulses']} pulses): "
            f"K1 {r['k1_ms']:.4f} ms + host cull {r['k1_cull_s']:.3f} s; "
            f"K2 {r['k2_ms']:.4f} ms + host cull {r['k2_cull_s']:.3f} s")
    r = out["tls"]
    log(f"[choice] tls K2 (buckets {r['k2_buckets']}): "
        f"{r['k2_launches_per_call']} launch(es) per call; back-to-back "
        f"calls {r['k2_ms']:.4f} ms, CUDA events on a queue of 20 calls "
        f"{r['k2_queued_ms']:.4f} ms")
    return out


KERNELS = ("K1", "K2", "K4")       # the traversal kernels of the scans


def traversal_libs() -> dict:
    """The traversal kernels' `CudaLibrary` by id."""
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    return {"K1": tr.KERNEL, "K2": pp.KERNEL, "K4": kpk.KERNEL}


def phase_forward(name, workload, warm_pulses, per_chunk, **sim_kw):
    """One forward scan at full width, after a warm run on the first
    ``warm_pulses`` pulses: through `api.simulate`, or through a
    `Simulator` built with ``sim_kw`` when given.  The traversal kernels'
    launch counts are set to 0 just before the timed run and read just
    after: each kernel of ``per_chunk`` ({id: launches per chunk}) must
    have launched that often per chunk, every other one not."""
    import torch
    from lidar_brdf_tpu_torch import api
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
    stats = {}
    sync()
    libs = traversal_libs()
    for lib in libs.values():                   # main path starts here
        lib.launches = 0
    t0 = time.perf_counter()
    cloud = scan(rays, stats)
    wall = time.perf_counter() - t0
    launches = {k: lib.launches for k, lib in libs.items()}
    m = cloud.mask
    n_pts = int(m.sum())
    inten = cloud.intensity[m]
    log(f"[{name}] {n_rays} rays, {scene.num_faces} faces, L = "
        f"{cfg.max_returns}: {n_pts} valid points "
        f"({int((cloud.return_number[m] == 1).sum())} second returns); "
        f"warm run ({warm_pulses} pulses) {warm_s:.3f} s, timed run "
        f"{wall:.3f} s = {n_rays / wall:.0f} rays/s wall-clock; order "
        f"{stats['order_s']:.3f} s, host cull {stats['cull_s']:.3f} s, "
        f"device {stats['device_s']:.3f} s, readback "
        f"{stats['readback_s']:.3f} s; launches {launches}")
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
        rays_per_s=n_rays / wall, launches=launches, **stats)


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
    """Rays (N, 3) padded to whole 128-ray tiles as `intersect_packed_scene`
    pads them (origin 1e10, direction 0)."""
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


def compare_k4(name, packed, o, d):
    """K4 vs its plain version on rays ``o``/``d`` (padded to tiles here):
    faces equal, t equal bit for bit, every tile's walk as long.  Returns
    (steps (T, 2): node steps and leaf steps per tile, the plain version's
    ms for the call, the max |dt| over the rays that hit in both)."""
    import torch
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    o, d = pad_tiles(o, d)
    T = o.shape[0] // 128
    steps_k = torch.zeros((T, 2), dtype=torch.int32, device=o.device)
    steps_p = torch.zeros_like(steps_k)
    t_k, f_k = kpk.packet_traverse(*packed, o, d, steps=steps_k)
    out = {}
    plain_ms = once_ms(lambda: out.setdefault("p", kpk.packet_traverse_plain(
        *packed, o, d, steps=steps_p)))
    t_p, f_p = out["p"]
    sync()
    diff = (f_k != f_p).nonzero().flatten()
    if diff.numel():
        fail(f"{name}: {diff.numel()} faces differ between K4 and plain "
             f"(first rays {diff[:5].tolist()})")
    hit = (f_k >= 0) & (f_p >= 0)
    err = float((t_k[hit] - t_p[hit]).abs().max()) if bool(hit.any()) \
        else 0.0
    if not torch.equal(t_k, t_p):
        fail(f"{name}: t not bit-equal between K4 and plain (max |dt| over "
             f"hits {err:.3e})")
    if not torch.equal(steps_k, steps_p):
        fail(f"{name}: walk lengths differ between K4 and plain")
    log(f"[kernel] {name}: {o.shape[0]} rays ({T} tiles), {int(hit.sum())} "
        f"hits: faces equal, max |dt| {err:.3e}, t equal bit for bit; node "
        f"steps {int(steps_k[:, 0].sum())} (leaves "
        f"{int(steps_k[:, 1].sum())}), longest walk "
        f"{int(steps_k[:, 0].max())}; plain {plain_ms:.1f} ms")
    return steps_k, plain_ms, err


def k4_bound(steps, n_rays):
    """(bound ms, "bytes" or "operations", ops ms, bytes ms) of one K4
    call: the counted steps x 128 lanes x the operations a step does (the
    slab test at a node, Moller-Trumbore at a leaf), and 32 bytes a ray
    (rays in, (t, face) out; the node and triangle rows that the rays of
    a tile share are not counted)."""
    node = int(steps[:, 0].sum())
    leaf = int(steps[:, 1].sum())
    ops = 128 * ((node - leaf) * OPS_BOX + leaf * OPS_TRI)
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    bytes_ms = 32 * n_rays / H100_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


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


def phase_water(water):
    """The topo-bathymetric scan through `api.simulate`, timed after a
    warm run: K2 once a chunk (level 0), K4 twice (the refracted levels 1
    and 2), K1 never; it must give bottom returns (ASPRS 2 at return
    number >= 1).  Then the first chunk once more through a `Simulator`
    whose packet walk keeps the level-1 rays it is handed (in the chunk's
    bucket order, as on the main path).  Returns (launches, the scan's
    record, (packed scene, level-1 origins, level-1 directions))."""
    from lidar_brdf_tpu_torch.geom.packet import (intersect_packed_scene,
                                                  pack_scene)
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = water
    L = cfg.max_returns
    launches, cloud, res = phase_forward(
        "water", water, min(WATER_WARM, rays.num_pulses),
        {"K2": 1, "K4": L - 1})
    m = cloud.mask
    bottom = int((m & (cloud.asprs == 2) & (cloud.return_number >= 1)).sum())
    surface = int((m & (cloud.asprs == 9)).sum())
    log(f"[water] {surface} water-surface returns, {bottom} bottom returns "
        f"(ASPRS 2, return number >= 1)")
    if bottom <= 0:
        fail("the water scan gave no bottom returns")
    res.update(surface_returns=surface, bottom_returns=bottom)
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    packed = pack_scene(sim.scene, sim.bvh)
    seen = []

    def walk(o, d):
        seen.append((o.reshape(-1, 3), d.reshape(-1, 3)))
        return intersect_packed_scene(packed, o, d)

    sim.packet_fn = walk
    n = min(cfg.chunk_pulses, rays.num_pulses)
    sl, data, _ = sim._prep(host_rays(head(rays, n)), 0, n, n)
    sim.run_chunk(sl, 0, data)
    sync()
    if len(seen) != L - 1:
        fail(f"the water chunk walked {len(seen)} bounce levels, not {L - 1}")
    return launches, res, (packed, *seen[0])


def phase_k4_vs_plain(tls, level1):
    """K4 against its plain version, faces and t bit-equal and walks as
    long: on the fan over boxes, the grazing fan, zero-direction padding
    rays, the `tls` chunk in scan order (what ``use_culled=False`` hands
    it) and the water scan's level-1 rays; timed with CUDA events on the
    last two.  Returns K4's record (its time and bound on the level-1
    rays, the main path's input)."""
    import numpy as np
    import torch
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.geom.packet import pack_scene
    from lidar_brdf_tpu_torch.io import synthetic
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
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
        errs.append(compare_k4(name, packed, put(oo), put(dd))[2])
    out = {}
    scene, bvh, _, _, rays = tls
    cases = (("tls", pack_scene(scene.to(DEVICE), bvh),
              rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)),
             ("water", *level1))
    for key, packed, oo, dd in cases:
        steps, plain_ms, err = compare_k4(f"K4 {key} rays", packed, oo, dd)
        errs.append(err)
        op, dp = pad_tiles(oo, dd)
        call = lambda: kpk.packet_traverse(*packed, op, dp)
        per_call = launches_in(kpk.KERNEL, call)
        if DEVICE == "cuda" and per_call != 1:
            fail(f"K4 launched {per_call} times in one call")
        ms = [cuda_ms(call, 10, queued=True) for _ in range(2)]
        bound_ms, bound_by, ops_ms, bytes_ms = k4_bound(steps, oo.shape[0])
        node, leaf = int(steps[:, 0].sum()), int(steps[:, 1].sum())
        out[key] = dict(rays=oo.shape[0], ms=min(ms), ms_runs=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, node_steps=node, leaf_steps=leaf,
                        longest_walk=int(steps[:, 0].max()))
        log(f"[kernel] K4 {key} rays: {ms[0]:.4f} / {ms[1]:.4f} ms (CUDA "
            f"events on a queue of 10 calls, two runs), plain "
            f"{plain_ms:.1f} ms; {node} node steps x 128 lanes ({leaf} "
            f"leaves): bound {bound_ms:.4f} ms ({bound_by}; ops "
            f"{ops_ms:.4f}, bytes {bytes_ms:.4f})")
    w = out["water"]
    return dict(name="packet_traverse", route="cuda",
                source="lidar_brdf_tpu_torch/kernels/csrc/packet_traverse.cu",
                replaces="lidar_brdf_tpu/geom/packet.py:148",
                launches=None, max_abs_err=max(errs), ms=w["ms"],
                plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None, water=w,
                tls=out["tls"])


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


def phase_fwd_bwd(name, ws, kernel):
    """Training steps on one culled workload: launch counts set to 0 just
    before the timed steps and read just after (``kernel`` must launch,
    the other traversal kernel not); gradient check; BENCH_GRADS split."""
    from lidar_brdf_tpu_torch import bench
    from lidar_brdf_tpu_torch.kernels import pulse as pp
    from lidar_brdf_tpu_torch.kernels import traverse as tr
    loss, gmax = check_grads(name, ws)
    split = {}
    syncs = prof = None
    launches = None
    for grads in ("none", "table", "table+origin", "full"):
        step, _ = bench.make_step(ws, grads)
        step()                                   # warm
        sync()
        if grads == "full":
            syncs = count_syncs(step)
            tr.KERNEL.launches = pp.KERNEL.launches = 0
        t = bench.time_steps(step, DEVICE, STEP_ITERS, warm=1)
        if grads == "full":
            launches = dict(K1=tr.KERNEL.launches, K2=pp.KERNEL.launches)
            prof = bench.profile_step(step, DEVICE)
        split[grads] = dict(step_s=t["step_s"],
                            rays_per_s=ws.num_rays / t["step_s"])
    other = "K2" if kernel == "K1" else "K1"
    if DEVICE == "cuda" and (launches[kernel] != STEP_ITERS + 1
                             or launches[other]):
        fail(f"the {name} fwd+bwd steps launched {launches}: expected "
             f"{kernel} once per step ({STEP_ITERS + 1}) and nothing else")
    full = split["full"]
    log(f"[fwd+bwd] {name}: {ws.rays.num_pulses} pulses x "
        f"{ws.rays.rays_per_pulse} rays, {ws.scene.num_faces} faces, L = "
        f"{ws.cfg.max_returns}, host cull {ws.cull_s:.3f} s; loss {loss:.6e}, "
        f"max |g| {gmax}; full step {full['step_s'] * 1e3:.2f} ms = "
        f"{full['rays_per_s']:.0f} rays/s fwd+bwd; host syncs per step "
        f"{syncs}; launches in 1 warm + {STEP_ITERS} timed steps {launches}")
    log(f"[fwd+bwd] {name} BENCH_GRADS split (ms per step): " + ", ".join(
        f"{k} {v['step_s'] * 1e3:.2f}" for k, v in split.items()))
    if prof is not None:
        prof["busy"] = prof["device_s"] / full["step_s"]
        log(f"[fwd+bwd] {name} profiled full step: device "
            f"{prof['device_s'] * 1e3:.2f} ms, busy share {prof['busy']:.3f} "
            f"of the timed step (profiled wall {prof['wall_s'] * 1e3:.2f} "
            f"ms); top kernels (ms, calls): "
            + "; ".join(f"{n} {ms:.3f} x{c}" for n, ms, c in prof["top"]))
    return launches, dict(rays=ws.num_rays, faces=ws.scene.num_faces,
                          cull_s=ws.cull_s, loss=loss, grad_max=gmax,
                          syncs_per_step=syncs, launches=launches,
                          split=split, profile=prof)


def phase_training(als):
    """The port's bench path: K3 pre-flight, the full-width `tls` step, the
    `als` step over phase 4's terrain.  Returns (K3 launches, K1 launches,
    K2 launches, results)."""
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
    k1, tls = phase_fwd_bwd("tls", ws, "K1")
    del ws
    scene, bvh, cfg, mats, rays = als
    n = min(ALS_STEP_PULSES, rays.num_pulses)
    ws = bench.cull(scene, bvh, cfg.with_(chunk_pulses=n),
                    head(rays, n).to("cpu"), mats, "pulse", DEVICE)
    k2, als_res = phase_fwd_bwd("als", ws, "K2")
    return k3, k1["K1"], k2["K2"], dict(tls=tls, als=als_res)


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
    same host cull: loss to rtol 1e-5, each gradient finite and within
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
    log(f"[files] CLI scans, host cull per wavelength "
        f"{dict(zip(FILES_WAVELENGTHS, res['cli_cull_s']))} s (the second "
        f"from the ladder cache)")
    if rc != 0:
        fail(f"the CLI simulate exited with {rc}")
    chunks = -(-rays.num_pulses // cfg.chunk_pulses)
    want = {"K1": chunks * len(FILES_WAVELENGTHS), "K2": 0, "K4": 0}
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
    the cold and cached clouds equal bit for bit."""
    import torch
    from lidar_brdf_tpu_torch import bench
    env = dict(BENCH_PULSES=str(FORWARD_PULSES), BENCH_TRIS=str(TLS_TRIS),
               BENCH_CHUNK=str(FORWARD_CHUNK))
    saved = {k: os.environ.get(k) for k in env}
    launches = {}

    def run_pass(name, run):
        cloud, launches[name] = launch_counts(run)
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
    for name, n in launches.items():
        expect_launches(f"the forward bench's {name} scan", n,
                        {"K1": chunks})
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
        f"rays/s; launches {launches}; clouds equal")
    return dict(line=res, stats=stats, launches=launches)


def runtime_als_repeat(als):
    """10b: phase 4's `als` scan twice on one `Simulator`: the second run
    culls nothing (its ``cull_s`` under 1% of the first's), still launches
    K2 once per chunk and gives the first run's cloud (a hit reuses
    ladders, not results).  Then the pulse path's cached slice: chunk 0's
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
                        {"K2": chunks})
        if DEVICE == "cuda":
            stats["peak_bytes"] = torch.cuda.max_memory_allocated()
            stats["held_bytes"] = torch.cuda.memory_allocated() - held0
        stats["launches"] = launches
        runs.append(stats)
        clouds.append(cloud)
    if len(sim._ladder_cache) != chunks:
        fail(f"the als cache holds {len(sim._ladder_cache)} chunks, not "
             f"{chunks}")
    if not runs[1]["cull_s"] < 0.01 * runs[0]["cull_s"]:
        fail(f"the repeat als scan's cull_s {runs[1]['cull_s']:.4f} s is "
             f"not under 1% of the first's {runs[0]['cull_s']:.4f} s")
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
    log(f"[cache] als repeat: cull {runs[1]['cull_s']:.4f} s of "
        f"{runs[0]['cull_s']:.3f} s; clouds equal; chunk 0's cached slice "
        f"is the {'permuted' if moved else 'unpermuted'} slice a fresh "
        f"cull gives, its ladders equal")
    return runs


def runtime_benchmark(tls):
    """10c: `Simulator.benchmark` on the `tls` workload (BENCH_EXECS
    executions, the steady passes on its one chunk): K1 twice an execution
    (FIND_COLLISION, TOTAL) and once a steady pass."""
    from lidar_brdf_tpu_torch.runtime.simulate import Simulator
    scene, bvh, cfg, mats, rays = tls
    sim = Simulator(scene=scene, bvh=bvh, materials=mats, cfg=cfg,
                    device=DEVICE)
    metrics, launches = launch_counts(
        lambda: sim.benchmark(rays, num_execs=BENCH_EXECS))
    steady = -(-min(2 * cfg.chunk_pulses, rays.num_pulses)
               // cfg.chunk_pulses)
    expect_launches("Simulator.benchmark", launches,
                    {"K1": BENCH_EXECS * (2 + steady)})
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
    expect_launches("the resumed scan", launches, {"K1": 1})
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
        expect_launches(f"{name}'s {steps} steps", launches, {"K4": steps})
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
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]} (only --k1-chunk or "
             f"--k2-chunk)")
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
    launches, _, tls_fwd = phase_forward("tls", tls, TLS_PULSES, {"K1": 1})
    k1["launches"] = launches["K1"]
    launches, _, als_fwd = phase_forward("als", als, ALS_CHUNK, {"K2": 1})
    k2["launches"] = launches["K2"]
    t0 = time.perf_counter()
    water = water_workload(als)
    log(f"[setup] water workload built in {time.perf_counter() - t0:.2f} s")
    water_launches, water_fwd, level1 = phase_water(water)
    del water
    _, _, tls_walk = phase_forward("tls, use_culled=False", tls, TLS_PULSES,
                                   {"K4": 1}, use_culled=False)
    log(f"[tls] packet walk (K4, no host cull) {tls_walk['rays_per_s']:.0f} "
        f"rays/s wall, device {tls_walk['device_s']:.3f} s; culled (K1) "
        f"{tls_fwd['rays_per_s']:.0f} rays/s, device "
        f"{tls_fwd['device_s']:.3f} s")
    k4 = phase_k4_vs_plain(tls, level1)
    del level1
    k4["launches"] = water_launches["K4"]
    k2["launches_water"] = water_launches["K2"]
    phase_card_vs_cpu()
    (k3["launches"], k1["launches_fwd_bwd"], k2["launches_fwd_bwd"],
     training) = phase_training(als)
    phase_card_vs_cpu_grads()
    files = phase_files(tls)
    runtime = phase_runtime(tls, als)
    k1["launches_forward_bench"] = runtime["forward_bench"]["launches"]
    k2["launches_als_repeat"] = [
        r["launches"]["K2"] for r in runtime["als_repeat"]]
    k4["launches_examples"] = {
        k: v["launches"]["K4"] for k, v in runtime["examples"].items()}
    phase_profiles(k1_chunk_data, k1, k3, k2_chunk_data, k2)
    log(json.dumps({"card": card, "tls_forward": tls_fwd,
                    "files": files, "runtime": runtime,
                    "als_forward": als_fwd, "water_forward": water_fwd,
                    "tls_packet_walk_forward": tls_walk,
                    "traverser_choice": choice, "fwd_bwd": training,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": [k1, k2, k3, k4]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
