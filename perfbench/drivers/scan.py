"""The ``scan`` driver: whole scans through the port's public entry, as a
user producing point clouds runs them; each request is one call that
ends when the host holds the cloud.

Set-up: the benchmark's scene and materials, the program's face
neighbours and BVH, and one warm-up scan.  The window then runs
`api.simulate` over the whole survey of the configuration's sensor, each
request with its own sensor seed drawn from the run's seed (its flight
jitter, ray noise and sim noise), a cold `Simulator` each call.  When
traced, wrappers around the `Simulator`'s construction and `run(stats=)`
time the layers.  Afterwards one request drawn from the seed is held
against the plain reference: its rays rebuilt by the frozen generator,
its returns worked out again (`reference/physics.py::scan_returns`), and
the clouds matched return by return, each point's pulse read from its
GPS time.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..inputs import als, poses, scenes
from ..inputs import materials as materials_in
from ..reference import physics
from ..trace import Tracer

SPANS = ("construct_s", "order_s", "cull_s", "device_s", "readback_s")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def request_seeds(seed: int):
    rng = np.random.default_rng(seed)
    while True:
        yield int(rng.integers(2 ** 31))


def survey_pulses(sensor: dict, scene: dict) -> int:
    """Pulses of the whole survey (the same for every sensor seed)."""
    v = scene["vertices"]
    p = als.plan(sensor, v.min(0).astype(np.float64),
                 v.max(0).astype(np.float64), np.random.default_rng(0))
    return (p["path_length"] - 1) * p["num_paths"] * p["pulses_per_scan"]


def spy(api, spans: dict):
    """Install wrappers that add each `Simulator`'s construction time and
    its `run` stats into ``spans``, each inside a profiler range
    (``perfbench.construct``, ``perfbench.run``) that names the idle gaps
    it holds; returns the class they replace."""
    from torch.profiler import record_function
    base = api.Simulator

    class Timed(base):
        def __post_init__(self):
            t0 = time.perf_counter()
            with record_function("perfbench.construct"):
                super().__post_init__()
            spans["construct_s"] += time.perf_counter() - t0

        def run(self, rays, **kw):
            stats = {}
            kw.pop("stats", None)
            with record_function("perfbench.run"):
                out = super().run(rays, stats=stats, **kw)
            for k in SPANS[1:]:
                spans[k] += stats.get(k, 0.0)
            return out

    api.Simulator = Timed
    return base


def plant_fault(kind):
    """``altered``: one hit in 64 turned into a miss where the traversal
    produces it.  Returns the undo."""
    if kind is None:
        return lambda: None
    if kind != "altered":
        raise ValueError(f"unknown fault {kind!r}")
    from lidar_brdf_tpu_torch.kernels.pulse import PulseLadderTraverser
    from lidar_brdf_tpu_torch.kernels.traverse import TileTraverser
    saved = {c: c.__call__ for c in (PulseLadderTraverser, TileTraverser)}

    def wrap(inner):
        def call(self, o, d, data):
            hit = inner(self, o, d, data)
            k = torch.arange(hit.face.numel(), device=hit.face.device)
            face = torch.where((k % 64 == 0).reshape(hit.face.shape), -1,
                               hit.face)
            return type(hit)(t=hit.t, face=face)
        return call
    for c, f in saved.items():
        c.__call__ = wrap(f)

    def undo():
        for c, f in saved.items():
            c.__call__ = f
    return undo


def program_points(cloud, pulse_frequency: float) -> dict:
    """A host cloud's valid points, each with its pulse (GPS time over
    the pulse period, rounded) and return number."""
    m = cloud.mask.numpy()
    period = np.float32(1.0) / np.float32(pulse_frequency)
    gps = cloud.gps_time.numpy()[m].astype(np.float64)
    return dict(pulse=np.rint(gps / np.float64(period)).astype(np.int64),
                return_number=cloud.return_number.numpy()[m].astype(
                    np.int64),
                num_returns=cloud.num_returns.numpy()[m].astype(np.int64),
                position=cloud.position.numpy()[m].astype(np.float64),
                intensity=cloud.intensity.numpy()[m].astype(np.float64))


def compare(prog: dict, ref: dict, traffic: dict) -> dict:
    """The compared numbers: the share of the reference's returns that the
    program lacks, adds, or gives with another number of returns, a
    position farther than ``position_tolerance_m`` or an intensity off by
    more than ``intensity_tolerance`` (relative); and the relative gap of
    the summed intensities."""
    key = lambda d: d["pulse"] * 8 + d["return_number"]
    kp, kr = key(prog), key(ref)
    _, ip, ir = np.intersect1d(kp, kr, assume_unique=False,
                               return_indices=True)
    n_ref = max(len(kr), 1)
    off = ((np.linalg.norm(prog["position"][ip] - ref["position"][ir],
                           axis=1) > traffic["position_tolerance_m"])
           | (np.abs(prog["intensity"][ip] - ref["intensity"][ir])
              > traffic["intensity_tolerance"]
              * np.abs(ref["intensity"][ir]))
           | (prog["num_returns"][ip] != ref["num_returns"][ir]))
    unmatched = (len(kp) - len(ip)) + (len(kr) - len(ir))
    total = ref["intensity"].sum()
    return dict(returns_differing=(unmatched + int(off.sum())) / n_ref,
                intensity_sum_gap=float(abs(prog["intensity"].sum() - total)
                                        / max(abs(total), 1e-30)))


def reference(scene: dict, mats: dict, sensor: dict, traffic: dict,
              n_pulses: int, dev, dtype=torch.float32) -> dict:
    """The reference's returns of the survey of ``sensor['seed']``."""
    rays = als.als_rays(sensor, scene, sensor["seed"], n_pulses)
    sc = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in scene.items()}
    sc["roughness"] = torch.from_numpy(mats["roughness"])
    b0, b1 = sensor["max_range_soft_boundary"]
    return physics.scan_returns(
        sc, torch.from_numpy(mats["brdf_table"]), rays["origin"].to(dev),
        rays["direction"].to(dev), sensor, noise_seed=sensor["seed"],
        scene_min_y=float(scene["vertices"][:, 1].min()),
        t_max=float(sensor["max_range"] + abs(b0) + abs(b1) + 1.0),
        pulse_block=traffic["reference_pulse_block"], dtype=dtype)


def inputs(config: dict, traffic: dict) -> dict:
    scene = scenes.make_scene(config["scene"])
    sensor = poses.frame_sensor(config)
    sensor["chunk_pulses"] = traffic["chunk_pulses"]
    return dict(scene=scene, sensor=sensor,
                materials=materials_in.make_materials())


def control(spec, seed: int, device) -> dict:
    """The control's numbers for ``seed``: the bfloat16 reference's
    returns against the float32 reference's."""
    traffic = spec["traffic"]
    inp = inputs(spec["config"], traffic)
    sensor = dict(inp["sensor"], seed=next(request_seeds(seed)))
    n = survey_pulses(sensor, inp["scene"])
    args = (inp["scene"], inp["materials"], sensor, traffic, n, device)
    return compare(reference(*args, dtype=torch.bfloat16),
                   reference(*args), traffic)


def run(ctx) -> dict:
    """One run of a scan cell: set-up, warm-up scan, window, reference."""
    from lidar_brdf_tpu_torch import api
    from lidar_brdf_tpu_torch.core.config import SensorConfig
    from lidar_brdf_tpu_torch.core.types import MaterialTable, TriangleScene
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    inp = inputs(config, traffic)
    t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in d.items()}
    scene = api.attach_face_neighbors(TriangleScene(**t(inp["scene"])))
    bvh = api.build_scene_bvh(scene)
    mats = MaterialTable(**t(inp["materials"]))
    cfg = SensorConfig.from_json(json.dumps(inp["sensor"]))
    n_pulses = survey_pulses(inp["sensor"], inp["scene"])
    n_rays = n_pulses * cfg.rays_per_pulse
    seeds = request_seeds(ctx.seed)
    undo = plant_fault(ctx.fault)
    try:
        api.simulate(scene, cfg.with_(seed=next(seeds)), mats, bvh=bvh,
                     device=dev)                                # warm-up
        setup_s = time.perf_counter() - ctx.clock0
        log(f"# [scan] {n_pulses} pulses x {cfg.rays_per_pulse} rays a "
            f"survey over {scene.num_faces} faces; set-up {setup_s:.2f} s")
        spans = dict.fromkeys(SPANS, 0.0)
        base = spy(api, spans) if ctx.trace else None
        tracer, win, done = Tracer(ctx.trace, dev.type == "cuda"), \
            ctx.window, []
        try:
            with tracer.window():
                win.open()
                while True:
                    s = next(seeds)
                    done.append((s, api.simulate(scene, cfg.with_(seed=s),
                                                 mats, bvh=bvh, device=dev)))
                    if win.complete(n_rays):
                        break
        finally:
            if base is not None:
                api.Simulator = base
        summary = tracer.summary()
        device = ctx.read_device(summary)
    finally:
        undo()
    log(f"# [scan] window {win.elapsed:.3f} s, {win.completions} surveys, "
        f"{win.rate:.1f} rays/s")
    pick = int(np.random.default_rng([ctx.seed, 1]).integers(len(done)))
    s, cloud = done[pick]
    prog = program_points(cloud, cfg.als_pulse_frequency)
    del done, cloud
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference(inp["scene"], inp["materials"], dict(inp["sensor"],
                                                         seed=s),
                    traffic, n_pulses, dev)
    numbers = compare(prog, ref, traffic)
    log(f"# [scan] reference of survey {pick} (sensor seed {s}) "
        f"{time.perf_counter() - t0:.2f} s: {len(ref['pulse'])} returns, "
        f"the program {len(prog['pulse'])}")
    return dict(setup_s=setup_s, rate=win.rate, attempted=win.completions,
                failed=0, numbers=numbers, trace=summary, device=device,
                run=dict(items=win.completions, rays=win.items,
                         window_s=win.elapsed, rays_per_step=n_rays,
                         spans=spans))
