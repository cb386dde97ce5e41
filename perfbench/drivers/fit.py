"""The ``fit`` driver: forward + backward steps of the port's training
step on one culled chunk of a frame, as a user fitting BRDF tables, poses
or geometry runs them.

Set-up: the benchmark's scene, sensor, rays and materials, the pulses in
an order drawn from the seed;
the program's face neighbours, BVH, one cull of the chunk on the device
(`lidar_brdf_tpu_torch.bench.cull`) and its step (`bench.make_step`).  The
first ``checked_steps`` steps of that same step object are the checked
ones: a hook on each parameter reads its gradient as the update gets it.
The window then runs the same step until it closes, one synchronize a
step (a fitting user reads each loss).  Afterwards the plain reference
(`reference/physics.py`) works the loss and the gradients out again from
the benchmark's inputs, taking from the program only the order of the
pulses in the chunk, which is checked on its own: it must be a
permutation of the rays the benchmark made.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from ..inputs import materials as materials_in
from ..inputs import poses, scenes, tls
from ..reference import physics
from ..trace import Tracer


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_rays(config: dict, sensor: dict, scene: dict) -> dict:
    """The first ``fit.pulses`` pulses of the configuration's scan."""
    if sensor["lidar_type"] == 0:
        rays = tls.tls_rays(sensor, sensor["seed"])
    else:
        from ..inputs import als
        rays = als.als_rays(sensor, scene, sensor["seed"],
                            config["fit"]["pulses"])
    n = config["fit"]["pulses"]
    if rays["gps_time"].shape[0] < n:
        raise ValueError(f"the scan has {rays['gps_time'].shape[0]} pulses, "
                         f"fewer than the {n} a step takes")
    return {k: v[:n].contiguous() for k, v in rays.items()}


def inputs(config: dict, seed: int) -> dict:
    """The run's inputs: the configuration's scene, sensor, frame and
    materials, the frame's pulses in an order drawn from ``seed``.  Each
    seed gets the same pulses, so the same work: seeding the rays' jitter
    from the run's seed instead split the step's time into two modes 7%
    apart (82.4 and 87.9 M rays/s)."""
    scene = scenes.make_scene(config["scene"])
    sensor = poses.frame_sensor(config)
    sensor["chunk_pulses"] = config["fit"]["pulses"]
    rays = make_rays(config, sensor, scene)
    order = torch.from_numpy(np.random.default_rng(seed).permutation(
        rays["gps_time"].shape[0]))
    return dict(scene=scene, sensor=sensor,
                rays={k: v[order].contiguous() for k, v in rays.items()},
                materials=materials_in.make_materials())


def _same_rows(a: dict, b: dict) -> int:
    """Pulses of ``b`` (a reordering) that differ from those of ``a``, as
    multisets of (gps_time, origin, direction) rows."""
    def rows(r):
        P = r["gps_time"].shape[0]
        x = torch.cat([r["gps_time"].reshape(P, 1).double(),
                       r["origin"].reshape(P, -1).double(),
                       r["direction"].reshape(P, -1).double()],
                      1).cpu().numpy()
        # gps_time, then the first ray's direction, orders the pulses
        return x[np.lexsort((x[:, 6], x[:, 5], x[:, 4], x[:, 0]))]
    ra, rb = rows(a), rows(b)
    if ra.shape != rb.shape:
        return max(ra.shape[0], rb.shape[0])
    return int((ra != rb).any(axis=1).sum())


def gaps(program: dict, reference: dict, leaf_floor: float) -> dict:
    """The compared numbers: the worst relative loss gap over the checked
    steps, and the worst leaf's gap of gradient norms, each against the
    reference's norm of the leaf or of the median leaf, whichever is
    larger; leaves whose reference norm is under ``leaf_floor`` of the
    median leaf's are left out."""
    ref_loss = reference["loss"]
    loss_gap = max(abs(l - ref_loss) / max(abs(ref_loss), 1e-30)
                   for l in program["losses"])
    rn = reference["grad_norm"]
    med = float(np.median(list(rn.values())))
    grad_gap = 0.0
    for step_norms in program["grad_norms"]:
        for k, r in rn.items():
            if r < leaf_floor * med:
                continue
            p = step_norms.get(k, 0.0)
            grad_gap = max(grad_gap, abs(p - r) / max(r, med))
    return dict(loss_gap=loss_gap, grad_gap=grad_gap)


def plant_fault(kind, ws, step, params, bench):
    """The step with a fault planted under it, for the tests and readings
    that see `correct` turn false: ``frozen`` (a step that leaves its state
    as it was: no backward), ``half`` (half of the pulses left out, the
    rest counted twice), ``altered`` (one hit in 64 turned into a miss
    where the traversal produces it)."""
    if kind is None:
        return step
    if kind == "frozen":
        def frozen():
            with torch.no_grad():
                return bench.step_loss(ws, params).detach()
        return frozen
    if kind == "half":
        inner = bench.simulate_chunk

        def halved(*a, **kw):
            cloud = inner(*a, **kw)
            k = torch.arange(cloud.intensity.shape[0],
                             device=cloud.intensity.device)
            cloud.intensity = torch.where(
                (k % ws.rays.num_pulses) % 2 == 0, cloud.intensity * 2.0,
                torch.zeros_like(cloud.intensity))
            return cloud
        bench.simulate_chunk = halved
        return step
    if kind == "altered":
        inner = ws.traverser

        def altered(o, d, data):
            hit = inner(o, d, data)
            k = torch.arange(hit.face.numel(), device=hit.face.device)
            face = torch.where((k % 64 == 0).reshape(hit.face.shape),
                               -1, hit.face)
            return type(hit)(t=hit.t, face=face)
        ws.traverser = altered
        return step
    raise ValueError(f"unknown fault {kind!r}")


def run(ctx) -> dict:
    """One run of a fit cell: set-up, checked steps, window, reference."""
    from lidar_brdf_tpu_torch import api, bench
    from lidar_brdf_tpu_torch.core.config import SensorConfig
    from lidar_brdf_tpu_torch.core.types import (MaterialTable, RayBundle,
                                                 TriangleScene)
    config, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    inp = inputs(config, ctx.seed)
    t = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in d.items()}
    scene = api.attach_face_neighbors(TriangleScene(**t(inp["scene"])))
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig.from_json(json.dumps(inp["sensor"]))
    rays = RayBundle(**inp["rays"])
    mats = MaterialTable(**t(inp["materials"]))
    ws = bench.cull(scene, bvh, cfg, rays, mats, config["fit"]["traverser"],
                    dev)
    step, params = bench.make_step(ws, traffic["grads"])
    saved_chunk = bench.simulate_chunk
    try:
        step = plant_fault(ctx.fault, ws, step, params, bench)
        norms, handles = {}, []

        def hook(name):
            def fn(p):
                norms[name] = p.grad.double().norm()
            return fn
        for name, p in params.items():
            if p.requires_grad:
                handles.append(p.register_post_accumulate_grad_hook(
                    hook(name)))
        losses, grad_norms = [], []
        for _ in range(traffic["checked_steps"]):
            norms.clear()
            loss = step()
            sync()
            losses.append(float(loss))
            grad_norms.append({k: float(v) for k, v in norms.items()})
        for h in handles:
            h.remove()
        setup_s = time.perf_counter() - ctx.clock0
        n_rays = ws.num_rays
        log(f"# [fit] {ws.rays.num_pulses} pulses x "
            f"{ws.rays.rays_per_pulse} rays over {scene.num_faces} faces, "
            f"{ws.kind} path, cull {ws.cull_s:.3f} s; set-up {setup_s:.2f} s; "
            f"checked losses {losses}")
        tracer = Tracer(ctx.trace, cuda)
        win = ctx.window
        failed = 0
        with tracer.window():
            win.open()
            while True:
                loss = step()
                sync()
                failed += not math.isfinite(float(loss))
                if win.complete(n_rays):
                    break
        t0 = time.perf_counter()
        summary = tracer.summary()
        if summary is not None:
            log(f"# [fit] trace of {len(summary['kernels'])} device "
                f"operations read in {time.perf_counter() - t0:.1f} s")
        peak = ctx.read_device(summary)
    finally:
        bench.simulate_chunk = saved_chunk
    log(f"# [fit] window {win.elapsed:.3f} s, {win.completions} steps, "
        f"{win.rate:.1f} rays/s")
    ordered = {k: getattr(ws.rays, k) for k in ("origin", "direction",
                                                 "gps_time")}
    del step, params, ws
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moved = _same_rows(inp["rays"], ordered)
    ref = reference(inp, ordered, traffic, dev)
    log(f"# [fit] reference {time.perf_counter() - t0:.2f} s: loss "
        f"{ref['loss']!r}, {ref['returns']} returns, grad norms "
        f"{ref['grad_norm']}; program grad norms {grad_norms[0]}")
    numbers = gaps(dict(losses=losses, grad_norms=grad_norms), ref,
                   traffic["leaf_floor"])
    numbers["pulses_not_in_input"] = moved
    return dict(setup_s=setup_s, rate=win.rate, attempted=win.completions,
                failed=failed, numbers=numbers, trace=summary, device=peak,
                run=dict(items=win.completions, rays=win.items,
                         window_s=win.elapsed, rays_per_step=n_rays))


def reference(inp: dict, ordered: dict, traffic: dict, dev,
              dtype=torch.float32) -> dict:
    """The plain reference's loss and gradient norms over the program's
    pulse order."""
    sensor = inp["sensor"]
    scene = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in inp["scene"].items()}
    scene["roughness"] = torch.from_numpy(inp["materials"]["roughness"])
    return physics.fit_step(
        scene, torch.from_numpy(inp["materials"]["brdf_table"]),
        ordered["origin"].detach().to(dev),
        ordered["direction"].detach().to(dev), sensor,
        noise_seed=traffic["noise_seed"],
        scene_min_y=traffic["scene_min_y"],
        t_max=float(sensor["max_range"]) * traffic["t_max_factor"],
        pulse_block=traffic["reference_pulse_block"], dtype=dtype)


def control(spec, seed: int, device) -> dict:
    """The control's numbers for ``seed``: the bfloat16 reference against
    the float32 one, both over the pulses in the benchmark's own order."""
    inp = inputs(spec["config"], seed)
    traffic = spec["traffic"]
    ref = reference(inp, inp["rays"], traffic, device)
    low = reference(inp, inp["rays"], traffic, device, dtype=torch.bfloat16)
    return gaps(dict(losses=[low["loss"]], grad_norms=[low["grad_norm"]]),
                ref, traffic["leaf_floor"])
