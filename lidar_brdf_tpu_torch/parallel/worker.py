"""One rank of a multi-process scan and training step (counterpart of
`scripts/multihost_worker.py` and of the workload of
`__graft_entry__.py::dryrun_multichip`).  Run as

    python -m lidar_brdf_tpu_torch.parallel.worker <rank> <world> <port> \\
        <outdir> --device {cpu,cuda} --backend {gloo,nccl} \\
        --workload {small,tls,als,fan} [...] [--pulses N]

A rank joins the group at ``tcp://127.0.0.1:<port>`` and, for each
workload, reads the replicated scene, BVH and materials from
``<outdir>/<workload>.npz`` (written once by the caller, `write_replicated`,
so that no rank builds a scene; with the sim-noise buffer when the
caller gave one), generates only its own pulse range
(`multihost.process_pulse_range`) and runs `run_workload`: the sharded
forward on each of the workload's paths (tile cull: K1; pulse ladders
through `prepare_sharded`: K2; no cull: the packet walk, K4), then a
training step on each of its step paths.  It writes each forward's PLY
shard (``<outdir>/<workload>_<path>.part<rank>.ply``), each step's loss,
gradients and updated materials (``<workload>_<path>_step.rank<rank>.pt``)
and a JSON summary (``rank<rank>.json``: pulse range, losses, gradient
checksums, point counts, launch counts, seconds, all_reduce times).

`launch` starts the ranks as subprocesses, never by `fork` (the caller may
hold a CUDA context), each with its own log, and kills all of them when one
fails or the time runs out.  Importing this module runs nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import bench
from ..core import convert
from ..core.config import LiDARType, SensorConfig, ShadingMode
from ..core.types import RayBundle, as_numpy, resolve_device
from ..geom.packet import make_packet_traverser
from ..io import native, synthetic
from ..kernels import cull, packet, pulse, traverse
from ..kernels.pulse import PulseLadderTraverser
from ..kernels.traverse import TileTraverser, default_t_max
from ..physics.returns import SimScalars
from ..runtime.simulate import bsp_order
from ..sensors.als import build_als_rays, plan_flight
from ..sensors.tls import build_tls_rays
from ..utils import noise as noise_mod
from . import multihost, shard

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

WORKLOADS = {
    # `tests/test_shard.py`'s scan over a ground plane, 512 pulses x 2 rays
    "small": dict(pulses=512, paths=("tile", "ladder", "packet"),
                  steps=(("tile", "full"), ("ladder", "materials")),
                  bsp=False),
    # the bench's `tls` config (the city), its pulses BSP-ordered per rank
    # as the bench's cull orders them: scan-order tiles span 100 degrees
    "tls": dict(pulses=131072, paths=("tile", "packet"),
                steps=(("tile", "full"),), bsp=True),
    # the bench's `als` config (the terrain) over one chunk of the flight
    "als": dict(pulses=131072, paths=("ladder",),
                steps=(("ladder", "materials"),), bsp=False),
    # the root `bench_scaling.py`'s fan over a small city (:169-193): 2
    # rays a pulse, the packet walk (the JAX mesh's path without a
    # traverser), a "full" step against 1.2 x the forward's intensity
    "fan": dict(pulses=8192, paths=("packet",), steps=(("packet", "full"),),
                bsp=False, target=1.2),
}
TARGET = 1.3                 # a step's target over the forward's intensity
FAN_RAYS_PULSE = 2           # the fan's rays a pulse
TILE_PULSES = 64             # pulses of a K1 tile (the bench's block)
LEAVES = ("refractive_index", "roughness", "brdf_table", "reflectivity_f0")
KERNELS = {"K1": traverse.KERNEL, "K2": pulse.KERNEL, "K4": packet.KERNEL,
           "K5": cull.KERNEL}


def write_replicated(path: str, scene, bvh, materials, noise=None) -> None:
    """The replicated arrays of a workload (scene, BVH, materials and, if
    given, the sim-noise buffer the ranks draw from instead of their own)
    in one uncompressed ``.npz`` that every rank reads."""
    arrays = {}
    for prefix, obj in (("scene", scene), ("bvh", bvh),
                        ("materials", materials)):
        arrays.update({f"{prefix}.{k}": v for k, v in obj.numpy().items()})
    if noise is not None:
        arrays["noise"] = np.asarray(as_numpy(noise), np.float32)
    np.savez(path, **arrays)


def read_replicated(path: str, device) -> tuple:
    """(scene, BVH, materials) of `write_replicated`: scene and materials on
    ``device``, the BVH on the host (the cull walks it there)."""
    with np.load(path) as z:
        part = {p: {k.split(".", 1)[1]: z[k] for k in z.files
                    if k.startswith(p + ".")}
                for p in ("scene", "bvh", "materials")}
    return (convert.scene_from_numpy(part["scene"], device),
            convert.bvh_from_numpy(part["bvh"]),
            convert.materials_from_numpy(part["materials"], device))


def read_noise(path: str, device):
    """The sim-noise buffer `write_replicated` stored, on ``device``; None
    when it stored none."""
    with np.load(path) as z:
        return (torch.from_numpy(z["noise"]).to(device)
                if "noise" in z.files else None)


def _plan(cfg: SensorConfig, scene):
    lo, hi = scene.aabb()
    return plan_flight(cfg, as_numpy(lo), as_numpy(hi),
                       np.random.default_rng(cfg.seed))


def fan_scene():
    """The fan's scene: `city_scene(default_rng(11), 64)`, as the root
    `bench_scaling.py::build_workload` builds it."""
    return synthetic.city_scene(np.random.default_rng(11), num_buildings=64)


def fan_config(total: int) -> SensorConfig:
    """The fan's sensor over ``total`` pulses (the root
    `bench_scaling.py`:174-179)."""
    return SensorConfig(
        lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
        tls_position=(0.0, 12.0, 0.0), rays_per_pulse=FAN_RAYS_PULSE,
        max_returns=1, chunk_pulses=total, include_shiny_surface_error=False,
        shading_mode=ShadingMode.MEASURED)


def fan_rays(total: int, lo: int, hi: int) -> RayBundle:
    """Pulses [lo, hi) of the fan of ``total`` pulses, in the root
    `bench_scaling.py`'s float64 arithmetic (:180-190): azimuths over the
    full turn, elevations -0.9 to -0.3 rad, the pulse's rays 1 mm apart in
    x and z, gps_time 0."""
    R = FAN_RAYS_PULSE
    az = np.linspace(0.0, 2 * np.pi, total, endpoint=False)[lo:hi]
    el = np.linspace(-0.9, -0.3, total)[lo:hi]
    d = np.stack([np.cos(el) * np.cos(az), np.sin(el),
                  np.cos(el) * np.sin(az)], -1).astype(np.float32)
    offs = (np.arange(R, dtype=np.float32)[None, :, None]
            * np.array([0.001, 0.0, 0.001], np.float32))
    o = (np.asarray(fan_config(total).tls_position, np.float32)
         + np.zeros((hi - lo, 1, 3), np.float32) + offs)
    return RayBundle(
        origin=torch.from_numpy(o.astype(np.float32)),
        direction=torch.from_numpy(
            np.broadcast_to(d[:, None, :], (hi - lo, R, 3)).copy()),
        gps_time=torch.zeros(hi - lo, dtype=torch.float32))


def workload_config(name: str, total: int) -> SensorConfig:
    """The sensor of workload ``name`` over a scan of ``total`` pulses: the
    bench's config for `tls` and `als` (`bench.sensor_config`)."""
    if name == "fan":
        return fan_config(total)
    if name == "small":
        return SensorConfig(
            lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
            tls_position=(0.0, 12.0, 0.0),
            tls_fov_horizontal=360.0, tls_fov_vertical=60.0,
            tls_middle_angle_vertical=-45.0,
            tls_resolution_horizontal=32, tls_resolution_vertical=16,
            rays_per_pulse=2, max_returns=1, chunk_pulses=512,
            shading_mode=ShadingMode.MEASURED,
            include_shiny_surface_error=False)
    spec = bench.CONFIGS[name]
    return bench.sensor_config(name, total, spec["rays_pulse"],
                               spec["max_returns"])


def workload_pulses(name: str, scene, pulses: int | None = None) -> int:
    """Pulses of workload ``name``'s whole scan: ``pulses`` cuts the `tls`
    and `als` scans (default: 131,072; `als` at most its flight's) and sets
    the fan's (default: 8,192)."""
    if name == "small" or not pulses:
        pulses = WORKLOADS[name]["pulses"]
    if name == "als":
        pulses = min(pulses, _plan(workload_config(name, pulses),
                                   scene).num_pulses)
    return pulses


def scan_rays(cfg: SensorConfig, scene, lo: int, hi: int) -> RayBundle:
    """Pulses [lo, hi) of the scan, made on the host: only these."""
    raygen = noise_mod.make_raygen_noise(cfg.seed + 1)
    if cfg.lidar_type == LiDARType.TERRESTRIAL_SPHERICAL:
        return build_tls_rays(cfg, raygen, start=lo, count=hi - lo)
    return build_als_rays(cfg, _plan(cfg, scene), raygen, start=lo,
                          count=hi - lo)


def named_grads(grads) -> dict:
    """A step's gradients by name (`LEAVES`, then vertices and origin for
    ``grad_params="full"``)."""
    if isinstance(grads, dict):
        return {**dict(zip(LEAVES, grads["materials"])),
                "vertices": grads["vertices"], "origin": grads["origin"]}
    return dict(zip(LEAVES, grads))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """``fn()`` twice: (the second call's result, {kernel: launches} in
    it, the first call's milliseconds to a synchronize (one-time set-up
    such as a communicator's included), the second's)."""
    ms = []
    for _ in range(2):
        for lib in KERNELS.values():
            lib.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, {k: lib.launches for k, lib in KERNELS.items()}, *ms


def time_all_reduce(mesh, tensors: dict, reps: int = 3) -> dict:
    """Milliseconds of one SUM ``all_reduce`` of a copy of each tensor
    over the mesh (mean of ``reps``, each between two synchronizes), with
    its bytes."""
    out = {}
    for name, t in tensors.items():
        buf = t.detach().clone()
        mesh.all_reduce(buf)                       # warm
        _sync(mesh.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            mesh.all_reduce(buf)
            _sync(mesh.device)
        out[name] = dict(ms=(time.perf_counter() - t0) * 1e3 / reps,
                         bytes=buf.numel() * buf.element_size())
    return out


def run_workload(name: str, mesh, replicated, total: int, lo: int, hi: int,
                 *, t_max: float | None = None, noise=None) -> dict:
    """One rank's share of workload ``name``: pulses [lo, hi) of its
    ``total``, on ``mesh.device``, through the sharded forward on each of
    its paths and a training step (target: `TARGET`, or the workload's
    ``target``, x the forward's masked intensity) on each step path, each
    run twice (the first call's time and the second's; results and launch
    counts are the second's).

    ``replicated``: (scene, BVH, materials) of `read_replicated`.  ``t_max``
    is the ladder path's (None: resolved over the mesh's ranks; a shard
    computed alone passes the global value).  ``noise``: the sim-noise
    buffer (None: `make_sim_noise(0)`).  Returns the inputs (``cfg``,
    ``rays``, ``noise``, ``scalars``), ``clouds`` {path: PointCloud},
    ``steps`` {path: (loss, updated materials, grads)}, ``traverse`` {path:
    (traverse_fn, data, packet_fn)} and ``summary`` (JSON-ready counts,
    launches, seconds, all_reduce times)."""
    spec = WORKLOADS[name]
    scene, bvh, materials = replicated
    dev = mesh.device
    cfg = workload_config(name, total)
    rays = (fan_rays(total, lo, hi) if name == "fan"
            else scan_rays(cfg, scene, lo, hi))
    if spec["bsp"]:
        order = torch.from_numpy(bsp_order(rays, TILE_PULSES))
        rays = RayBundle(origin=rays.origin[order],
                         direction=rays.direction[order],
                         gps_time=rays.gps_time[order])
    rays = multihost.global_rays(rays, mesh)
    noise = (noise_mod.make_sim_noise(0, device=dev) if noise is None
             else noise.to(dev))
    scalars = SimScalars.from_config(cfg, 0.0, dev)
    R = cfg.rays_per_pulse
    res = dict(cfg=cfg, rays=rays, noise=noise, scalars=scalars, clouds={},
               steps={}, traverse={})
    summary = dict(lo=lo, hi=hi, total=total, paths={})
    for path in spec["paths"]:
        for lib in KERNELS.values():
            lib.launches = 0
        t0 = time.perf_counter()
        if path == "packet":
            fn, data, pk = None, None, make_packet_traverser(scene, bvh)
        else:
            fn = (TileTraverser(scene, tile_rays=TILE_PULSES * R, device=dev)
                  if path == "tile" else
                  PulseLadderTraverser(scene, rays_per_pulse=R, device=dev))
            data = shard.shard_traverse_data(
                shard.build_sharded_traverse_data(
                    fn, bvh, rays, mesh,
                    t_max=t_max if path == "ladder" else None), mesh)
            pk = None
        _sync(dev)
        prep_s = time.perf_counter() - t0
        prep_launches = {k: lib.launches for k, lib in KERNELS.items()}
        res["traverse"][path] = (fn, data, pk)
        fwd = shard.sharded_forward(mesh, cfg, traverse_fn=fn, packet_fn=pk)
        cloud, launches, first_ms, ms = _timed(
            lambda: fwd(scene, materials, rays, noise, scalars, data), dev)
        res["clouds"][path] = cloud
        summary["paths"][path] = dict(
            prep_s=prep_s, prep_launches=prep_launches,
            fwd_first_ms=first_ms, fwd_ms=ms, fwd_launches=launches,
            points=int(cloud.mask.sum()),
            t_max=None if fn is None else fn.t_max)
    for path, grad_params in spec["steps"]:
        fn, data, pk = res["traverse"][path]
        cloud = res["clouds"][path]
        target = torch.where(cloud.mask,
                             cloud.intensity * spec.get("target", TARGET),
                             torch.zeros_like(cloud.intensity))
        step = shard.sharded_train_step(mesh, cfg, traverse_fn=fn,
                                        packet_fn=pk, grad_params=grad_params)
        (loss, new, grads), launches, first_ms, ms = _timed(
            lambda: step(scene, materials, rays, noise, scalars, target,
                         data), dev)
        res["steps"][path] = (loss, new, grads)
        named = named_grads(grads)
        replicated_grads = {k: g for k, g in named.items() if k != "origin"}
        summary["paths"][path].update(
            grad_params=grad_params, step_first_ms=first_ms, step_ms=ms,
            step_launches=launches,
            loss=float(loss),
            grad_sums={k: float(g.double().abs().sum())
                       for k, g in named.items()},
            reduced_bytes=sum(g.numel() * g.element_size()
                              for g in replicated_grads.values()),
            all_reduce=(time_all_reduce(mesh, replicated_grads)
                        if mesh.group is not None else None))
    res["summary"] = summary
    return res


def run_shards_alone(name: str, replicated, total: int, world: int,
                     device) -> list[dict]:
    """What ``world`` ranks compute for workload ``name``, shard by shard
    in this process without a collective (``RayMesh(None, k, world,
    device)``): the reference a multi-rank run is held against.  Each
    shard's losses and gradients are its own; the ladder path takes the
    ranks' global ``t_max`` (the MAX of the shards' own).  Each result of
    `run_workload` keeps its ``rays``, ``clouds``, ``steps`` and
    ``summary``."""
    dev = resolve_device(device)
    scene, bvh, _ = replicated
    cfg = workload_config(name, total)
    ranges = [multihost.pulse_range(total, world, k) for k in range(world)]
    t_max = None
    if "ladder" in WORKLOADS[name]["paths"]:
        t_max = max(default_t_max(bvh, scan_rays(cfg, scene, lo, hi).origin)
                    for lo, hi in ranges)
    out = []
    for k, (lo, hi) in enumerate(ranges):
        res = run_workload(name, shard.RayMesh(None, k, world, dev),
                           replicated, total, lo, hi, t_max=t_max)
        del res["traverse"], res["noise"]   # device buckets, 20 MB buffer
        out.append(res)
    return out


def save_rank(outdir: str, name: str, res: dict) -> dict:
    """Write a rank's PLY shards and step results of workload ``name``;
    returns its summary with the files' paths."""
    summary = res["summary"]
    for path, cloud in res["clouds"].items():
        summary["paths"][path]["ply"] = multihost.write_host_shard(
            os.path.join(outdir, f"{name}_{path}"),
            multihost.host_local_cloud(cloud))
    rank = dist.get_rank() if dist.is_initialized() else 0
    for path, (loss, new, grads) in res["steps"].items():
        file = os.path.join(outdir, f"{name}_{path}_step.rank{rank}.pt")
        torch.save(dict(
            loss=loss.cpu(),
            grads={k: g.cpu() for k, g in named_grads(grads).items()},
            materials={k: getattr(new, k).detach().cpu() for k in LEAVES}),
            file)
        summary["paths"][path]["step_file"] = file
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_brdf_tpu_torch.parallel.worker",
        description="One rank of a multi-process scan and training step.")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("outdir")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--workload", choices=tuple(WORKLOADS), nargs="+",
                    required=True)
    ap.add_argument("--pulses", type=int, default=None,
                    help="pulses of the tls and als scans (default: "
                         "131,072) or of the fan (default: 8,192)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    multihost.initialize_distributed(
        f"tcp://127.0.0.1:{args.port}", args.world, args.rank, args.backend,
        device=args.device)
    try:
        mesh = multihost.global_ray_mesh(
            None if args.device == "cuda" else "cpu")
        out = dict(rank=mesh.rank, world=mesh.world_size,
                   backend=dist.get_backend(), device=str(mesh.device),
                   workloads={})
        for name in args.workload:
            t0 = time.perf_counter()
            npz = os.path.join(args.outdir, f"{name}.npz")
            rep = read_replicated(npz, mesh.device)
            noise = read_noise(npz, mesh.device)
            load_s = time.perf_counter() - t0
            total = workload_pulses(name, rep[0], args.pulses)
            lo, hi = multihost.process_pulse_range(total)
            res = run_workload(name, mesh, rep, total, lo, hi, noise=noise)
            out["workloads"][name] = save_rank(args.outdir, name, res)
            out["workloads"][name].update(
                load_s=load_s, seconds=time.perf_counter() - t0)
        out["wall_s"] = time.perf_counter() - t_start
        with open(os.path.join(args.outdir, f"rank{args.rank}.json"),
                  "w") as fh:
            json.dump(out, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on 127.0.0.1 for the group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def launch(world: int, outdir: str, workloads, *, device="cuda",
           backend: str | None = None, pulses: int | None = None,
           timeout: float = 600.0) -> list[dict]:
    """Run ``world`` ranks of this module on this host and return their
    JSON summaries in rank order.

    The caller has written ``<outdir>/<workload>.npz`` for each workload.
    K1, K2 and K4 (on ``cuda``) and the native culler are built here first,
    so that the ranks only load them.  Each rank runs as a subprocess with
    ``LOCAL_RANK`` set, its share of the host's cores as
    ``OMP_NUM_THREADS`` (unless the environment sets it) and its output in
    ``<outdir>/rank<k>.log``.  If a rank fails, or ``timeout`` seconds
    pass, every rank still running is killed and RuntimeError raised with
    the ends of the logs.
    """
    if resolve_device(device).type == "cuda":
        for lib in KERNELS.values():
            lib.build()
    native.get_lib()
    base = dict(os.environ)
    base["PYTHONPATH"] = _REPO_ROOT + os.pathsep + base.get("PYTHONPATH", "")
    base.setdefault("OMP_NUM_THREADS", str(max(1, os.cpu_count() // world)))
    base["LOCAL_WORLD_SIZE"] = str(world)
    port = free_port()
    logs = [os.path.join(outdir, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", "lidar_brdf_tpu_torch.parallel.worker",
                   str(r), str(world), str(port), outdir, "--device",
                   str(device), "--workload", *workloads]
            if backend is not None:
                cmd += ["--backend", backend]
            if pulses is not None:
                cmd += ["--pulses", str(pulses)]
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    cmd, env={**base, "LOCAL_RANK": str(r)}, cwd=_REPO_ROOT,
                    stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = (f"rank(s) {failed} exited with "
                       f"{[rcs[r] for r in failed]}" if failed
                       else f"the ranks ran over {timeout} s")
                raise RuntimeError(why + "".join(
                    f"\n--- rank {r} log ---\n{_tail(logs[r])}"
                    for r in range(world)))
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r in range(world):
        with open(os.path.join(outdir, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    return results


if __name__ == "__main__":
    sys.exit(main())
