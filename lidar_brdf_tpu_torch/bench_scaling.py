"""Multi-card scaling evidence for the port (counterpart of the repository's
root `bench_scaling.py` and of `scripts/pod_projection.py`).  Run as

    python -m lidar_brdf_tpu_torch.bench_scaling                # on the card
    python -m lidar_brdf_tpu_torch.bench_scaling --device cpu   # small sizes

A synchronous data-parallel training step over N cards
(`parallel/shard.py::sharded_train_step`) has each rank step its own
contiguous range of pulses, then sums the loss and the gradients of the
replicated parameters with `all_reduce`: it takes the slowest rank's step
plus the all-reduces.  One card cannot hold N NCCL ranks, so this module
measures the first term on the card and models the second:

1. `allreduce_bytes`: the exact bytes one step hands to `all_reduce`, leaf
   by leaf, counted from the workload `bench.build_workload` builds, beside
   the two terms the root script counts (`_psum_bytes`); `run` holds the
   count against what a world-1 step really reduces (`step_allreduce_bytes`).
2. `measured_step`: each rank's share of a bench config's pulses
   (`multihost.pulse_range`), stepped one after another on this card
   through the port's bench (`cull`, `make_step(grads="full")`,
   `profile_step`): its step time (the median of `WINDOWS` timed windows,
   with their spread), busy share, launches and buckets, and the slowest
   share.  The scene, its BVH and the traverser (its Wald table; the BVH's
   nodes on the device after the first cull) are built once per config
   and shared by every share, as each rank builds them once at set-up.
   The bench's cull keeps no other state between calls (the `Simulator`'s
   ladder, BSP-order and count-hint caches are not on its path), so every
   share culls cold.
3. `analysis`: ring all-reduce times for 2, 4 and 8 cards in a node and for
   2 nodes of 8 cards, from those bytes, stated link rates (assumptions,
   each with its source) and alpha, the time of a 1-rank NCCL
   `all_reduce` call charged on every hop (a pessimistic per-call
   overhead, not a measured link latency); the weak- and strong-scaling
   bounds they give, each beside the bound from the bytes alone.
   Labelled ``analysis``: arithmetic on measured inputs, not a measurement
   of several cards.
4. `projection`: rays/s of a node of 8 cards beside one card's.
5. `build_workload` and `virtual_check`: the root script's fan of rays over
   a small city, run on N ranks through `parallel/worker.launch`: over
   NCCL, one rank per card (the hardware run on ``cuda``, which refuses
   more ranks than cards and never runs ``gloo`` instead), or over
   ``gloo`` on the CPU (``device="cpu"``: a correctness check of the
   collective program, NOT hardware scaling).

`main` prints one JSON line (progress on stderr) and writes the full
record to ``build/scaling/scaling.json`` (git-ignored; ``--out`` moves
it).  It reads no file of the repository.  On the card it runs `CARD_RUN`,
on the CPU the small `CPU_RUN`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from . import api, bench
from .core.types import RayBundle, resolve_device
from .io.materials import MaterialLibrary
from .parallel import multihost, shard, worker
from .physics.returns import SimScalars
from .utils import noise as noise_mod

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- link rates: assumptions, each with its source --------------------------
NVLINK_BYTES_S = 450e9
NVLINK_SOURCE = ("assumption: NVLink 4 on the H100 SXM, 900 GB/s "
                 "bidirectional per GPU (NVIDIA H100 Tensor Core GPU "
                 "datasheet), 450 GB/s per direction")
NODE_LINK_BYTES_S = 400e9 / 8
NODE_LINK_SOURCE = ("assumption: 400 Gb/s per card between nodes, one "
                    "ConnectX-7 port per GPU (NVIDIA DGX H100 datasheet), "
                    "50 GB/s per direction")
CARDS_PER_NODE = 8
# (name, cards, link rate, link): a ring over 2 nodes of 8 runs at its
# slowest link, the one between the nodes
CLUSTERS = (("2 cards", 2, NVLINK_BYTES_S, "nvlink"),
            ("4 cards", 4, NVLINK_BYTES_S, "nvlink"),
            ("8 cards", 8, NVLINK_BYTES_S, "nvlink"),
            ("2 nodes", 2 * CARDS_PER_NODE, NODE_LINK_BYTES_S, "node link"))
WORLDS = (1, 2, 4, 8, 16)       # shares measured; 16: two nodes of 8
CONFIGS = ("tls", "als", "multireturn", "alphaprime")
WARM_STEPS = 2                  # untimed steps of a share before its windows
STEP_ITERS = 3                  # steps in a timed window
WINDOWS = 5                     # timed windows a share; its step: the median
# what `sharded_train_step` all-reduces in a "full" step, in its order
COLLECTIVES = ("loss",) + worker.LEAVES + ("vertices",)
PULSES_PER_RANK = 262144        # the fan's pulses a rank (the root script's)


@dataclass(frozen=True)
class Sizes:
    """What `main` runs: the configs, the worlds whose shares are stepped,
    steps a window and windows a share, the cut of every config's pulses
    and faces (None: the config's own), and the fan's ranks and pulses a
    rank."""

    configs: tuple
    worlds: tuple
    iters: int
    windows: int
    pulses: int | None
    num_tris: int | None
    fan_worlds: tuple
    fan_pulses_per_rank: int


CARD_RUN = Sizes(CONFIGS, WORLDS, STEP_ITERS, WINDOWS, None, None, (1,),
                 PULSES_PER_RANK)
# the CPU is a rehearsal of the program, not a measurement
CPU_RUN = Sizes(("tls",), (1, 2), 1, 2, 256, 2000, (1, 2), 64)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def card_line(device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives it (``"NVIDIA H100 80GB HBM3, 700.00
    W"``); ``"cpu"`` on the CPU."""
    name, limit = bench.card_and_power_limit(torch.device(device))
    if name == "cpu":
        return name
    return f"{name}, " + ("power limit unknown" if limit is None
                          else f"{limit:.2f} W")


# ---------------------------------------------------------------------------
# the bytes a step all-reduces
# ---------------------------------------------------------------------------

def bench_workload(config: str, pulses: int | None = None,
                   num_tris: int | None = None):
    """`bench.build_workload` of ``config`` at its sizes (``pulses`` and
    ``num_tris`` cut them): (scene, BVH, sensor config, host rays,
    materials)."""
    spec = bench.CONFIGS[config]
    return bench.build_workload(config, pulses or spec["pulses"],
                                spec["rays_pulse"], spec["max_returns"],
                                spec["scene"], num_tris or spec["num_tris"])


def jax_vertex_formula(num_tris: int) -> int:
    """The root script's terrain vertex count (`bench_scaling.py`:92-94):
    (g + 1)^2 with g = ceil(sqrt(F / 2)).  `rough_terrain` takes
    floor(sqrt(F / 2)) cells a side, so where F / 2 is no square the
    formula counts one row and one column of vertices more."""
    g = int(np.ceil(np.sqrt(num_tris / 2)))
    return (g + 1) ** 2


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def allreduce_bytes(config: str, workload=None,
                    num_tris: int | None = None) -> dict:
    """The bytes one ``"full"`` `sharded_train_step` of bench config
    ``config`` hands to `all_reduce` (`parallel/shard.py`: the loss, the
    four material float leaves, the vertices; origin gradients stay with
    their rank), by collective (``leaves``, in the step's order) and in
    all (``total``), counted from ``workload`` (`bench_workload(config)`
    when None).  ``jax_terms`` are the two terms the root script's
    `_psum_bytes` (:78-101) counts: the BRDF table and the vertices, the
    city's counted, the terrain's by `jax_vertex_formula` at the faces the
    workload was built for (``num_tris``; default: the config's)."""
    spec = bench.CONFIGS[config]
    if workload is None:
        workload = bench_workload(config, num_tris=num_tris)
    scene, _, _, _, mats = workload
    leaves = {"loss": mats.brdf_table.element_size()}   # the f32 sum
    leaves.update({k: _nbytes(getattr(mats, k)) for k in worker.LEAVES})
    leaves["vertices"] = _nbytes(scene.vertices)
    table = leaves["brdf_table"]
    if spec["scene"] == "terrain":
        verts = jax_vertex_formula(num_tris or spec["num_tris"])
    else:
        verts = scene.num_vertices
    vert_b = verts * 3 * scene.vertices.element_size()
    return {"leaves": leaves, "total": sum(leaves.values()),
            "vertices": scene.num_vertices,
            "jax_terms": {"brdf_table_bytes": table,
                          "vertex_grad_bytes": vert_b,
                          "total_psum_bytes": table + vert_b,
                          "vertices": verts}}


@dataclass(frozen=True)
class RecordingMesh(shard.RayMesh):
    """A `RayMesh` that records the shape and bytes of every tensor handed
    to its `all_reduce` (in ``calls``) before it reduces it as usual."""

    calls: list = field(default_factory=list)

    def all_reduce(self, tensor, op=dist.ReduceOp.SUM):
        self.calls.append((tuple(tensor.shape), _nbytes(tensor)))
        return super().all_reduce(tensor, op)


def step_allreduce_bytes(setup: ConfigSetup, pulses: int = 1024) -> list:
    """[(shape, bytes)] of every `all_reduce` of one ``"full"``
    `sharded_train_step` at world 1 (no group) on the first ``pulses`` of
    ``setup``'s rays, culled by the bench: what the step really reduces."""
    scene, bvh, cfg, rays, mats = setup.workload
    n = min(pulses, rays.num_pulses)
    ws = bench.cull(scene, bvh, cfg.with_(chunk_pulses=n), _pulses(rays, 0, n),
                    mats, setup.kind, setup.device, traverser=setup.traverser)
    mesh = RecordingMesh(None, 0, 1, setup.device)
    step = shard.sharded_train_step(mesh, ws.cfg, scene_has_water=False,
                                    traverse_fn=ws.traverser,
                                    grad_params="full")
    target = torch.zeros((), device=setup.device)
    step(ws.scene, ws.materials, ws.rays, ws.noise, ws.scalars, target,
         ws.data)
    return list(mesh.calls)


# ---------------------------------------------------------------------------
# each rank's share of the step, measured on this card
# ---------------------------------------------------------------------------

@dataclass
class ConfigSetup:
    """What every share of one bench config shares: the workload as
    `bench.build_workload` makes it (scene and materials on the device,
    host rays), the traverser, the card, the set-up seconds and the faces
    asked for."""

    config: str
    workload: tuple          # (scene, BVH, sensor config, rays, materials)
    kind: str                # "tile" (K1) or "pulse" (K2)
    traverser: object
    device: torch.device
    card: str
    setup_s: float
    num_tris: int            # the faces the workload was built for


def config_setup(config: str, device="cuda", *, pulses: int | None = None,
                 num_tris: int | None = None, workload=None) -> ConfigSetup:
    """``config``'s workload (built by `bench_workload` unless given, with
    host rays; ``num_tris``: the faces it was built for, None for the
    config's) and its traverser, built once."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if workload is None:
        workload = bench_workload(config, pulses, num_tris)
    scene, bvh, cfg, rays, mats = workload
    kind = bench.CONFIGS[config]["traverser"]
    scene, mats = scene.to(dev), mats.to(dev)
    tr = bench.make_traverser(scene, kind, rays.rays_per_pulse, dev)
    return ConfigSetup(config, (scene, bvh, cfg, rays.to("cpu"), mats), kind,
                       tr, dev, card_line(dev), time.perf_counter() - t0,
                       num_tris or bench.CONFIGS[config]["num_tris"])


def _pulses(rays: RayBundle, lo: int, hi: int) -> RayBundle:
    return RayBundle(origin=rays.origin[lo:hi],
                     direction=rays.direction[lo:hi],
                     gps_time=rays.gps_time[lo:hi])


def steps_per_share(iters: int = STEP_ITERS, windows: int = WINDOWS) -> int:
    """Steps `measured_step` runs on a share: `WARM_STEPS`, ``windows`` x
    ``iters`` timed, one profiled (each launches K1 or K2 once, and K6
    once for the table and once a row scatter)."""
    return WARM_STEPS + windows * iters + 1


def _window_s(step, sync, iters: int) -> tuple:
    """(seconds a step over ``iters`` steps between two synchronizes, the
    last loss)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    sync()
    return (time.perf_counter() - t0) / iters, loss


def measured_step(config: str, world: int, setup: ConfigSetup | None = None,
                  *, device="cuda", iters: int = STEP_ITERS,
                  windows: int = WINDOWS) -> dict:
    """Each of ``world`` ranks' shares of ``config``'s pulses
    (`multihost.pulse_range`), one after another on ``device``: the
    bench's cull of the share (upload and K5), then a ``"full"`` step
    (`bench.make_step`): `WARM_STEPS` untimed, ``windows`` windows of
    ``iters`` steps timed (``step_s``: their median; ``windows_s`` each,
    ``spread``: the slowest over the fastest), and one more under
    `bench.profile_step` (device seconds and busy share; None on the
    CPU).  ``buckets`` / ``rows`` / ``candidates``: the share's cull (from
    the shapes, no device read).  Each share's workload is freed before
    the next.  The slowest share sets a synchronous step's time."""
    if setup is None:
        setup = config_setup(config, device)
    dev = setup.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    scene, bvh, cfg, rays, mats = setup.workload
    total = rays.num_pulses
    shares = []
    for i in range(world):
        lo, hi = multihost.pulse_range(total, world, i)
        for lib in worker.KERNELS.values():
            lib.launches = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ws = bench.cull(scene, bvh, cfg.with_(chunk_pulses=hi - lo),
                        _pulses(rays, lo, hi), mats, setup.kind, dev,
                        traverser=setup.traverser)
        step, _ = bench.make_step(ws, "full")
        t0 = time.perf_counter()
        for _ in range(WARM_STEPS):
            step()
            sync()
        first_s = (time.perf_counter() - t0) / WARM_STEPS
        timed = [_window_s(step, sync, iters) for _ in range(windows)]
        win = [t for t, _ in timed]
        step_s = statistics.median(win)
        prof = bench.profile_step(step, dev)
        shapes = [tuple(b[1].shape) for b in ws.data]
        shares.append(dict(
            rank=i, lo=lo, hi=hi, pulses=hi - lo, rays=ws.num_rays,
            cull_s=ws.cull_s, warm_s=first_s, step_s=step_s, windows_s=win,
            spread=max(win) / min(win), loss=float(timed[-1][1]),
            buckets=len(shapes), rows=sum(b for b, _ in shapes),
            candidates=sum(b * c for b, c in shapes),
            device_s=None if prof is None else prof["device_s"],
            busy=None if prof is None else prof["device_s"] / step_s,
            top=None if prof is None else prof["top"][:3],
            launches={k: lib.launches for k, lib in worker.KERNELS.items()},
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None)))
        del ws, step
    slowest = max(shares, key=lambda s: s["step_s"])
    return dict(config=config, world=world, pulses=total,
                rays=total * rays.rays_per_pulse, iters=iters,
                windows=windows, device=str(dev), card=setup.card,
                shares=shares, slowest_rank=slowest["rank"],
                slowest_step_s=slowest["step_s"],
                slowest_spread=slowest["spread"],
                fastest_step_s=min(s["step_s"] for s in shares))


def one_rank_allreduce(reduced: dict, device="cuda", reps: int = 20) -> dict:
    """Milliseconds of one `all_reduce` of each collective's size over a
    1-rank group in this process (NCCL on the card, gloo on the CPU; mean
    of ``reps``, each to a synchronize).  No link is crossed: the least of
    them (``alpha_s``) is the overhead of one call, its launch and
    synchronize, not a figure of several cards nor a link's latency."""
    dev = resolve_device(device)
    multihost.initialize_distributed(
        f"tcp://127.0.0.1:{worker.free_port()}", 1, 0, device=dev)
    try:
        mesh = shard.ray_mesh(None if dev.type == "cuda" else "cpu")
        bufs = {k: torch.zeros(max(b // 4, 1), device=mesh.device)
                for k, b in reduced["leaves"].items()}
        out = worker.time_all_reduce(mesh, bufs, reps=reps)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    return dict(backend=backend, card=card_line(dev), collectives=out,
                alpha_s=min(v["ms"] for v in out.values()) * 1e-3)


# ---------------------------------------------------------------------------
# the model: ring all-reduce, scaling bounds, the node's projection
# ---------------------------------------------------------------------------

def ring_allreduce_s(nbytes, n: int, link_bytes_s: float,
                     alpha_s: float) -> float:
    """Seconds of a ring all-reduce of each collective in ``nbytes`` over
    ``n`` ranks, summed: 2(n-1)/n x B / W + 2(n-1) x alpha each (a
    reduce-scatter and an all-gather of n-1 hops each, each hop charged
    ``alpha``); 0 at n = 1.  With alpha a whole call's overhead
    (`one_rank_allreduce`) charged on every hop, the model is pessimistic;
    ``alpha_s=0`` gives the bytes alone, an optimistic one."""
    if n <= 1:
        return 0.0
    return sum(2 * (n - 1) / n * b / link_bytes_s + 2 * (n - 1) * alpha_s
               for b in nbytes)


def analysis(measured: dict, reduced: dict, alpha: dict) -> dict:
    """The collective-cost model for each config of ``measured`` ({config:
    {N: `measured_step`}}, N = 1 at least) with ``reduced`` ({config:
    `allreduce_bytes`}) and ``alpha`` (`one_rank_allreduce`, or a dict with
    ``alpha_s`` and ``card``), for each cluster of `CLUSTERS`:

    * ring all-reduce seconds of the step's collectives
      (``allreduce_s``: `ring_allreduce_s` with alpha on every hop, a
      pessimistic model) and of their bytes alone (``bandwidth_s``: no
      alpha, an optimistic one);
    * weak scaling (each card steps a whole config): t1 / (t1 + t_ar), no
      overlap, as the root script computes it;
    * strong scaling (the config's pulses split over the cards): t1 / (N x
      (slowest share's step + t_ar)), where the N shares were measured
      (None where not);
    each bound with t_ar = ``allreduce_s`` (``weak_bound``,
    ``strong_bound``) and with t_ar = ``bandwidth_s``
    (``weak_bound_bytes_only``, ``strong_bound_bytes_only``).  ``t1_spread``
    and ``slowest_share_spread``: the slowest of their timed windows over
    the fastest."""
    out = {"kind": "analysis",
           "note": ("arithmetic on measured single-card steps and exact "
                    "all-reduce bytes; ring all-reduce of each collective "
                    "at the stated link rate, no overlap with the backward; "
                    "'allreduce_s' charges alpha, a whole 1-rank call's "
                    "overhead, on every hop (pessimistic), 'bandwidth_s' "
                    "the bytes alone (optimistic); not a measurement of "
                    "several cards"),
           "links": {"nvlink_bytes_s": NVLINK_BYTES_S,
                     "nvlink_source": NVLINK_SOURCE,
                     "node_link_bytes_s": NODE_LINK_BYTES_S,
                     "node_link_source": NODE_LINK_SOURCE},
           "alpha_s": alpha["alpha_s"],
           "alpha_source": ("measured: the least 1-rank all_reduce call "
                            f"on {alpha['card']}, launch and synchronize "
                            "(a per-call overhead, charged on every hop: "
                            "no link latency was measured)"),
           "configs": {}}
    for config, by_world in measured.items():
        t1 = by_world[1]["slowest_step_s"]
        nbytes = list(reduced[config]["leaves"].values())
        cases = {}
        for name, n, rate, link in CLUSTERS:
            share = by_world.get(n)
            case = dict(cards=n, link=link, link_bytes_s=rate,
                        allreduce_s=ring_allreduce_s(nbytes, n, rate,
                                                     alpha["alpha_s"]),
                        bandwidth_s=ring_allreduce_s(nbytes, n, rate, 0.0),
                        slowest_share_s=share and share["slowest_step_s"],
                        slowest_share_spread=share and
                        share["slowest_spread"])
            for suffix, t_ar in (("", case["allreduce_s"]),
                                 ("_bytes_only", case["bandwidth_s"])):
                case["weak_bound" + suffix] = t1 / (t1 + t_ar)
                case["strong_bound" + suffix] = (
                    t1 / (n * (share["slowest_step_s"] + t_ar))
                    if share else None)
            cases[name] = case
        out["configs"][config] = dict(
            measured_on=by_world[1]["card"], t1_s=t1,
            t1_spread=by_world[1]["slowest_spread"],
            rays=by_world[1]["rays"],
            allreduce_bytes=reduced[config]["total"], cases=cases)
    return out


def projection(model: dict, cards: int = CARDS_PER_NODE) -> dict:
    """Rays/s of one node of ``cards`` cards for each config of ``model``
    (`analysis`; the counterpart of `scripts/pod_projection.py`): the
    config's rays split over the cards, so rays / (slowest share's step +
    t_ar) = N x a share's rays over it, beside one card's rays / t1.  None
    where the shares at ``cards`` were not measured."""
    name = next(c[0] for c in CLUSTERS if c[1] == cards)
    out = {"label": (f"PROJECTED: each share measured on one card, the "
                     f"{cards}-card all-reduce modelled (analysis); no "
                     f"node of several cards was run"),
           "cards": cards, "configs": {}}
    for config, m in model["configs"].items():
        case = m["cases"][name]
        one = m["rays"] / m["t1_s"]
        node = (m["rays"] / (case["slowest_share_s"] + case["allreduce_s"])
                if case["slowest_share_s"] is not None else None)
        out["configs"][config] = dict(
            measured_on=m["measured_on"], single_card_rays_s=one,
            node_rays_s=node, speedup=None if node is None else node / one)
    return out


# ---------------------------------------------------------------------------
# the fan on N ranks
# ---------------------------------------------------------------------------

def build_workload(num_pulses: int, device="cuda"):
    """The root script's fan (`bench_scaling.py::build_workload`, :169-193):
    (scene, BVH, sensor config, rays, materials, scalars, sim noise) on
    ``device``, the scene `city_scene(default_rng(11), 64)`, 2 rays a
    pulse, one return, no shiny-surface error, MEASURED shading."""
    dev = resolve_device(device)
    scene = worker.fan_scene()
    bvh = api.build_scene_bvh(scene)
    cfg = worker.fan_config(num_pulses)
    rays = worker.fan_rays(num_pulses, 0, num_pulses).to(dev)
    materials = MaterialLibrary.default().table_at(1064).to(dev)
    return (scene.to(dev), bvh, cfg, rays, materials,
            SimScalars.from_config(cfg, 0.0, dev),
            noise_mod.make_sim_noise(0, device=dev))


def virtual_check(worlds=(1,), pulses_per_rank: int = PULSES_PER_RANK, *,
                  device="cuda", noise=None, timeout: float = 900.0) -> dict:
    """The fan (`build_workload`) on N ranks for each N of ``worlds``,
    pulses_per_rank x N pulses, through `parallel/worker.launch` (one
    process a rank): over NCCL with one rank per card on ``cuda`` (the
    hardware run: it refuses more ranks than cards and never runs
    ``gloo`` instead), or over ``gloo`` with ``device="cpu"`` (all ranks
    share this host's cores, so it checks the collective program, not
    scaling).  Each row holds every rank's step time, each all_reduce's
    ms and bytes, the reduced loss and the loss of the same pulses on one
    rank in this process (no collective).  ``noise`` (the sim-noise
    buffer) goes to the ranks in place of `make_sim_noise(0)`."""
    dev = resolve_device(device)
    hardware = dev.type == "cuda"
    backend = "nccl" if hardware else "gloo"
    if hardware:
        cards = torch.cuda.device_count()
        over = [n for n in worlds if n > cards]
        if over:
            raise RuntimeError(
                f"the hardware check runs one NCCL rank per card: "
                f"{over} ranks asked, {cards} card(s) on this host; it never "
                f"runs gloo instead (device='cpu' is the CPU check)")
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as work:
        npz = os.path.join(work, "fan.npz")
        for n in worlds:
            total = pulses_per_rank * n
            scene, bvh, _, _, mats, _, _ = build_workload(total, dev)
            worker.write_replicated(npz, scene, bvh, mats, noise=noise)
            ranks = worker.launch(n, work, ["fan"], device=dev.type,
                                  backend=backend, pulses=total,
                                  timeout=timeout)
            paths = [r["workloads"]["fan"]["paths"]["packet"] for r in ranks]
            one = worker.run_workload(
                "fan", shard.RayMesh(None, 0, 1, dev), (scene, bvh, mats),
                total, 0, total, noise=worker.read_noise(npz, dev))
            one_loss = float(one["steps"]["packet"][0])
            step_ms = [p["step_ms"] for p in paths]
            rows.append(dict(
                ranks=n, pulses=total, rays=total * worker.FAN_RAYS_PULSE,
                backend=ranks[0]["backend"],
                devices=[r["device"] for r in ranks], step_ms=step_ms,
                rays_per_s=total * worker.FAN_RAYS_PULSE
                / (max(step_ms) * 1e-3),
                all_reduce=[p["all_reduce"] for p in paths],
                reduced_bytes=paths[0]["reduced_bytes"],
                loss=paths[0]["loss"], one_rank_loss=one_loss,
                loss_rel_diff=abs(paths[0]["loss"] - one_loss)
                / max(abs(one_loss), 1e-30)))
            log(f"# [virtual_check] {n} {backend} rank(s): step ms {step_ms}, "
                f"loss {rows[-1]['loss']:.9e} vs one rank {one_loss:.9e}")
    cores = os.cpu_count() or 1
    return {
        "kind": "hardware" if hardware else "virtual-correctness-check",
        "note": (None if hardware else
                 f"the ranks share this host's {cores} cores: this checks "
                 "the collective program (all_reduces, shards, loss "
                 "parity), NOT hardware scaling; see 'analysis'"),
        "device": card_line(dev), "backend": backend,
        "physical_cores": cores, "pulses_per_rank": pulses_per_rank,
        "rays_per_pulse": worker.FAN_RAYS_PULSE, "rows": rows}


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def run(configs=CONFIGS, worlds=WORLDS, *, device="cuda",
        iters: int = STEP_ITERS, windows: int = WINDOWS,
        pulses: int | None = None, num_tris: int | None = None,
        setups: dict | None = None, alpha: dict | None = None,
        check=None) -> dict:
    """Shares, bytes, alpha, analysis and projection for ``configs`` at
    ``worlds`` (1 is always measured).  ``setups`` ({config:
    `ConfigSetup`}, used in place of ``configs`` and freed as they are
    done) reuses workloads built elsewhere; ``alpha`` (a dict with
    ``alpha_s``) stands for `one_rank_allreduce`'s; ``check(config, N,
    measured)`` is called on each `measured_step`.  Raises where the bytes
    `allreduce_bytes` counts differ from those a world-1 step hands to
    `all_reduce` (`step_allreduce_bytes`)."""
    worlds = sorted(set(worlds) | {1})
    if setups is None:
        setups = {c: None for c in configs}
    measured, reduced, setups_s, steps = {}, {}, {}, {}
    card = None
    for config in list(setups):
        setup = setups.pop(config) or config_setup(
            config, device, pulses=pulses, num_tris=num_tris)
        card = setup.card
        setups_s[config] = setup.setup_s
        reduced[config] = allreduce_bytes(config, setup.workload,
                                          setup.num_tris)
        steps[config] = step_allreduce_bytes(setup)
        want = list(reduced[config]["leaves"].values())
        if [b for _, b in steps[config]] != want:
            raise RuntimeError(
                f"{config}: a world-1 sharded_train_step all-reduced "
                f"{steps[config]}, allreduce_bytes counts {want}")
        measured[config] = {}
        for n in worlds:
            m = measured_step(config, n, setup, iters=iters, windows=windows)
            measured[config][n] = m
            log(f"# [{config}] {n} share(s): slowest {m['slowest_step_s']:.4f}"
                f" s (rank {m['slowest_rank']}, windows spread "
                f"{m['slowest_spread']:.3f}), fastest "
                f"{m['fastest_step_s']:.4f} s; {m['card']}")
            if check is not None:
                check(config, n, m)
        del setup
    if alpha is None:
        alpha = one_rank_allreduce(reduced[next(iter(reduced))], device)
    alpha = dict(alpha, card=card)
    model = analysis(measured, reduced, alpha)
    return dict(measured=measured, allreduce_bytes=reduced,
                step_allreduce=steps, alpha=alpha, analysis=model,
                projection=projection(model), setup_s=setups_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lidar_brdf_tpu_torch.bench_scaling",
        description="Multi-card scaling evidence: each rank's share of the "
                    "step measured on this card, the all-reduce modelled.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=os.path.join(
        _REPO_ROOT, "build", "scaling", "scaling.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sizes = CARD_RUN if dev.type == "cuda" else CPU_RUN
    t0 = time.perf_counter()
    bench.kernel_smoke(dev)
    rec = run(sizes.configs, sizes.worlds, device=dev, iters=sizes.iters,
              windows=sizes.windows, pulses=sizes.pulses,
              num_tris=sizes.num_tris)
    rec["virtual_check"] = virtual_check(
        sizes.fan_worlds, sizes.fan_pulses_per_rank, device=dev)
    rec["seconds"] = time.perf_counter() - t0
    card = card_line(dev)
    rec["card"] = card
    model = rec["analysis"]["configs"]
    weak = [c["cases"]["2 nodes"]["weak_bound"] for c in model.values()]
    strong8 = [c["cases"]["8 cards"]["strong_bound"] for c in model.values()]
    bounds = ("allreduce_s", "bandwidth_s", "weak_bound",
              "weak_bound_bytes_only", "slowest_share_s",
              "slowest_share_spread", "strong_bound",
              "strong_bound_bytes_only")
    line = {
        "metric": "weak_scaling_efficiency_bound",
        "value": min(weak),
        "unit": ("fraction, 1 card -> 2 nodes of 8, no overlap, alpha on "
                 "every hop (analysis)"),
        "strong_scaling_efficiency_bound_8_cards": (
            min(strong8) if None not in strong8 else None),
        "card": card,
        "analysis": {k: {n: {f: c[f] for f in bounds}
                         for n, c in m["cases"].items()}
                     | {"t1_s": m["t1_s"], "t1_spread": m["t1_spread"]}
                     for k, m in model.items()},
        "alpha_s": rec["alpha"]["alpha_s"],
        "allreduce_bytes": {k: v["total"]
                            for k, v in rec["allreduce_bytes"].items()},
        "projection": {k: {f: v[f] for f in ("single_card_rays_s",
                                             "node_rays_s")}
                       for k, v in rec["projection"]["configs"].items()},
        "virtual_check": [{f: r[f] for f in ("ranks", "backend", "step_ms",
                                             "loss", "loss_rel_diff")}
                          for r in rec["virtual_check"]["rows"]],
        "record": os.path.relpath(args.out, _REPO_ROOT),
        "runbook": "scripts/gpu_scaling.md",
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({**line, **rec}, fh, indent=1, default=str)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
