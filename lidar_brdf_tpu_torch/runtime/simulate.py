"""Simulation orchestrator (counterpart of `lidar_brdf_tpu/runtime/simulate.py`).

`simulate_chunk` maps one chunk of pulses to a dense PointCloud on the
compute device; `Simulator.run` streams power-of-two chunks, culls chunk
i+1 on a worker thread while chunk i runs on the device, reads each chunk
back (compacted on the card: the count, then the valid rows) and
concatenates the clouds on the host (the reference's `arePendingRays`
batching, RayBuilder.cpp:248-262).
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import SensorConfig
from ..core.types import (BVH, MaterialTable, PointCloud, RayBundle,
                          SURFACE_WATER, TriangleScene, as_numpy,
                          concat_pointclouds, pack_compact, resolve_device,
                          unpack_compact)
from ..geom.packet import make_packet_traverser
from ..kernels.pulse import (PulseLadderTraverser, build_pulse_ladders,
                             permute_pulse_ladders, renumber_pulse_ladders,
                             uncovered_groups)
from ..kernels.traverse import TileTraverser
from ..physics.returns import (SimScalars, final_winner_origins,
                               simulate_returns)
from ..physics.shading import shade_records
from ..physics.types import OutlierRecord, ReturnRecord
from ..utils import noise as noise_mod


def bsp_order(rays: RayBundle, block_pulses: int = 64) -> np.ndarray:
    """Pulse permutation into contiguous blocks of small angular/spatial
    extent (recursive median split), so beam-cull tiles stay narrow.
    Point clouds are order-free, so nothing is un-permuted."""
    from ..geom.beamcull import bsp_order_np
    o = as_numpy(rays.origin)[:, 0, :]
    d = as_numpy(rays.direction)[:, 0, :]
    o_ext = max(float((o.max(axis=0) - o.min(axis=0)).max()), 1e-9)
    feat = np.concatenate([d, (o - o.min(axis=0)) * (2.0 / o_ext)], axis=1)
    return bsp_order_np(feat, block_pulses)


# Scenes above this many faces take the pulse ladders (K2), smaller ones the
# tile kernel (K1): the JAX package's threshold (runtime/simulate.py:232).
PULSE_MIN_FACES = 100_000


def pick_pulse_ladders(num_faces: int, use_pulse: bool | None = None) -> bool:
    """The traverser choice: ``use_pulse`` when given, else pulse ladders
    for scenes of more than `PULSE_MIN_FACES` faces.

    The JAX package applies this rule on a TPU only (elsewhere it takes its
    XLA tile path); the port applies it on ``cuda`` and ``cpu`` alike, so
    that a card run and a CPU run take the same path.  The threshold was
    measured on a TPU; `chip_smoke.py` records K1 vs K2 on the card for a
    rule of the port's own.
    """
    if use_pulse is not None:
        return bool(use_pulse)
    return num_faces > PULSE_MIN_FACES


def records_to_pointcloud(scene: TriangleScene, records: ReturnRecord,
                          outliers: OutlierRecord, num_returns: torch.Tensor,
                          intensity: torch.Tensor,
                          include_outliers: bool) -> PointCloud:
    """Flatten (levels, pulses) record slots into a dense PointCloud."""
    L, P = records.mask.shape
    flat = lambda a: a.reshape((L * P,) + tuple(a.shape[2:]))
    comp = flat(records.comp)
    sem_rows = torch.stack([scene.comp_semantic, scene.comp_asprs],
                           dim=1)[torch.clamp(comp, min=0).long()]
    has = comp >= 0
    cloud = PointCloud(
        position=flat(records.point),
        normal=flat(records.normal),
        uv=flat(records.uv),
        intensity=flat(intensity),
        distance=flat(records.distance),
        return_number=flat(records.return_number),
        num_returns=flat(torch.broadcast_to(num_returns[None, :], (L, P))),
        scan_angle_rank=flat(records.angle),
        scan_direction=flat(records.direction),
        gps_time=flat(records.gps_time),
        comp_id=comp,
        semantic=torch.where(has, sem_rows[:, 0], -1),
        asprs=torch.where(has, sem_rows[:, 1], -1),
        mask=flat(records.mask),
    )
    if not include_outliers:
        return cloud
    K = L * P
    dev = comp.device
    zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    fi = lambda v: torch.full((K,), v, dtype=torch.int32, device=dev)
    out = PointCloud(
        position=flat(outliers.point), normal=zf(K, 3), uv=zf(K, 2),
        intensity=zf(K), distance=flat(outliers.distance),
        return_number=fi(0), num_returns=fi(1), scan_angle_rank=zf(K),
        scan_direction=zf(K, 3), gps_time=zf(K), comp_id=fi(-1),
        semantic=fi(-1), asprs=fi(7),              # ASPRS NOISE
        mask=flat(outliers.mask))
    return concat_pointclouds([cloud, out])


def simulate_chunk(scene: TriangleScene, materials: MaterialTable,
                   rays: RayBundle, noise_buf: torch.Tensor,
                   scalars: SimScalars, cfg: SensorConfig, *,
                   base_ray_index: int = 0, scene_has_water: bool = True,
                   traverse_fn=None, traverse_data=None, face_pack=None,
                   packet_fn=None) -> PointCloud:
    """Differentiable pass for one chunk of pulses.

    A caller that hands in ``scene.vertices``, ``materials.brdf_table``,
    ``rays.origin`` or a scalar with ``requires_grad`` gets gradients
    through the record pass and shading.  The traversal itself is
    forward-only (its kernels see detached rays), as the JAX package stops
    gradients before its Pallas kernels.  ``scene_has_water`` (True unless
    the caller knows the scene has no water surface, as in the JAX
    package), ``traverse_fn``, ``traverse_data``, ``face_pack`` and
    ``packet_fn`` as in `simulate_returns`.
    """
    records, outliers, num_returns, final_origin = simulate_returns(
        scene, materials, rays, noise_buf, scalars, cfg,
        base_ray_index=base_ray_index, traverse_fn=traverse_fn,
        traverse_data=traverse_data, scene_has_water=scene_has_water,
        face_pack=face_pack, packet_fn=packet_fn)
    # shading reads the winner origins after the bounce loop
    # (`computeColor-comp.glsl:88,96`); water-free, non-bathymetric scenes
    # never move an origin, so there it is the recorded start point
    if scene_has_water or cfg.bathymetric:
        fo = final_winner_origins(records, final_origin)
    else:
        fo = records.start
    intensity = shade_records(scene, materials, records, fo, scalars, cfg,
                              rays.rays_per_pulse)
    return records_to_pointcloud(scene, records, outliers, num_returns,
                                 intensity, cfg.include_outliers)


def _pad_slice(rays: dict, lo: int, hi: int, chunk: int) -> dict:
    """Host slice [lo, hi) padded to ``chunk`` pulses: padded pulses sit
    far outside the scene with zero direction, so the cull ignores them and
    they never hit."""
    sl = {k: v[lo:hi] for k, v in rays.items()}
    pad = chunk - (hi - lo)
    if pad:
        o, d, g = sl["origin"], sl["direction"], sl["gps_time"]
        sl = dict(
            origin=np.concatenate(
                [o, np.full((pad,) + o.shape[1:], 1e10, o.dtype)]),
            direction=np.concatenate(
                [d, np.zeros((pad,) + d.shape[1:], d.dtype)]),
            gps_time=np.concatenate([g, np.zeros(pad, g.dtype)]))
    return sl


@dataclass
class Simulator:
    """Bind scene + config; stream chunks of pulses through the device.

    Three traversals.  With the host cull (``use_culled``, the default),
    two, chosen by `pick_pulse_ladders` (``use_pulse``):

    * tile path (scenes of up to 100k faces): pulses are BSP-reordered into
      coherent 640-ray tiles, the host culls per-chunk candidate buckets,
      and the CUDA tile kernel K1 (its plain version on ``cpu``) intersects
      them;
    * pulse path (larger scenes): no reorder; the host culls each pulse
      group's cone into a candidate ladder (`kernels/pulse.py`) and the
      CUDA ladder kernel K2 (its plain version on ``cpu``) intersects them.
      Each chunk's pulses are put in bucket-contiguous order
      (`permute_pulse_ladders`) before upload, so every pulse sits in the
      slot, and draws the noise, it has in the JAX package's `Simulator`.

    The third is the packet walk over the whole tree (`geom/packet.py`, the
    CUDA kernel K4 on the card): every chunk with ``use_culled=False`` (no
    reorder, no host cull), a chunk whose tile beams or pulse cones are too
    wide to cull, and the refracted bounce levels of water scenes and of
    bathymetric mode (level 0 stays culled: the hybrid).  The scene is
    packed for it once, at its first use.  ``reorder`` (None = auto: on the
    culled tile path) BSP-orders the pulses; ``noise_buf`` overrides the
    sim-noise buffer (tests pass the JAX one).

    ``compact_readback`` (None = auto: on for ``cuda``, as the JAX package
    turns it on for its accelerator) packs each chunk's valid points on the
    device (`pack_compact`) and reads back the count, then only those rows;
    the cloud then holds the valid points of each chunk in slot order, mask
    all True, as ``dense.compact_host()`` would.  False reads every dense
    slot back.
    """

    scene: TriangleScene
    bvh: BVH
    materials: MaterialTable
    cfg: SensorConfig
    device: object = "cuda"
    noise_buf: torch.Tensor | None = None
    use_pulse: bool | None = None     # None = auto (`pick_pulse_ladders`)
    pulse_group: int | None = None    # pulses per shared ladder (None = 1)
    use_culled: bool | None = None    # False: the packet walk for every chunk
    reorder: bool | None = None       # None = auto (the culled tile path)
    compact_readback: bool | None = None  # None = auto (on for cuda)

    def __post_init__(self):
        from ..api import attach_face_neighbors
        self.device = resolve_device(self.device)
        self.compact_readback = bool(
            self.device.type == "cuda" if self.compact_readback is None
            else self.compact_readback)
        scene = attach_face_neighbors(self.scene)
        self.scene_has_water = bool(
            (as_numpy(scene.comp_surface) & SURFACE_WATER).any())
        self.use_culled = self.use_culled is not False
        self.packet_fn = None
        scene_min_y = float(as_numpy(scene.vertices)[:, 1].min())
        self.scene = scene.to(self.device)
        self.materials = self.materials.to(self.device)
        self.scalars = SimScalars.from_config(self.cfg, scene_min_y,
                                              self.device)
        if self.noise_buf is None:
            self.noise_buf = noise_mod.make_sim_noise(self.cfg.seed)
        self.noise_buf = self.noise_buf.to(self.device)
        b0, b1 = self.cfg.max_range_soft_boundary
        self.t_max = float(self.cfg.max_range + abs(b0) + abs(b1) + 1.0)
        rpp = max(self.cfg.rays_per_pulse, 1)
        self.use_pulse = self.use_culled and pick_pulse_ladders(
            scene.num_faces, self.use_pulse)
        # BSP order only with the cull; auto: the tile path (the natural
        # scan order is coherent per pulse)
        self.reorder = self.use_culled and bool(
            not self.use_pulse if self.reorder is None else self.reorder)
        self.traverser = None
        if not self.use_culled:
            self.block_pulses = None
        elif self.use_pulse:
            self.block_pulses = max(1, 640 // rpp)
            # a power of two that divides chunk_pulses, so it divides every
            # chunk `run` dispatches (JAX runtime/simulate.py:259-263)
            grp = self.pulse_group if self.pulse_group is not None else 1
            grp = 1 << max(int(grp).bit_length() - 1, 0)
            while grp > 1 and self.cfg.chunk_pulses % grp:
                grp //= 2
            self.pulse_group = grp
            self.traverser = PulseLadderTraverser(
                scene, rays_per_pulse=rpp, group=grp,
                device=self.device)
            self.traverser.t_max = self.t_max
        else:
            step = 128 // math.gcd(128, rpp)    # tile_rays % 128 == 0
            bp0 = max(1, 640 // rpp)
            self.block_pulses = ((bp0 + step - 1) // step) * step
            self.traverser = TileTraverser(
                scene, tile_rays=self.block_pulses * rpp,
                device=self.device)

    def packet_walk(self):
        """The packet walk over the scene (`make_packet_traverser`): packed
        at the first call, then kept in ``packet_fn``."""
        if self.packet_fn is None:
            self.packet_fn = make_packet_traverser(self.scene, self.bvh)
        return self.packet_fn

    def run_chunk(self, rays: RayBundle, base_ray_index: int, traverse_data,
                  materials: MaterialTable | None = None) -> PointCloud:
        """One padded chunk on the device; returns a device PointCloud.
        ``traverse_data`` None sends level 0 through the packet walk."""
        culled = traverse_data is not None
        walk = (not culled or self.scene_has_water
                or bool(self.cfg.bathymetric))
        return simulate_chunk(
            self.scene, self.materials if materials is None else materials,
            rays, self.noise_buf, self.scalars, self.cfg,
            base_ray_index=base_ray_index,
            scene_has_water=self.scene_has_water,
            traverse_fn=self.traverser if culled else None,
            traverse_data=traverse_data,
            packet_fn=self.packet_walk() if walk else None)

    def _prep(self, rays: dict, lo: int, hi: int, chunk: int):
        """Host cull for one padded chunk (worker thread: numpy and the
        native OpenMP culler release the GIL).  Returns the chunk's device
        RayBundle, its traverse data (None for the packet walk: without
        the cull, or where the chunk's tile beams or pulse cones are too
        wide to cull) and the seconds taken."""
        t0 = time.perf_counter()
        sl = _pad_slice(rays, lo, hi, chunk)
        o, d = sl["origin"], sl["direction"]
        data = None
        if self.use_culled and self.traverser.beams_ok(o, d):
            if self.use_pulse:
                sl, data = self._prep_pulse(sl)
            else:
                data = self.traverser.prepare(self.bvh, o, d,
                                              t_max=self.t_max)
        dev = RayBundle(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in sl.items()})
        return dev, data, time.perf_counter() - t0

    def _prep_pulse(self, sl: dict):
        """Pulse-path cull of a padded host slice, as the JAX package's
        `_prep_slice` does it (runtime/simulate.py:741-768): ladders, then
        the bucket-contiguous pulse order, expanded by the group and applied
        to the slice before upload.  The JAX package needs that order to
        replace TPU scatter by slices (`PermutedLayout`, one executable per
        layout); K2 writes through ``pidx``, so here it only keeps every
        pulse in the JAX package's slot, and the buckets are renumbered to
        the new order instead."""
        tr = self.traverser
        R = tr.kernel_rays
        o2 = sl["origin"].reshape(-1, 3)
        raw = build_pulse_ladders(self.bvh, o2, sl["direction"].reshape(-1, 3),
                                  R, t_max=self.t_max)
        perm, layout = permute_pulse_ladders(raw, o2.shape[0] // R)
        grp = tr.group
        gperm = perm if grp == 1 else (
            (perm[:, None] * grp + np.arange(grp)[None, :]).reshape(-1))
        sl = {k: v[gperm] for k, v in sl.items()}
        return sl, tr.upload(renumber_pulse_ladders(raw, perm),
                             uncovered_groups(layout, perm.shape[0]))

    def run(self, rays: RayBundle, materials: MaterialTable | None = None,
            stats: dict | None = None) -> PointCloud:
        """All pulses in power-of-two chunks (in BSP order with
        ``reorder``); returns a host (CPU) PointCloud.  ``stats``, when given,
        accumulates seconds of host gather and BSP reorder (``order_s``),
        host cull (``cull_s``), device work (``device_s``, host clock to a
        synchronize; with ``compact_readback`` the packing too), readback
        (``readback_s``) and the bytes read back (``readback_bytes``)."""
        if materials is not None:
            materials = materials.to(self.device)
        t0 = time.perf_counter()
        host = {k: as_numpy(getattr(rays, k))
                for k in ("origin", "direction", "gps_time")}
        if self.reorder:
            order = bsp_order(rays, self.block_pulses)
            host = {k: v[order] for k, v in host.items()}
        order_s = time.perf_counter() - t0
        P = rays.num_pulses
        R = rays.rays_per_pulse
        chunk = min(self.cfg.chunk_pulses, 1 << max(P - 1, 1).bit_length())
        if self.use_pulse:          # a group never straddles two chunks
            chunk = max(chunk, self.pulse_group)
        spans = [(lo, min(lo + chunk, P)) for lo in range(0, P, chunk)]
        timing = dict(order_s=order_s, cull_s=0.0, device_s=0.0,
                      readback_s=0.0, readback_bytes=0)
        clouds = []
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._prep, host, *spans[0], chunk)
            for k, (lo, hi) in enumerate(spans):
                sl, data, cull_s = fut.result()
                timing["cull_s"] += cull_s
                if k + 1 < len(spans):       # cull the next chunk meanwhile
                    fut = pool.submit(self._prep, host, *spans[k + 1], chunk)
                t0 = time.perf_counter()
                cloud = self.run_chunk(sl, lo * R, data, materials)
                if self.compact_readback:
                    rows, count = pack_compact(cloud)
                sync()
                t1 = time.perf_counter()
                if self.compact_readback:
                    n = int(count)           # the count first, then rows
                    cloud = unpack_compact(rows[:n].cpu())
                    nbytes = count.element_size() + n * rows.shape[1] * 4
                else:
                    cloud = cloud.to("cpu")
                    nbytes = sum(v.nbytes for v in vars(cloud).values())
                clouds.append(cloud)
                timing["device_s"] += t1 - t0
                timing["readback_s"] += time.perf_counter() - t1
                timing["readback_bytes"] += nbytes
        if stats is not None:
            for key, val in timing.items():
                stats[key] = stats.get(key, 0) + val
        return concat_pointclouds(clouds)
