"""Simulation orchestrator (counterpart of `lidar_brdf_tpu/runtime/simulate.py`).

`simulate_chunk` maps one chunk of pulses to a dense PointCloud on the
compute device; `Simulator.run` streams power-of-two chunks, culls chunk
i+1 on a worker thread while chunk i runs on the device, reads each chunk
back (compacted on the card: the count, then the valid rows) and
concatenates the clouds on the host (the reference's `arePendingRays`
batching, RayBuilder.cpp:248-262).  Repeat scans of the same rays reuse
culled ladders and buckets kept on the device, the BSP order and the
per-chunk point counts; `Simulator.benchmark` times the stages.
"""

from __future__ import annotations

import contextlib
import hashlib
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


def coherent_order(rays: RayBundle) -> RayBundle:
    """Permute pulses by Morton code of (origin, direction) so consecutive
    pulses — and therefore traversal tiles — are compact angular/spatial
    clusters rather than long scan columns.  Point clouds are order-free
    (every attribute is per-pulse), so no un-permutation is needed.  The
    permutation is the JAX package's (`coherent_order`, numpy on the
    host); the returned bundle lies on the input's device."""
    from ..geom.morton import morton3d_np
    o = as_numpy(rays.origin)[:, 0, :]
    d = as_numpy(rays.direction)[:, 0, :]
    span = lambda a: (a.min(axis=0), np.where(
        a.max(axis=0) - a.min(axis=0) < 1e-9,
        a.min(axis=0) + 1.0, a.max(axis=0)))
    m_d = morton3d_np(d, *span(d)).astype(np.uint64)
    m_o = morton3d_np(o, *span(o)).astype(np.uint64)
    # coarse origin cell first (ALS flight segments), direction within
    key = ((m_o >> np.uint64(12)) << np.uint64(30)) | m_d
    order = torch.from_numpy(np.argsort(key, kind="stable"))
    return RayBundle(**{k: getattr(rays, k)[order.to(getattr(rays, k).device)]
                        for k in ("origin", "direction", "gps_time")})


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


def _put(cache: dict, key, value, limit: int) -> None:
    """Insert into a FIFO-bounded dict, evicting the oldest entries."""
    while len(cache) >= max(limit, 1):
        cache.pop(next(iter(cache)))
    cache[key] = value


def _pad_rows(n: int, cap: int) -> int:
    """A count hint's prefix: ``n`` rounded up to a multiple of 8192 rows
    (at most 0.7 MB more than needed), at most ``cap``."""
    return min(-(-max(n, 1) // 8192) * 8192, cap)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue a copy of a card tensor into pinned host memory (valid after
    the next synchronize); a CPU tensor as it is."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


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
    packed for it once, at its first use.  ``traverse_fn(origin,
    direction) -> Hit``, a caller's traversal, replaces all three: no
    reorder, no cull, every level on it.  ``reorder`` (None = auto: on the
    culled tile path) BSP-orders the pulses; ``noise_buf`` overrides the
    sim-noise buffer (tests pass the JAX one).

    ``compact_readback`` (None = auto: on for ``cuda``, as the JAX package
    turns it on for its accelerator) packs each chunk's valid points on the
    device (`pack_compact`) and reads back the count, then only those rows;
    the cloud then holds the valid points of each chunk in slot order, mask
    all True, as ``dense.compact_host()`` would.  False reads every dense
    slot back.

    Repeat scans (wavelength and parameter sweeps, re-runs) skip work, as
    in the JAX package.  With ``cache_ladders`` each culled chunk's device
    rays and traverse data stay on the device, keyed on the rays' content
    (blake2b of the f32 origin and direction bytes and ``t_max``), the
    ``cache_ladders_max`` newest chunks (FIFO): a hit skips the pad slice,
    the cull and the upload.  The BSP order of the last two bundles is
    kept, and the compacted readback keeps each chunk's last point count
    as a hint: a repeat scan queues the copy of that many rows (rounded up
    to 8,192) with the count, and reads the count first only where the hint
    falls short.  A bundle's content key is memoised on its tensors'
    identity: rebuild or copy a bundle instead of writing its tensors in
    place between runs.
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
    traverse_fn: object = None        # a caller's traversal (no cull)
    cache_ladders: bool = True        # reuse culled chunks across runs
    cache_ladders_max: int = 64       # cached chunks (FIFO; device memory)

    def __post_init__(self):
        from ..api import attach_face_neighbors
        self.device = resolve_device(self.device)
        self.compact_readback = bool(
            self.device.type == "cuda" if self.compact_readback is None
            else self.compact_readback)
        scene = attach_face_neighbors(self.scene)
        self.scene_has_water = bool(
            (as_numpy(scene.comp_surface) & SURFACE_WATER).any())
        self.use_culled = (self.use_culled is not False
                           and self.traverse_fn is None)
        self.packet_fn = None
        self._ladder_cache = {}     # chunk key -> (device rays, data)
        self._bsp_cache = {}        # run key -> BSP-ordered host arrays
        self._ray_key_memo = {}     # tensor ids -> (key, tensors)
        self._count_hints = {}      # (run key, lo, hi) -> points
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
        ``traverse_data`` None sends level 0 through ``traverse_fn``, else
        the packet walk."""
        if traverse_data is not None:
            fn = self.traverser
            walk = self.scene_has_water or bool(self.cfg.bathymetric)
        else:
            fn = self.traverse_fn
            walk = fn is None
        return simulate_chunk(
            self.scene, self.materials if materials is None else materials,
            rays, self.noise_buf, self.scalars, self.cfg,
            base_ray_index=base_ray_index,
            scene_has_water=self.scene_has_water,
            traverse_fn=fn, traverse_data=traverse_data,
            packet_fn=self.packet_walk() if walk else None)

    def _cull(self, sl: dict):
        """(slice, traverse data) of a padded host slice: the data is None
        for the packet walk (no cull, or tile beams or pulse cones too wide
        to cull); the pulse path returns the slice permuted."""
        o, d = sl["origin"], sl["direction"]
        if not (self.use_culled and self.traverser.beams_ok(o, d)):
            return sl, None
        if self.use_pulse:
            return self._prep_pulse(sl)
        return sl, self.traverser.prepare(self.bvh, o, d, t_max=self.t_max)

    def _upload(self, sl: dict) -> RayBundle:
        """A host slice as the chunk's device RayBundle.  Called on the
        worker thread: the copies queue on the default stream, the one
        the chunks run on."""
        return RayBundle(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device, non_blocking=True) for k, v in sl.items()})

    def _prep(self, rays: dict, lo: int, hi: int, chunk: int, metrics=None):
        """Host cull for one padded chunk (worker thread: numpy and the
        native OpenMP culler release the GIL).  Returns the chunk's device
        RayBundle, its traverse data (None for the packet walk: without
        the cull, or where the chunk's tile beams or pulse cones are too
        wide to cull) and the seconds taken.  With ``metrics`` the cull
        and upload are a TRAVERSE_PREP stage."""
        t0 = time.perf_counter()
        sl = _pad_slice(rays, lo, hi, chunk)
        stage = (metrics.stage("TRAVERSE_PREP")
                 if metrics is not None and self.use_culled
                 else contextlib.nullcontext())
        with stage:
            sl, data = self._cull(sl)
            dev = self._upload(sl)
        return dev, data, time.perf_counter() - t0

    def _prep_cached(self, rays: dict, lo: int, hi: int, chunk: int,
                     key: str | None, metrics=None):
        """`_prep` through the ladder cache: (device rays, data, cull
        seconds, key seconds).  ``key`` (the tile path's ``run_key:lo:hi:
        chunk``) is looked up before the slice is cut; without one the
        padded slice is hashed (the pulse path).  Only culled chunks are
        cached (JAX runtime/simulate.py:709-783)."""
        t0 = time.perf_counter()
        if not (self.cache_ladders and self.use_culled):
            return (*self._prep(rays, lo, hi, chunk, metrics), 0.0)
        cache = self._ladder_cache
        key_s = 0.0
        if key is None:
            sl = _pad_slice(rays, lo, hi, chunk)
            key = self._chunk_key(sl["origin"], sl["direction"])
            key_s = time.perf_counter() - t0
        hit = cache.get(key)
        if hit is not None:
            return (*hit, time.perf_counter() - t0 - key_s, key_s)
        dev, data, _ = self._prep(rays, lo, hi, chunk, metrics)
        if data is not None:
            _put(cache, key, (dev, data), self.cache_ladders_max)
        return dev, data, time.perf_counter() - t0 - key_s, key_s

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

    def _chunk_key(self, origin: np.ndarray, direction: np.ndarray) -> str:
        """Content key of rays (the scene and BVH are bound to this
        Simulator): blake2b-16 of the f32 origin and direction bytes and
        ``t_max``, as the JAX package's `_chunk_key`."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(origin, np.float32))
        h.update(np.ascontiguousarray(direction, np.float32))
        h.update(str(self.t_max).encode())
        return h.hexdigest()

    def _ray_key(self, rays: RayBundle, host: dict) -> str:
        """Content key of a whole (unpermuted) bundle, memoised on its
        tensors' identity (hashing 1M pulses takes a quarter of a second);
        the memo holds the tensors, so their ids stay theirs while the
        entry lives.  ``host``: the bundle's arrays on the host."""
        ident = (id(rays.origin), id(rays.direction))
        hit = self._ray_key_memo.get(ident)
        if hit is None:
            hit = (self._chunk_key(host["origin"], host["direction"]),
                   rays.origin, rays.direction)
            _put(self._ray_key_memo, ident, hit, 8)
        return hit[0]

    def run(self, rays: RayBundle, checkpoint_dir: str | None = None,
            metrics=None, materials: MaterialTable | None = None,
            stats: dict | None = None) -> PointCloud:
        """All pulses in power-of-two chunks (in BSP order with
        ``reorder``); returns a host (CPU) PointCloud.

        ``checkpoint_dir``: each finished chunk is saved there
        (`runtime/checkpoint.py`, the JAX package's files), and a restarted
        run resumes after the last completed chunk.  ``metrics`` (a
        `PipelineMetrics`): each chunk's device work (to a synchronize) is
        a TOTAL stage, each cull a TRAVERSE_PREP stage.  ``materials``
        re-binds the material tables for this run (the reference's
        per-wavelength re-bind, `LiDARSimulation.cpp:303,428-437`).
        ``stats``, when given, accumulates seconds of host gather, BSP
        reorder and ray-content keys (``order_s``), host cull and upload
        (``cull_s``; a ladder-cache hit culls nothing), device work
        (``device_s``, host clock to a synchronize; with
        ``compact_readback`` the packing too, and a count hint's queued
        copy), readback (``readback_s``) and the bytes read back
        (``readback_bytes``)."""
        if materials is not None:
            materials = materials.to(self.device)
        t0 = time.perf_counter()
        host = {k: as_numpy(getattr(rays, k))
                for k in ("origin", "direction", "gps_time")}
        run_key = None
        if self.reorder:
            run_key = self._ray_key(rays, host)
            hit = self._bsp_cache.get(run_key)
            if hit is None:
                order = bsp_order(rays, self.block_pulses)
                hit = {k: v[order] for k, v in host.items()}
                _put(self._bsp_cache, run_key, hit, 2)
            host = hit
        order_s = time.perf_counter() - t0
        P = rays.num_pulses
        R = rays.rays_per_pulse
        chunk = min(self.cfg.chunk_pulses, 1 << max(P - 1, 1).bit_length())
        if self.use_pulse:          # a group never straddles two chunks
            chunk = max(chunk, self.pulse_group)
        ckpt, clouds = None, []
        if checkpoint_dir is not None:
            from .checkpoint import ChunkCheckpointer
            ckpt = ChunkCheckpointer(checkpoint_dir)
            clouds = [ckpt.load_chunk(i)
                      for i in range(ckpt.completed_chunks())]
        spans = [(ci, lo, min(lo + chunk, P))
                 for ci, lo in enumerate(range(0, P, chunk))
                 if ci >= len(clouds)]
        timing = dict(order_s=order_s, cull_s=0.0, device_s=0.0,
                      readback_s=0.0, readback_bytes=0)
        hints = self._count_hints
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))

        def prep(lo, hi):
            key = None if run_key is None else f"{run_key}:{lo}:{hi}:{chunk}"
            return pool.submit(self._prep_cached, host, lo, hi, chunk, key,
                               metrics)

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = prep(*spans[0][1:]) if spans else None
            for k, (ci, lo, hi) in enumerate(spans):
                sl, data, cull_s, key_s = fut.result()
                timing["cull_s"] += cull_s
                timing["order_s"] += key_s
                if k + 1 < len(spans):       # cull the next chunk meanwhile
                    fut = prep(*spans[k + 1][1:])
                hint_key = None if run_key is None else (run_key, lo, hi)
                stage = (metrics.stage("TOTAL") if metrics is not None
                         else contextlib.nullcontext())
                with stage:
                    t0 = time.perf_counter()
                    cloud = self.run_chunk(sl, lo * R, data, materials)
                    pre = None
                    if self.compact_readback:
                        rows, count = pack_compact(cloud)
                        hint = hints.get(hint_key)
                        if hint is not None:   # queue rows and count
                            pre = _to_host(
                                rows[:_pad_rows(hint, rows.shape[0])])
                            count = _to_host(count)
                    sync()
                t1 = time.perf_counter()
                if self.compact_readback:
                    n = int(count)
                    if hint_key is not None:
                        _put(hints, hint_key, n, 4 * max(len(spans), 8))
                    moved = 0 if pre is None else pre.shape[0]
                    if pre is None or pre.shape[0] < n:
                        pre = rows[:n].cpu()       # count, then the rows
                        moved += n
                    cloud = unpack_compact(pre[:n])
                    nbytes = (count.element_size()
                              + moved * rows.shape[1] * 4)
                else:
                    cloud = cloud.to("cpu")
                    nbytes = sum(v.nbytes for v in vars(cloud).values())
                t2 = time.perf_counter()
                clouds.append(cloud)
                if ckpt is not None:
                    ckpt.save_chunk(ci, cloud)
                timing["device_s"] += t1 - t0
                timing["readback_s"] += t2 - t1
                timing["readback_bytes"] += nbytes
        if stats is not None:
            for key, val in timing.items():
                stats[key] = stats.get(key, 0) + val
        return concat_pointclouds(clouds)

    def coherent_order(self, rays: RayBundle) -> RayBundle:
        return coherent_order(rays)

    def benchmark(self, rays: RayBundle, num_execs: int = 5,
                  discard_first: bool = True, steady_chunks: int = 2):
        """The reference's numExecs repetition mode with per-stage
        mean +- std (`LiDARSimulation.cpp:292-365`, `PipelineMetrics.h:
        19-30`), as the JAX package's `Simulator.benchmark`.

        On the first ``cfg.chunk_pulses`` pulses, ``num_execs`` times:
        RAY_BUILDING (the slice, BSP-ordered with ``reorder``),
        TRAVERSE_PREP (the host cull; with the cull only), FIND_COLLISION
        (the culled traverser, else the packet walk), REDUCE
        (`simulate_returns` on those hits) and INTENSITY (`shade_records`;
        both skipped on water and bathymetric scans, whose bounce levels
        traverse again), TOTAL (`run_chunk`) and READ (to the host).  Then
        ``steady_chunks`` >= 2 chunks through `run` per exec with the
        ladder cache off: RUN_FIRST is the first pass, RUN_STEADY the
        others, RUN_CHUNK_TOTAL / RUN_CHUNK_PREP their per-chunk samples;
        the footer gives rays/s and points/s.  Returns the
        `PipelineMetrics`."""
        from .metrics import PipelineMetrics
        metrics = PipelineMetrics(discard_first=discard_first)
        P = min(self.cfg.chunk_pulses, rays.num_pulses)
        R = rays.rays_per_pulse
        retraverse = self.scene_has_water or bool(self.cfg.bathymetric)
        for _ in range(num_execs):
            with metrics.stage("RAY_BUILDING"):
                sl = {k: as_numpy(getattr(rays, k))[:P]
                      for k in ("origin", "direction", "gps_time")}
                if self.reorder:
                    order = bsp_order(RayBundle(**sl), self.block_pulses)
                    sl = {k: v[order] for k, v in sl.items()}
            data = None
            if self.use_culled:
                with metrics.stage("TRAVERSE_PREP"):
                    sl, data = self._cull(sl)
            rs = self._upload(sl)
            with metrics.stage("FIND_COLLISION") as m:
                if data is not None:
                    hits = self.traverser(rs.origin, rs.direction, data)
                elif self.traverse_fn is not None:
                    hits = self.traverse_fn(rs.origin, rs.direction)
                else:
                    hits = self.packet_walk()(rs.origin, rs.direction)
                m["sync"] = hits.t
            if not retraverse:
                with metrics.stage("REDUCE") as m:
                    records, _, _, _ = simulate_returns(
                        self.scene, self.materials, rs, self.noise_buf,
                        self.scalars, self.cfg,
                        traverse_fn=lambda o, d: hits, scene_has_water=False)
                    m["sync"] = records.distance
                with metrics.stage("INTENSITY") as m:
                    m["sync"] = shade_records(
                        self.scene, self.materials, records, records.start,
                        self.scalars, self.cfg, R)
            with metrics.stage("TOTAL") as m:
                cloud = self.run_chunk(rs, 0, data)
                m["sync"] = cloud.intensity
            with metrics.stage("READ"):
                cloud.to("cpu")
        if steady_chunks and steady_chunks > 1:
            P_run = min(self.cfg.chunk_pulses * steady_chunks,
                        rays.num_pulses)
            head = RayBundle(**{k: getattr(rays, k)[:P_run]
                                for k in ("origin", "direction",
                                          "gps_time")})
            n_chunks = -(-P_run // self.cfg.chunk_pulses)
            cache_prev = self.cache_ladders
            self.cache_ladders = False        # a real cull every pass
            try:
                for i in range(num_execs):
                    chunk_m = PipelineMetrics()
                    with metrics.stage("RUN_FIRST" if i == 0
                                       else "RUN_STEADY"):
                        cloud = self.run(head, metrics=chunk_m)
                    if i > 0:      # per-chunk samples from steady passes
                        metrics.samples["RUN_CHUNK_TOTAL"].extend(
                            chunk_m.samples.get("TOTAL", []))
                        metrics.samples["RUN_CHUNK_PREP"].extend(
                            chunk_m.samples.get("TRAVERSE_PREP", []))
                n_points = int(cloud.mask.sum())
            finally:
                self.cache_ladders = cache_prev
            steady = metrics.samples.get("RUN_STEADY", [])
            if steady:
                run_s = sum(steady) / len(steady)
                metrics.footer = (
                    f"steady-state: {n_chunks} chunks x "
                    f"{self.cfg.chunk_pulses} pulses, {n_points} points, "
                    f"{P_run * R / run_s / 1e6:.2f}M rays/s, "
                    f"{n_points / run_s / 1e6:.2f}M points/s (RUN_FIRST "
                    f"includes the kernel builds)")
        return metrics
