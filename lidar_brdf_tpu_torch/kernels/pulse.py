"""Pulse-ladder traverser: host cull half + the hand-written CUDA kernel (K2).

Counterpart of `lidar_brdf_tpu/kernels/pulse_pallas.py`, the traversal the
JAX package takes on dense scenes scanned by structured pulses (the `als`
workload's 5M-face terrain), where one 640-ray tile's beam would cover
thousands of triangles but one pulse's narrow cone covers a handful.

* Cull half (`PulseLadderTraverser.prepare`, `prepare_permuted`): each
  pulse group's bounding cone (`geom/beamcull.py::tile_beams_torch`) is
  culled against the BVH on the rays' device by K5
  (`kernels/cull.py::beam_cull`) into a near-to-far candidate ladder;
  `ladders_from_lists` buckets the ladders by padded size K = 8 * 2**k,
  `permute_ladders_torch` and `renumber_ladders_torch` give the JAX
  package's bucket-contiguous pulse order.  The host functions
  (`build_pulse_ladders`, `permute_pulse_ladders`,
  `renumber_pulse_ladders`) are the JAX package's, bit-equal to it, and
  the device ones are bit-equal to them on the same lists.
* Device half (`pulse_traverse`): the nearest (t, face) of every ray of
  every group against the group's ladder, all buckets in one call.  On a
  CUDA tensor it launches `csrc/pulse_traverse.cu` once over the work list
  `pulse_schedule` makes (built with nvcc at first use into
  `build/kernels/`, loaded with ctypes); on a CPU tensor it runs
  `pulse_traverse_plain`, the same semantics in plain PyTorch.  It never
  falls back from one to the other.

What the TPU layout needed and the card does not: the JAX package copies
every candidate's 12-float Wald row per pulse into an (NB, KB, 12, 8, 128)
block on the host (`_pack_bucket`, ~400 MB per 1M pulses at K = 8), and
reorders pulses bucket-contiguously so that results come back by slicing
(`PermutedLayout`, one compiled executable per layout) because TPU scatter
is slow.  Here a bucket on the device is just ``(pidx (B,) i32, cand (B, K)
i32)``: the kernel gathers rows from the (F, 12) Wald table itself and
writes through ``pidx``.  `PulseLadderTraverser.prepare_sharded` gives one
rank of a multi-process scan its own ladders (`parallel/shard.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch.distributed import ReduceOp

from ..core.types import BVH, Hit, TriangleScene, as_numpy, resolve_device
from ..geom.beamcull import (_collect_candidates, beams_are_narrow,
                             tile_beams, wald_rows_np)
from ..geom.intersect import BIG
from ..runtime.metrics import span, upload
from .cuda_build import CudaLibrary, check_tensor, raw_stream
from .cull import NodeCache, bucket_rows, cull_rays
from .traverse import (CAND_BLOCK, INT_MISS,  # noqa: F401  (JAX's name)
                       default_t_max, wald_blocks_plain)

LANES = 128          # bucket rows are padded to a multiple of this
MAX_THREADS = 128    # K2 (csrc/pulse_traverse.cu): threads of a block,
MAX_ROWS = 32        # bucket rows of a block at most,
STAGE = 16           # candidates of a row staged at a time,
MAX_BUCKETS = 32     # buckets of a launch,
ARGS_PER_BUCKET = 5  # int64 launch arguments of a bucket


def _declare(lib):
    vp, ci, cf, cl = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int64)
    lib.lbt_pulse_traverse.argtypes = [
        vp, vp, vp, ci, ci, cf, vp, vp, ci, ctypes.POINTER(cl), ci, ci, ci,
        cl, cl, vp]
    lib.lbt_pulse_traverse.restype = ci


KERNEL = CudaLibrary("pulse_traverse.cu", _declare, "lbt_pulse_traverse")


class PulseSchedule(NamedTuple):
    """K2's work list for one call (`pulse_schedule`)."""
    entries: tuple        # (index, B, K, first_block) per bucket, in order
    n_blocks: int         # row blocks of the buckets (the grid's x)
    rows_per_block: int   # bucket rows a block takes (the block's y)
    slice_rays: int       # rays of a row a block takes (the block's x)
    slices: int           # blocks per row block (the grid's y)


def pulse_schedule(buckets, kernel_rays: int) -> PulseSchedule:
    """K2's work list for one call, from the bucket shapes alone (no device
    read).

    A block of (``slice_rays``, ``rows_per_block``) threads takes
    consecutive rows of one bucket, one thread per ray: as many whole
    groups of ``kernel_rays`` rays as fit in 128 threads, at most 32 rows
    (the rows it stages in shared memory).  A group of more than 128 rays
    is cut into ``slices`` of 128, one block each.  Buckets with rows and
    candidates run longest ladders first (ties keep the input order), their
    row blocks end to end.  A dummy row (pidx outside [0, P)) can only be
    told on the device, where its threads load and write nothing.  Raises
    ValueError for more buckets than the kernel's parameter block holds.
    """
    shape = [tuple(b[1].shape) for b in buckets]
    order = sorted((i for i, (B, K) in enumerate(shape) if B and K),
                   key=lambda i: -shape[i][1])
    if len(order) > MAX_BUCKETS:
        raise ValueError(f"{len(order)} buckets: K2 takes at most "
                         f"{MAX_BUCKETS} in one call")
    slice_rays = min(kernel_rays, MAX_THREADS)
    rows = max(1, min(MAX_THREADS // slice_rays, MAX_ROWS))
    entries, first = [], 0
    for i in order:
        B, K = shape[i]
        entries.append((i, B, K, first))
        first += -(-B // rows)
    return PulseSchedule(tuple(entries), first, rows, slice_rays,
                         -(-kernel_rays // slice_rays))


class PulseLadders(tuple):
    """One chunk's device buckets, ``(pidx, cand)`` each, as a tuple, with
    ``uncovered``: the range ``(lo, hi)`` of groups in no bucket when every
    other group has exactly one real row (the bucket-contiguous layout of
    `permute_pulse_ladders` + `renumber_pulse_ladders`), else None."""

    def __new__(cls, buckets, uncovered=None):
        self = super().__new__(cls, buckets)
        self.uncovered = uncovered
        return self


# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------

def build_pulse_ladders(bvh: BVH, origins: np.ndarray, directions: np.ndarray,
                        rays_per_pulse: int, *, t_max: float,
                        pad_to: int = CAND_BLOCK):
    """Host cull: per-pulse candidate lists, bucketed by padded size K.

    Returns a tuple of (pidx (Bp,) int32, cand (Bp, K) int32) buckets with
    K = pad_to * 2^k and Bp a multiple of 128 (padding rows: pidx =
    num_pulses, cand = -1).  Candidates are near-to-far sorted along the
    pulse axis (same contract as `build_bucketed_candidates`).
    """
    o = np.asarray(origins, np.float64).reshape(-1, 3)
    d = np.asarray(directions, np.float64).reshape(-1, 3)
    if o.shape[0] % rays_per_pulse:
        raise ValueError("ray count not a multiple of rays_per_pulse")
    beams = tile_beams(o, d, rays_per_pulse)
    num_pulses = beams.center.shape[0]
    tiles, faces_out, counts = _collect_candidates(bvh, beams, t_max)
    offsets = np.zeros(num_pulses + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    padded = np.maximum(
        pad_to * (2 ** np.ceil(np.log2(np.maximum(
            (counts + pad_to - 1) // pad_to, 1))).astype(np.int64)),
        pad_to)
    buckets = []
    for size in np.unique(padded[counts > 0]):
        pidx = ((padded == size) & (counts > 0)).nonzero()[0]
        B = pidx.shape[0]
        B_pad = -(-B // LANES) * LANES
        cand = np.full((B_pad, int(size)), -1, np.int32)
        # vectorized ragged fill (a per-pulse Python loop costs seconds at
        # 1M pulses)
        cnt = counts[pidx].astype(np.int64)
        rows = np.repeat(np.arange(B, dtype=np.int64), cnt)
        ends = np.cumsum(cnt)
        cols = np.arange(ends[-1] if B else 0, dtype=np.int64) \
            - np.repeat(ends - cnt, cnt)
        cand[rows, cols] = faces_out[np.repeat(offsets[pidx], cnt) + cols]
        pidx_arr = np.full(B_pad, num_pulses, np.int32)
        pidx_arr[:B] = pidx
        buckets.append((pidx_arr, cand))
    return tuple(buckets)


def permute_pulse_ladders(buckets, num_pulses: int):
    """Bucket-contiguous pulse order, as the JAX package orders pulses.

    Returns ``(perm, layout)``: ``perm`` (num_pulses,) int64 — new pulse i
    is old pulse ``perm[i]``, zero-candidate pulses at the tail — and
    ``layout`` a tuple of ``(start, B, B_pad)`` per bucket (B real pulses
    at [start, start+B) in the new order).  The `Simulator` reorders its
    pulses by ``perm`` so that every pulse sits in the slot (and draws the
    noise) it has in the JAX package; `renumber_pulse_ladders` then points
    the buckets at the new slots.
    """
    perm_parts, layout, start = [], [], 0
    for pidx, _ in buckets:
        B = int((pidx < num_pulses).sum())      # real rows come first
        perm_parts.append(pidx[:B].astype(np.int64))
        layout.append((start, B, int(pidx.shape[0])))
        start += B
    covered = (np.concatenate(perm_parts) if perm_parts
               else np.zeros(0, np.int64))
    miss = np.ones(num_pulses, bool)
    miss[covered] = False
    perm = np.concatenate([covered, np.nonzero(miss)[0].astype(np.int64)])
    return perm, tuple(layout)


def uncovered_groups(layout, num_pulses: int) -> tuple:
    """The range of groups in no bucket in the order of
    `permute_pulse_ladders` (``layout`` its second result): the tail after
    the covered ones."""
    return sum(B for _, B, _ in layout), num_pulses


def renumber_pulse_ladders(buckets, perm: np.ndarray):
    """Buckets with each real ``pidx`` replaced by that pulse's position in
    the order ``perm`` (dummy rows keep ``num_pulses``)."""
    num_pulses = perm.shape[0]
    where = np.empty(num_pulses + 1, np.int32)
    where[perm] = np.arange(num_pulses, dtype=np.int32)
    where[num_pulses] = num_pulses
    return tuple((where[pidx], cand) for pidx, cand in buckets)


def _rows(B: int) -> int:
    return -(-B // LANES) * LANES


def ladders_from_lists(lists, num_pulses: int):
    """`build_pulse_ladders`' (pidx, cand) buckets from a cull's lists
    (`kernels/cull.py::CullLists`, ``pad_to`` 8), on their device with no
    host read: one bucket per padded size K in ascending order, its pulses
    in ascending id, the rows padded to a multiple of 128 (dummy rows:
    pidx = ``num_pulses``, no candidates)."""
    return bucket_rows(lists, _rows, num_pulses)


def permute_ladders_torch(lists, num_pulses: int):
    """`permute_pulse_ladders` of the ladders `ladders_from_lists` makes,
    on the lists' device: ``(perm, layout)``, ``perm`` (num_pulses,) i64
    the pulses in bucket order (a stable order by padded size), those with
    no candidate last."""
    layout, start = [], 0
    for _, B in lists.sizes:
        layout.append((start, B, _rows(B)))
        start += B
    return lists.order, tuple(layout)


def renumber_ladders_torch(buckets, perm: torch.Tensor):
    """`renumber_pulse_ladders` on the buckets' device."""
    P = perm.shape[0]
    where = torch.empty(P + 1, dtype=torch.int32, device=perm.device)
    where[perm] = torch.arange(P, dtype=torch.int32, device=perm.device)
    where[P] = P
    return tuple((where[pidx.long()], cand) for pidx, cand in buckets)


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------

def _validate(wald, origin, direction, buckets, kernel_rays):
    dev = origin.get_device()
    check_tensor("wald", wald, torch.float32, 2, dev)
    check_tensor("origin", origin, torch.float32, 2, dev)
    check_tensor("direction", direction, torch.float32, 2, dev)
    if wald.shape[1] != 12 or origin.shape[1] != 3 \
            or direction.shape != origin.shape:
        raise ValueError("wald must be (F, 12); origin/direction (N, 3)")
    if kernel_rays <= 0 or origin.shape[0] % kernel_rays:
        raise ValueError(f"ray count {origin.shape[0]} must be a multiple "
                         f"of kernel_rays={kernel_rays}")
    for pidx, cand in buckets:
        check_tensor("pidx", pidx, torch.int32, 1, dev)
        check_tensor("cand", cand, torch.int32, 2, dev)
        if pidx.shape[0] != cand.shape[0] or cand.shape[1] % CAND_BLOCK:
            raise ValueError("bucket shapes disagree: pidx (B,), cand "
                             "(B, K) with K % 8 == 0")


def pulse_traverse(wald, origin, direction, buckets, t_max: float,
                   kernel_rays: int):
    """Nearest (t, face) per ray over per-pulse-group candidate ladders.

    ``wald`` (F, 12) f32 Wald rows; ``origin``/``direction`` (N, 3) f32
    with N = P * kernel_rays (P pulse groups, each ``kernel_rays``
    consecutive rays); ``buckets`` a sequence of (pidx (B,) i32, cand (B, K)
    i32) on the same device.  Rows with pidx outside [0, P) are dummies;
    padding (-1) may sit anywhere in a ladder row.  Returns (t (N,) f32,
    face (N,) i32); misses and groups in no bucket are (BIG, -1).

    A `PulseLadders` with ``uncovered = (lo, hi)`` promises that the groups
    in ``range(lo, hi)`` are in no bucket and every other group has exactly
    one real row: the kernel then writes those groups' (BIG, -1) itself;
    otherwise the outputs are filled first.  CUDA tensors launch K2 once
    per call (none when nothing is to be written); CPU tensors take
    `pulse_traverse_plain`.
    """
    _validate(wald, origin, direction, buckets, kernel_rays)
    n = origin.shape[0]
    P = n // kernel_rays
    uncovered = getattr(buckets, "uncovered", None)
    if uncovered is not None:
        lo, hi = (int(x) for x in uncovered)
        if not 0 <= lo <= hi <= P:
            raise ValueError(f"uncovered groups [{lo}, {hi}) outside "
                             f"[0, {P})")
    if not origin.is_cuda:
        if origin.device.type == "cpu":
            return pulse_traverse_plain(wald, origin, direction, buckets,
                                        t_max, kernel_rays)
        raise ValueError(f"unsupported device {origin.device}")
    if wald.data_ptr() % 16:
        raise ValueError("wald must start on a 16-byte boundary")
    sched = pulse_schedule(buckets, kernel_rays)
    if sched.n_blocks >= 2 ** 31:
        raise ValueError(f"{sched.n_blocks} blocks: over the kernel's 2^31")
    dev = origin.device
    if uncovered is None:
        out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
        out_f = torch.full((n,), -1, dtype=torch.int32, device=dev)
        lo = hi = 0
    else:
        out_t = torch.empty((n,), dtype=torch.float32, device=dev)
        out_f = torch.empty((n,), dtype=torch.int32, device=dev)
    if not sched.entries and lo == hi:
        return out_t, out_f
    args = (ctypes.c_int64 * (ARGS_PER_BUCKET * len(sched.entries)))()
    for j, (i, *ints) in enumerate(sched.entries):
        pidx, cand = buckets[i]
        args[ARGS_PER_BUCKET * j:ARGS_PER_BUCKET * (j + 1)] = (
            pidx.data_ptr(), cand.data_ptr(), *ints)
    rc = KERNEL.launcher()(
        wald.data_ptr(), origin.data_ptr(), direction.data_ptr(), P,
        kernel_rays, float(t_max), out_t.data_ptr(), out_f.data_ptr(),
        len(sched.entries), args, sched.n_blocks, sched.rows_per_block,
        sched.slice_rays, lo * kernel_rays, (hi - lo) * kernel_rays,
        raw_stream(origin.get_device()))
    KERNEL.check(rc, "pulse_traverse")
    KERNEL.launches += 1
    return out_t, out_f


def pulse_traverse_plain(wald, origin, direction, buckets, t_max: float,
                         kernel_rays: int, max_pairs: int = 1 << 22):
    """Plain PyTorch version of K2: same signature and results.

    Takes bucket rows in slices of at most ``max_pairs`` (ray, candidate)
    pairs to bound its temporaries; each slice gathers ``wald[cand]``
    (zero rows for padding), evaluates (B, R, K) Wald tests, the block min
    and min id, and merges the blocks by a first-occurrence argmin (strict
    <, starting from t_max) in `wald_blocks_plain`.
    """
    dev = origin.device
    n = origin.shape[0]
    R = kernel_rays
    P = n // R
    out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    out_f = torch.full((n,), -1, dtype=torch.int32, device=dev)
    o_all = origin.reshape(P, R, 3)
    d_all = direction.reshape(P, R, 3)
    tm = torch.tensor(t_max, dtype=torch.float32, device=dev)
    for pidx, cand in buckets:
        step = max(1, max_pairs // (R * max(cand.shape[1], 1)))
        for lo in range(0, int(pidx.shape[0]), step):
            sl = slice(lo, lo + step)
            keep = (pidx[sl] >= 0) & (pidx[sl] < P)
            if not bool(keep.any()):
                continue
            pid = pidx[sl][keep].long()
            t_best = tm.expand(pid.shape[0], R).clone()
            f_best = torch.full_like(t_best, -1, dtype=torch.int32)
            t_best, f_best = wald_blocks_plain(
                wald, o_all[pid][:, :, None, :], d_all[pid][:, :, None, :],
                cand[sl][keep], tm, t_best, f_best)
            out_t.view(P, R)[pid] = torch.where(
                f_best < 0, torch.full_like(t_best, BIG), t_best)
            out_f.view(P, R)[pid] = f_best
    return out_t, out_f


class PulseLadderTraverser:
    """Scene-bound pulse-ladder traverser: host prep + device call.

    Same traverse_fn interface as `TileTraverser`::

        tr = PulseLadderTraverser(scene, rays_per_pulse=10, device="cuda")
        data = tr.prepare(bvh, origins, directions, t_max=...)   # K5
        hits = tr(origin, direction, data)                       # K2

    ``group`` adjacent pulses share one candidate ladder (group = 1 is the
    exact per-pulse scheme); a ladder entity is ``kernel_rays =
    rays_per_pulse * group`` consecutive rays.  Bounce continuation rays
    stay on the level-0 lines, so the same ladders serve every return level.
    """

    def __init__(self, scene: TriangleScene, rays_per_pulse: int, *,
                 group: int = 1, device="cuda"):
        self.rays_per_pulse = int(rays_per_pulse)
        self.group = int(group)
        self.device = resolve_device(device)
        with span("lbt.construct.wald"):
            rows = torch.from_numpy(wald_rows_np(as_numpy(scene.vertices),
                                                 as_numpy(scene.faces)))
        self.wald = upload(rows, self.device)
        self.t_max = None
        self.nodes = NodeCache(self.device)

    @property
    def kernel_rays(self) -> int:
        """Rays per ladder entity (one pulse group)."""
        return self.rays_per_pulse * self.group

    def beams_ok(self, origin, direction) -> bool:
        """Per-group cones narrow enough for culling to pay off (same
        MIN_COS_HALF contract as the tile culler)."""
        o = np.asarray(as_numpy(origin), np.float32).reshape(-1, 3)
        d = np.asarray(as_numpy(direction), np.float32).reshape(-1, 3)
        return beams_are_narrow(tile_beams(o, d, self.kernel_rays))

    def _resolve_t_max(self, bvh: BVH, o, t_max: float | None) -> float:
        if t_max is None:
            t_max = default_t_max(bvh, o)
        self.t_max = float(t_max)
        return self.t_max

    def upload(self, buckets, uncovered=None) -> PulseLadders:
        """Host buckets -> ((pidx, cand) per bucket) on the device, with
        the range of groups in no bucket (`PulseLadders`)."""
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)
        return PulseLadders(((put(p), put(c)) for p, c in buckets),
                            uncovered)

    def cull(self, bvh: BVH, origin, direction, t_max: float, *,
             narrow_only: bool = False):
        """K5's lists (`kernels/cull.py::CullLists`) of the rays' pulse
        groups on the traverser's device; with ``narrow_only``, None when
        a group's cone is too wide to cull (one host read)."""
        put = lambda a: torch.as_tensor(a).to(
            self.device, torch.float32).reshape(-1, 3).contiguous()
        nodes = self.nodes(bvh)
        res = cull_rays(nodes, put(origin), put(direction),
                        self.kernel_rays, t_max, CAND_BLOCK,
                        narrow_only=narrow_only, depth=self.nodes.depth)
        return None if res is None else res[0]

    def prepare(self, bvh: BVH, origin, direction,
                t_max: float | None = None):
        """The cull for one chunk: ((pidx, cand) per bucket) on the
        traverser's device, in the rays' own order (so no uncovered range
        is named).  Sets ``self.t_max``."""
        t_max = self._resolve_t_max(bvh, origin, t_max)
        lists = self.cull(bvh, origin, direction, t_max)
        return PulseLadders(ladders_from_lists(lists,
                                               lists.counts.shape[0]))

    def prepare_permuted(self, bvh: BVH, origin, direction,
                         t_max: float | None = None, *,
                         narrow_only: bool = False):
        """The cull for one chunk in the JAX package's bucket-contiguous
        order, all on the device: ``(gperm, ladders)``, ``gperm`` the
        pulse permutation (a group's pulses stay together) to apply to the
        rays, ``ladders`` a `PulseLadders` renumbered to it with the range
        of groups in no bucket (the order `Simulator` and the bench scan
        in).  With ``narrow_only``, None when a cone is too wide to cull.
        Sets ``self.t_max``."""
        t_max = self._resolve_t_max(bvh, origin, t_max)
        lists = self.cull(bvh, origin, direction, t_max,
                          narrow_only=narrow_only)
        if lists is None:
            return None
        P = lists.counts.shape[0]
        perm, layout = permute_ladders_torch(lists, P)
        grp = self.group
        gperm = perm if grp == 1 else (
            perm[:, None] * grp
            + torch.arange(grp, device=perm.device)[None, :]).reshape(-1)
        return gperm, PulseLadders(
            renumber_ladders_torch(ladders_from_lists(lists, P), perm),
            uncovered_groups(layout, P))

    def prepare_sharded(self, bvh: BVH, origin, direction, mesh,
                        t_max: float | None = None) -> PulseLadders:
        """This rank's ladders, with pulse ids local to its shard
        (counterpart of `pulse_pallas.py::PulseLadderTraverser.
        prepare_sharded`).

        ``origin``/``direction`` are the rank's own rays; ``mesh`` its
        `parallel/shard.py::RayMesh`.  ``t_max`` None is resolved over the
        pulses of every rank, as the JAX package resolves it over all pulses
        before it splits them: each rank's `default_t_max` of its own rays,
        reduced by MAX over the mesh (exact: the rule is monotone in the far
        distance).  The JAX version pads every shard to the union of the
        shards' ladders so that `shard_map` sees one shape; here each rank
        holds what `prepare` gives on its slice.  Sets ``self.t_max``.
        """
        if t_max is None:
            local = torch.tensor([default_t_max(bvh, origin)],
                                 dtype=torch.float64, device=mesh.device)
            t_max = float(mesh.all_reduce(local, ReduceOp.MAX)[0])
        return self.prepare(bvh, origin, direction, t_max=t_max)

    def __call__(self, origin, direction, traverse_data) -> Hit:
        shape = origin.shape[:-1]
        o = origin.detach().reshape(-1, 3).contiguous()
        d = direction.detach().reshape(-1, 3).contiguous()
        t, f = pulse_traverse(self.wald, o, d, traverse_data, self.t_max,
                              self.kernel_rays)
        return Hit(t=t.reshape(shape), face=f.reshape(shape))
