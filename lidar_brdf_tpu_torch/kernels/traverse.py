"""Tile traverser: host cull half + the hand-written CUDA tile kernel (K1).

Counterpart of `lidar_brdf_tpu/kernels/traverse_pallas.py`.

* Cull half (`TileTraverser.prepare`): BSP-ordered rays are cut into tiles
  of ``tile_rays``; each tile's beam (`geom/beamcull.py::tile_beams_torch`)
  is culled on the rays' device by K5 (`kernels/cull.py::beam_cull`) into a
  candidate list sorted near to far; `buckets_from_lists` groups the lists
  into power-of-two buckets and `bucket_bounds_torch` gives every block of
  8 candidates a conservative lower bound on the hit distance, as the host
  functions `build_bucketed_candidates` and `TileTraverser.bucket_bounds`
  do.
* Device half (`tile_traverse`): the nearest (t, face) of every ray of
  every tile against the tile's candidates, all buckets in one call.  On a
  CUDA tensor it launches `csrc/tile_traverse.cu` once over the work list
  `tile_schedule` makes (built with nvcc at first use into
  `build/kernels/`, loaded with ctypes); on a CPU tensor it runs
  `tile_traverse_plain`, the same 8-candidate-block semantics in plain
  PyTorch.  It never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import BVH, Hit, TriangleScene, as_numpy, resolve_device
from ..geom.beamcull import (_next_pow2, beams_are_narrow, tile_beams,
                             wald_rows_np)
from ..geom.intersect import BIG, EPSILON
from ..runtime.metrics import span, upload
from .cuda_build import CudaLibrary, check_tensor, raw_stream
from .cull import NodeCache, bucket_rows, cull_rays, readback

LANES = 128          # tile_rays granularity: one K1 unit of 128 rays,
GROUPS = 4           # K1 (csrc/tile_traverse.cu): units of a block,
MAX_BUCKETS = 32     # buckets of a launch,
ARGS_PER_BUCKET = 7  # int64 launch arguments of a bucket
CAND_BLOCK = 8       # candidates per tie-rule block
INT_MISS = 2 ** 30


def _declare(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lbt_tile_traverse.argtypes = [vp, vp, vp, ci, ci, cf, vp, vp, ci,
                                      ctypes.POINTER(ctypes.c_int64), ci, vp]
    lib.lbt_tile_traverse.restype = ci


KERNEL = CudaLibrary("tile_traverse.cu", _declare, "lbt_tile_traverse")


def tile_schedule(buckets, tile_rays: int):
    """K1's work list for one call, from the bucket shapes alone (no device
    read).

    The work of a bucket is cut into units, one per 128 consecutive rays of
    a row's tile (``tile_rays // 128`` units per row, row after row); a
    unit is one group of 128 threads, one thread per ray, and a block of 4
    groups runs 4 consecutive units.  Returns ``(entries, n_blocks)``: one
    entry ``(index, B, C, first_block, units_per_row)`` per bucket with
    rows and candidates, in launch order, longest lists first (ties keep
    the input order), and the grid size.  Empty buckets get no blocks; a
    dummy row (tidx == n_tiles) can only be told on the device, where its
    units return at their first load and write nothing.
    """
    shape = [tuple(b[1].shape) for b in buckets]
    order = sorted((i for i, (B, C) in enumerate(shape) if B and C),
                   key=lambda i: -shape[i][1])
    per_row = tile_rays // LANES
    entries, first = [], 0
    for i in order:
        B, C = shape[i]
        entries.append((i, B, C, first, per_row))
        first += -(-B * per_row // GROUPS)
    return tuple(entries), first


def _validate(wald, origin, direction, buckets, tile_rays):
    dev = origin.get_device()
    check_tensor("wald", wald, torch.float32, 2, dev)
    check_tensor("origin", origin, torch.float32, 2, dev)
    check_tensor("direction", direction, torch.float32, 2, dev)
    if wald.shape[1] != 12 or origin.shape[1] != 3 \
            or direction.shape != origin.shape:
        raise ValueError("wald must be (F, 12); origin/direction (N, 3)")
    if tile_rays % LANES or origin.shape[0] % tile_rays:
        raise ValueError(f"ray count {origin.shape[0]} must be a multiple "
                         f"of tile_rays={tile_rays}, itself a multiple of "
                         f"{LANES}")
    for tidx, cand, bnd in buckets:
        check_tensor("tidx", tidx, torch.int32, 1, dev)
        check_tensor("cand", cand, torch.int32, 2, dev)
        check_tensor("bnd", bnd, torch.float32, 2, dev)
        B, C = cand.shape
        if tidx.shape[0] != B or C % CAND_BLOCK \
                or bnd.shape != (B, C // CAND_BLOCK):
            raise ValueError("bucket shapes disagree: tidx (B,), cand "
                             "(B, C) with C % 8 == 0, bnd (B, C // 8)")


def tile_traverse(wald, origin, direction, buckets, t_max: float,
                  tile_rays: int):
    """Nearest (t, face) per ray over culled tile buckets.

    ``wald`` (F, 12) f32 Wald rows; ``origin``/``direction`` (N, 3) f32
    with N = T * tile_rays; ``buckets`` a sequence of (tidx (B,) i32,
    cand (B, C) i32 (-1 padded), bnd (B, C//8) f32) on the same device.
    Rows with tidx == T are dummies.  Returns (t (N,) f32, face (N,) i32);
    misses and tiles in no bucket are (BIG, -1).  CUDA tensors launch K1
    once over all buckets (none when no bucket has rows); CPU tensors take
    `tile_traverse_plain`.
    """
    if not origin.is_cuda:
        if origin.device.type == "cpu":
            return tile_traverse_plain(wald, origin, direction, buckets,
                                       t_max, tile_rays)
        raise ValueError(f"unsupported device {origin.device}")
    _validate(wald, origin, direction, buckets, tile_rays)
    if wald.data_ptr() % 16:
        raise ValueError("wald must start on a 16-byte boundary")
    entries, n_blocks = tile_schedule(buckets, tile_rays)
    if len(entries) > MAX_BUCKETS or n_blocks >= 2 ** 31:
        raise ValueError(f"{len(entries)} buckets, {n_blocks} blocks: over "
                         f"the kernel's {MAX_BUCKETS} buckets or 2^31 blocks")
    n = origin.shape[0]
    out_t = torch.full((n,), BIG, dtype=torch.float32, device=origin.device)
    out_f = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    if not entries:
        return out_t, out_f
    args = (ctypes.c_int64 * (ARGS_PER_BUCKET * len(entries)))()
    for j, (i, *ints) in enumerate(entries):
        tidx, cand, bnd = buckets[i]
        args[ARGS_PER_BUCKET * j:ARGS_PER_BUCKET * (j + 1)] = (
            tidx.data_ptr(), cand.data_ptr(), bnd.data_ptr(), *ints)
    rc = KERNEL.launcher()(
        wald.data_ptr(), origin.data_ptr(), direction.data_ptr(),
        n // tile_rays, tile_rays, float(t_max), out_t.data_ptr(),
        out_f.data_ptr(), len(entries), args, n_blocks,
        raw_stream(origin.get_device()))
    KERNEL.check(rc, "tile_traverse")
    KERNEL.launches += 1
    return out_t, out_f


def tile_traverse_plain(wald, origin, direction, buckets, t_max: float,
                        tile_rays: int, step_blocks: int = 16,
                        row_block: int = 128):
    """Plain PyTorch version of K1: same signature and results.

    Evaluates ``row_block`` tiles x ``step_blocks`` blocks of 8 candidates
    at a time (bounding its temporaries), with the
    kernel's operation order and tie rule; the block merge (strict <,
    earlier block wins ties, starting from t_max) is a first-occurrence
    argmin.  It has no early exit: the bounds are conservative, so the exit
    only skips blocks that cannot win.
    """
    dev = origin.device
    n = origin.shape[0]
    T = n // tile_rays
    out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    out_f = torch.full((n,), -1, dtype=torch.int32, device=dev)
    o_all = origin.reshape(T, tile_rays, 3)
    d_all = direction.reshape(T, tile_rays, 3)
    tm = torch.tensor(t_max, dtype=torch.float32, device=dev)
    for tidx, cand, _bnd in buckets:
        keep = (tidx >= 0) & (tidx < T)
        for lo in range(0, int(keep.shape[0]), row_block):
            _plain_rows(wald, o_all, d_all, tidx[lo:lo + row_block],
                        cand[lo:lo + row_block], keep[lo:lo + row_block],
                        tm, tile_rays, step_blocks, out_t, out_f)
    return out_t, out_f


def _plain_rows(wald, o_all, d_all, tidx, cand, keep, tm, tile_rays,
                step_blocks, out_t, out_f):
    """`tile_traverse_plain` over some rows of one bucket."""
    if not bool(keep.any()):
        return
    T = o_all.shape[0]
    C = cand.shape[1]
    tid = tidx[keep].long()
    cnd = cand[keep]
    o = o_all[tid][:, :, None, :]                     # (B, R, 1, 3)
    d = d_all[tid][:, :, None, :]
    t_best = tm.expand(tid.shape[0], tile_rays).clone()
    f_best = torch.full_like(t_best, -1, dtype=torch.int32)
    for s in range(0, C, step_blocks * CAND_BLOCK):
        t_best, f_best = wald_blocks_plain(
            wald, o, d, cnd[:, s:s + step_blocks * CAND_BLOCK], tm, t_best,
            f_best)
    t_best = torch.where(f_best < 0, torch.full_like(t_best, BIG), t_best)
    out_t.view(T, tile_rays)[tid] = t_best
    out_f.view(T, tile_rays)[tid] = f_best


def wald_blocks_plain(wald, o, d, ids, tm, t_best, f_best):
    """Plain PyTorch `wald_block` (csrc/wald.cuh) over consecutive blocks.

    Rays ``o``/``d`` (B, R, 1, 3) against the candidates ``ids`` (B, C),
    C % 8 == 0, -1 padded, with the kernels' Wald test and operation
    order; each block of 8 is merged into (``t_best``, ``f_best``) (B, R)
    by the tie rule.  Returns the updated pair.  The strict < merge across
    blocks, earlier block winning ties, is a first-occurrence argmin.
    """
    nb = ids.shape[1] // CAND_BLOCK
    t_m = wald_t_m_plain(wald, o, d, ids, tm).reshape(
        t_best.shape + (nb, CAND_BLOCK))
    t_c = t_m.amin(dim=-1)                             # (B, R, nb)
    ids_b = ids.reshape(-1, 1, nb, CAND_BLOCK).expand_as(t_m)
    f_c = torch.where(t_m <= t_c[..., None], ids_b,
                      torch.full_like(ids_b, INT_MISS)).amin(dim=-1)
    first = torch.argmin(t_c, dim=-1, keepdim=True)
    t_win = t_c.gather(-1, first)[..., 0]
    f_win = f_c.gather(-1, first)[..., 0]
    better = t_win < t_best
    return (torch.where(better, t_win, t_best),
            torch.where(better, f_win, f_best))


def wald_t_m_plain(wald, o, d, ids, tm):
    """Plain PyTorch `wald_t_m` (csrc/wald.cuh): t_m (B, R, C) of rays
    ``o``/``d`` (B, R, 1, 3) against candidates ``ids`` (B, C), -1 for
    padding: the hit distance where the Wald test accepts, else ``tm``."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    rows = wald[torch.clamp(ids, min=0).long()]
    rows = torch.where((ids >= 0)[..., None], rows,
                       torch.zeros_like(rows))[:, None]       # (B,1,C,12)
    r = [rows[..., j] for j in range(12)]
    nd = dx * r[0] + dy * r[1] + dz * r[2]
    no = ox * r[0] + oy * r[1] + oz * r[2]
    ok_det = torch.abs(nd) >= EPSILON
    sign = torch.where(nd < 0, -torch.ones_like(nd), torch.ones_like(nd))
    t = (r[3] - no) / torch.where(ok_det, nd, sign)
    u = (ox * r[4] + oy * r[5] + oz * r[6]) + r[7] \
        + t * (dx * r[4] + dy * r[5] + dz * r[6])
    v = (ox * r[8] + oy * r[9] + oz * r[10]) + r[11] \
        + t * (dx * r[8] + dy * r[9] + dz * r[10])
    ok = (ok_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= -EPSILON) & (ids >= 0)[:, None])
    return torch.where(ok, t, tm)


def default_t_max(bvh: BVH, origin) -> float:
    """The kernels' far bound when the caller gives none: the scene's
    diagonal, plus the farthest origin's distance from the scene's box,
    plus 1 (the JAX package's rule, in float32 as there).  Origins in a
    tensor stay on its device: only the farthest distance is read back
    (`kernels/cull.py::readback`)."""
    nmin = np.asarray(as_numpy(bvh.node_min), np.float32)[0]
    nmax = np.asarray(as_numpy(bvh.node_max), np.float32)[0]
    if isinstance(origin, torch.Tensor):
        o = origin.detach().reshape(-1, 3).float()
        lo, hi = (torch.from_numpy(x).to(o.device) for x in (nmin, nmax))
        q = o - torch.minimum(torch.maximum(o, lo), hi)
        far = np.float32(readback(torch.sqrt(
            (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]).max()))
    else:
        o = np.asarray(origin, np.float32).reshape(-1, 3)
        far = np.linalg.norm(o - np.clip(o, nmin, nmax), axis=-1).max()
    return float(np.linalg.norm(nmax - nmin) + far + 1.0)


def buckets_from_lists(lists, n_tiles: int):
    """`geom/beamcull.py::build_bucketed_candidates`'s (tidx, cand) buckets
    from a cull's lists (`kernels/cull.py::CullLists`, made with the
    buckets' ``pad_to``), on their device with no host read: one bucket per
    padded size in ascending order, its tiles in ascending id, the rows
    rounded up to a power of two (dummy rows: tidx = ``n_tiles``, no
    candidates)."""
    return bucket_rows(lists, _next_pow2, n_tiles)


def bucket_bounds_torch(face_box: torch.Tensor, buckets, beams) -> tuple:
    """`TileTraverser.bucket_bounds` on the buckets' device: per block of 8
    candidates, the axis-projected near distance of the faces' boxes minus
    the tile's origin radius, made a monotone suffix minimum, in float64
    and rounded to f32.  ``face_box`` (F, 6) f64 [min max] of each face's
    leaf (`TileTraverser.face_boxes`); ``beams`` the tiles' float64
    `TileBeams` of tensors."""
    T = beams.center.shape[0]
    out = []
    for tidx, cand in buckets:
        B, C = cand.shape
        t = torch.clamp(tidx.long(), max=T - 1)
        c, a = beams.center[t][:, None, :], beams.axis[t][:, None, :]
        real = cand >= 0
        box = face_box[torch.clamp(cand.long(), min=0)]
        zero = torch.zeros((), dtype=torch.float64, device=cand.device)
        proj, slack = [], []
        for i in range(3):
            mid = torch.where(real, (box[..., i] + box[..., 3 + i]) * 0.5,
                              zero)
            ext = torch.where(real, (box[..., 3 + i] - box[..., i]) * 0.5,
                              zero)
            proj.append((mid - c[..., i]) * a[..., i])
            slack.append(ext * torch.abs(a[..., i]))
        d_near = torch.maximum(
            ((proj[0] + proj[1]) + proj[2]) - ((slack[0] + slack[1])
                                               + slack[2])
            - beams.radius[t][:, None], zero)
        d_near = torch.where(real, d_near, torch.full_like(d_near, np.inf))
        bnd = d_near.reshape(B, C // CAND_BLOCK, CAND_BLOCK).amin(dim=2)
        bnd = torch.flip(torch.cummin(torch.flip(bnd, [1]), dim=1).values,
                         [1])
        out.append(bnd.to(torch.float32).contiguous())
    return tuple(out)


class TileTraverser:
    """Scene-bound tile traverser: the cull on the device, then K1.

    Usage::

        tr = TileTraverser(scene, tile_rays=640, device="cuda")
        data = tr.prepare(bvh, origins, directions)   # K5, per chunk
        hits = tr(origin, direction, data)             # K1

    The BVH's node records are packed on the device once per BVH
    (``nodes``) and kept; a `Simulator` hands the same pack to its packet
    walk.
    """

    def __init__(self, scene: TriangleScene, *, tile_rays: int = 640,
                 device="cuda"):
        if tile_rays % LANES:
            raise ValueError(f"tile_rays must be a multiple of {LANES}")
        self.tile_rays = tile_rays
        self.device = resolve_device(device)
        with span("lbt.construct.wald"):
            rows = torch.from_numpy(wald_rows_np(as_numpy(scene.vertices),
                                                 as_numpy(scene.faces)))
        self.wald = upload(rows, self.device)
        self.t_max = None
        self.nodes = NodeCache(self.device)
        self._face_box = (None, None)

    def _pad_np(self, origin, direction):
        o = np.asarray(as_numpy(origin), np.float32).reshape(-1, 3)
        d = np.asarray(as_numpy(direction), np.float32).reshape(-1, 3)
        pad = (-o.shape[0]) % self.tile_rays
        if pad:
            o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
            d = np.concatenate([d, np.zeros((pad, 3), np.float32)])
        return o, d

    def _pad(self, origin, direction):
        """Rays as (N, 3) f32 tensors on the traverser's device, padded
        with zero-direction rays to whole tiles."""
        put = lambda a: torch.as_tensor(a).to(
            self.device, torch.float32).reshape(-1, 3)
        o, d = put(origin), put(direction)
        pad = (-o.shape[0]) % self.tile_rays
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_zeros((pad, 3))])
        return o.contiguous(), d.contiguous()

    def beams_ok(self, origin, direction) -> bool:
        o, d = self._pad_np(origin, direction)
        return beams_are_narrow(tile_beams(o, d, self.tile_rays))

    def face_boxes(self, bvh: BVH) -> torch.Tensor:
        """(F, 6) f64 [min max] of each face's leaf box, from the node
        records on the device (kept per BVH): `bucket_bounds`' boxes."""
        if self._face_box[0] is not bvh:
            box, _, face = self.nodes(bvh)
            F = self.wald.shape[0]
            idx = torch.where(face >= 0, face.long(),
                              torch.full_like(face, F, dtype=torch.int64))
            fb = torch.zeros((F + 1, 6), dtype=torch.float64,
                             device=self.device)
            fb[idx] = box.double()          # internal nodes land in row F
            self._face_box = (bvh, fb[:F])
        return self._face_box[1]

    def cull(self, bvh: BVH, origin, direction, t_max: float | None = None,
             *, pad_to: int = CAND_BLOCK, narrow_only: bool = False):
        """(lists, beams) of the rays' tiles on the device: K5's
        `CullLists` (padded sizes of ``pad_to``) and the float64 beams.
        ``t_max`` None is `_collect_candidates`' rule (one host read).
        With ``narrow_only``, None when a tile's beam is too wide to cull
        (`beams_are_narrow`; one host read)."""
        o, d = self._pad(origin, direction)
        nodes = self.nodes(bvh)
        return cull_rays(nodes, o, d, self.tile_rays, t_max, pad_to,
                         narrow_only=narrow_only, depth=self.nodes.depth)

    def build_buckets(self, bvh: BVH, origin, direction,
                      t_max: float | None = None):
        """The (tidx, cand) buckets of `prepare` as host arrays (the JAX
        package's interface; the same values as
        `build_bucketed_candidates` with ``pad_to=8``)."""
        lists, beams = self.cull(bvh, origin, direction, t_max)
        return tuple((t.cpu().numpy(), c.cpu().numpy()) for t, c in
                     buckets_from_lists(lists, beams.center.shape[0]))

    def bucket_bounds(self, bvh: BVH, buckets, origin, direction) -> tuple:
        """Per-candidate-block lower distance bounds (B, C//8) per bucket,
        on the host (the JAX package's interface; `bucket_bounds_torch` is
        the device version `prepare` takes).

        Bound: axis-projected near distance of the face AABB minus the tile
        origin radius (conservative: any hit on that face has ray-t >= it),
        made a monotone prefix along the near-to-far list.
        """
        node_face = np.asarray(bvh.node_face)
        is_leaf = node_face >= 0
        fmin = np.zeros((node_face[is_leaf].max() + 1, 3))
        fmax = np.zeros_like(fmin)
        fmin[node_face[is_leaf]] = np.asarray(bvh.node_min)[is_leaf]
        fmax[node_face[is_leaf]] = np.asarray(bvh.node_max)[is_leaf]
        o, d = self._pad_np(origin, direction)
        beams = tile_beams(o, d, self.tile_rays)
        out = []
        for tidx, cand in buckets:
            B, C = cand.shape
            safe_t = np.minimum(tidx, beams.center.shape[0] - 1)
            c_t = beams.center[safe_t][:, None, :]
            a_t = beams.axis[safe_t][:, None, :]
            r_t = beams.radius[safe_t][:, None]
            safe_c = np.maximum(cand, 0)
            real = cand[..., None] >= 0
            fc = np.where(real, (fmin[safe_c] + fmax[safe_c]) * 0.5, 0.0)
            he = np.where(real, (fmax[safe_c] - fmin[safe_c]) * 0.5, 0.0)
            proj = np.einsum("bci,bi->bc", fc - c_t, a_t[:, 0, :])
            slack = np.einsum("bci,bi->bc", he, np.abs(a_t[:, 0, :]))
            d_near = np.maximum(proj - slack - r_t, 0.0)
            d_near = np.where(cand >= 0, d_near, np.inf)
            bnd = d_near.reshape(B, C // CAND_BLOCK, CAND_BLOCK).min(axis=2)
            bnd = np.minimum.accumulate(bnd[:, ::-1], axis=1)[:, ::-1]
            out.append(bnd.astype(np.float32))
        return tuple(out)

    def prepare(self, bvh: BVH, origin, direction,
                t_max: float | None = None, *, narrow_only: bool = False):
        """The cull for one chunk on the traverser's device: ((tidx, cand,
        bnd) per bucket), from K5's lists (`cull`, `buckets_from_lists`,
        `bucket_bounds_torch`).  Sets ``self.t_max`` (None: resolved from
        ``origin``, `default_t_max`).  With ``narrow_only``, None when a
        tile's beam is too wide to cull."""
        res = self.cull(bvh, origin, direction, t_max,
                        narrow_only=narrow_only)
        if res is None:
            return None
        lists, beams = res
        buckets = buckets_from_lists(lists, beams.center.shape[0])
        bounds = bucket_bounds_torch(self.face_boxes(bvh), buckets, beams)
        self.t_max = float(default_t_max(bvh, origin) if t_max is None
                           else t_max)
        return tuple((t, c, b) for (t, c), b in zip(buckets, bounds))

    def __call__(self, origin, direction, traverse_data) -> Hit:
        shape = origin.shape[:-1]
        o = origin.detach().reshape(-1, 3)
        d = direction.detach().reshape(-1, 3)
        n_rays = o.shape[0]
        pad = (-n_rays) % self.tile_rays
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_zeros((pad, 3))])
        t, f = tile_traverse(self.wald, o.contiguous(), d.contiguous(),
                             traverse_data, self.t_max, self.tile_rays)
        return Hit(t=t[:n_rays].reshape(shape), face=f[:n_rays].reshape(shape))
