"""Beam culling (counterpart of `lidar_brdf_tpu/geom/beamcull.py`).

The reference walks a BVH per GPU thread with a 200-entry stack
(`findBVHCollision-comp.glsl:94-137`).  The JAX package splits traversal in
two, and the port keeps that split:

1. CULL, once per ray chunk: group coherent rays into tiles; bound each
   tile by a *beam* (origin bounding sphere + direction cone); walk the
   threaded BVH for every tile, keeping every leaf whose AABB the beam can
   touch within range.  The test is conservative (never rejects a
   reachable triangle).  The JAX package culls on the host (numpy or the
   native C++ culler), and this module keeps its host functions
   (`tile_beams`, `_collect_candidates`, `build_tile_candidates`,
   `build_bucketed_candidates`); the port's `Simulator`, bench and
   traversers cull on the rays' device instead: `tile_beams_torch` builds
   the beams there and the CUDA kernel K5 (`kernels/cull.py`) walks the
   tree.

2. DEVICE (`kernels/traverse.py`): each ray tile is intersected against its
   candidate list of Wald rows (plane + two barycentric planes, 12 floats)
   by the hand-written CUDA tile kernel K1, or its plain PyTorch version.
   `intersect_culled` and `CulledTraverser` give the JAX package's
   interface to it: a dense (T, C) candidate array or its buckets.

Hit semantics match `moller_trumbore` (`geom/intersect.py`).  Tie rule
(equal t): K1 takes the least face id among the equal t of a block of 8
candidates, and across blocks the earlier block wins; the JAX package's
XLA path takes the least face id across a whole ``chunk`` of candidates
(128 by default).  At ``chunk=8`` the two rules are the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import BVH, Hit, TriangleScene
from .intersect import BIG

DEFAULT_TILE_RAYS = 512
DEFAULT_CHUNK = 128

# A beam wider than this (cos of half-angle) culls nothing useful; callers
# should fall back to packet traversal (see `beams_are_narrow`).
MIN_COS_HALF = 0.5


# ---------------------------------------------------------------------------
# Wald precomputed triangle form
# ---------------------------------------------------------------------------

def wald_rows_np(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(F, 12) rows [n, n.v0, nu, du, nv, dv] such that for a ray (o, d):

        t = (n.v0 - n.o) / (n.d)
        u = (nu.o + du) + t * (nu.d)
        v = (nv.o + dv) + t * (nv.d)

    Degenerate faces get all-zero rows (n.d == 0 for every ray => no hit).
    """
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces)
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    n = np.cross(e1, e2)
    cu = np.cross(e2, n)                      # u-plane direction
    cv = np.cross(e1, n)                      # v-plane direction
    su = np.einsum("ij,ij->i", cu, e1)
    sv = np.einsum("ij,ij->i", cv, e2)
    degen = (np.abs(su) < 1e-30) | (np.abs(sv) < 1e-30)
    su = np.where(degen, 1.0, su)
    sv = np.where(degen, 1.0, sv)
    nu = cu / su[:, None]
    nv = cv / sv[:, None]
    rows = np.concatenate([
        n,
        np.einsum("ij,ij->i", n, v0)[:, None],
        nu, -np.einsum("ij,ij->i", nu, v0)[:, None],
        nv, -np.einsum("ij,ij->i", nv, v0)[:, None],
    ], axis=1)
    rows[degen] = 0.0
    return rows.astype(np.float32)


# ---------------------------------------------------------------------------
# Host-side beam culling
# ---------------------------------------------------------------------------

@dataclass
class TileBeams:
    center: np.ndarray     # (T, 3) origin-sphere center
    radius: np.ndarray     # (T,)   origin-sphere radius
    axis: np.ndarray       # (T, 3) unit cone axis
    cos_half: np.ndarray   # (T,)   cone half-angle cosine
    valid: np.ndarray      # (T,)   tile has >= 1 real ray


def tile_beams(origins: np.ndarray, directions: np.ndarray,
               tile_rays: int) -> TileBeams:
    """Per-tile bounding beams; rays with ~zero direction (padding) ignored."""
    o = np.asarray(origins, np.float64).reshape(-1, tile_rays, 3)
    d = np.asarray(directions, np.float64).reshape(-1, tile_rays, 3)
    dn = np.linalg.norm(d, axis=-1)
    ok = dn > 1e-9
    du = np.where(ok[..., None], d / np.maximum(dn, 1e-30)[..., None], 0.0)
    count = ok.sum(axis=1)
    valid = count > 0
    axis = du.sum(axis=1)
    alen = np.linalg.norm(axis, axis=-1)
    axis = np.where(alen[:, None] > 1e-12, axis / np.maximum(alen, 1e-30)[:, None],
                    np.array([0.0, 1.0, 0.0]))
    cosd = np.einsum("tri,ti->tr", du, axis)
    cos_half = np.where(ok, cosd, 1.0).min(axis=1)
    cos_half = np.clip(cos_half, 1e-3, 1.0)
    big = ~ok[..., None]
    omin = np.where(big, np.inf, o).min(axis=1)
    omax = np.where(big, -np.inf, o).max(axis=1)
    omin = np.where(valid[:, None], omin, 0.0)
    omax = np.where(valid[:, None], omax, 0.0)
    center = (omin + omax) * 0.5
    radius = np.linalg.norm(omax - center, axis=-1)
    return TileBeams(center=center, radius=radius, axis=axis,
                     cos_half=cos_half, valid=valid)


def beams_are_narrow(beams: TileBeams,
                     min_cos_half: float = MIN_COS_HALF) -> bool:
    return bool((beams.cos_half[beams.valid] >= min_cos_half).all())


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis of 3, the squares summed in
    x, y, z order."""
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def tile_beams_torch(origin: torch.Tensor, direction: torch.Tensor,
                     tile_rays: int) -> TileBeams:
    """`tile_beams` over tensors, on their device: the same beams in
    float64 (`TileBeams` of tensors).  Each operation is `tile_beams`'s;
    the sums over a tile's rays and the dot products are taken in
    PyTorch's order, so a value may differ from the host's in its last
    float64 bit."""
    o = origin.reshape(-1, tile_rays, 3).double()
    d = direction.reshape(-1, tile_rays, 3).double()
    dn = _norm3(d)
    ok = dn > 1e-9
    du = torch.where(ok[..., None],
                     d / torch.clamp(dn, min=1e-30)[..., None],
                     torch.zeros_like(d))
    valid = ok.sum(dim=1) > 0
    axis = du.sum(dim=1)
    alen = _norm3(axis)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=o.device)
    axis = torch.where(alen[:, None] > 1e-12,
                       axis / torch.clamp(alen, min=1e-30)[:, None], up)
    cosd = (du[..., 0] * axis[:, None, 0] + du[..., 1] * axis[:, None, 1]) \
        + du[..., 2] * axis[:, None, 2]
    cos_half = torch.where(ok, cosd, torch.ones_like(cosd)).amin(dim=1)
    cos_half = torch.clamp(cos_half, 1e-3, 1.0)
    omin = torch.where(ok[..., None], o, torch.full_like(o, np.inf)).amin(1)
    omax = torch.where(ok[..., None], o, torch.full_like(o, -np.inf)).amax(1)
    omin = torch.where(valid[:, None], omin, torch.zeros_like(omin))
    omax = torch.where(valid[:, None], omax, torch.zeros_like(omax))
    center = (omin + omax) * 0.5
    return TileBeams(center=center, radius=_norm3(omax - center), axis=axis,
                     cos_half=cos_half, valid=valid)


def narrow_flag(beams: TileBeams,
                min_cos_half: float = MIN_COS_HALF) -> torch.Tensor:
    """`beams_are_narrow` of tensor beams as a 0-d bool tensor on their
    device (no host read)."""
    return ((beams.cos_half >= min_cos_half) | ~beams.valid).all()


def beam_tan_half(cos_half):
    """Tangent of the cone half-angle from its cosine, as
    `_collect_candidates` computes it (arrays or tensors)."""
    if isinstance(cos_half, torch.Tensor):
        return torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=0.0)) \
            / cos_half
    return np.sqrt(np.maximum(1.0 - cos_half ** 2, 0.0)) / cos_half


def cull_t_max_torch(root_min: torch.Tensor, root_max: torch.Tensor,
                     beams: TileBeams) -> torch.Tensor:
    """`_collect_candidates`' reach when the caller gives none, in float64
    as there: the root box's diagonal, plus the farthest beam center's
    distance from the box and the largest radius, plus 1 (0-d tensor)."""
    lo, hi = root_min.double(), root_max.double()
    c = beams.center
    q = c - torch.minimum(torch.maximum(c, lo), hi)
    diag = hi - lo
    far = _norm3(q).amax() + beams.radius.amax()
    return (_norm3(diag) + far) + 1.0


def bsp_order_np(features: np.ndarray, block: int) -> np.ndarray:
    """Permutation grouping rows into contiguous blocks of ``block`` with
    small extent, by recursive median split along the widest feature axis.

    Unlike Morton ordering this has no code-space discontinuities: every
    block is an actual spatial cluster of the data, so per-block bounding
    beams stay narrow.
    """
    f = np.asarray(features, np.float64)
    n = f.shape[0]
    order = np.arange(n)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= block:
            continue
        seg = order[lo:hi]
        ext = f[seg].max(axis=0) - f[seg].min(axis=0)
        ax = int(np.argmax(ext))
        # split at a block-multiple so finished blocks are never re-split
        mid = lo + (((hi - lo) // 2 + block - 1) // block) * block
        mid = min(mid, hi - 1)
        k = mid - lo
        part = np.argpartition(f[seg, ax], k)
        order[lo:hi] = seg[part]
        stack.append((lo, mid))
        stack.append((mid, hi))
    return order


def _beam_box_overlap(center, axis, tan_half, radius, bmin, bmax, t_max,
                      iters: int = 24):
    """Conservative beam-vs-AABB test, vectorized over pairs.

    Minimizes the convex g(s) = dist(center + s*axis, box grown by radius)
    - s*tan_half over s in [0, t_max]; overlap iff min <= slack.  A cheap
    slab test against the grown box accepts axis-crossing pairs without the
    ternary search.
    """
    gmin = bmin - radius[:, None]
    gmax = bmax + radius[:, None]

    # fast accept: axis ray passes through the grown box
    inv = 1.0 / np.where(np.abs(axis) < 1e-12,
                         np.where(axis < 0, -1e-12, 1e-12), axis)
    t0 = (gmin - center) * inv
    t1 = (gmax - center) * inv
    t_near = np.minimum(t0, t1).max(axis=1)
    t_far = np.maximum(t0, t1).min(axis=1)
    accept = (t_far >= np.maximum(t_near, 0.0)) & (t_near <= t_max)

    rest = (~accept).nonzero()[0]
    if rest.size:
        c_r, a_r = center[rest], axis[rest]
        gmin_r, gmax_r = gmin[rest], gmax[rest]
        tan_r = tan_half[rest]

        def g(s):
            p = c_r + s[:, None] * a_r
            q = np.clip(p, gmin_r, gmax_r) - p
            return np.sqrt(np.einsum("ij,ij->i", q, q)) - s * tan_r

        lo = np.zeros(rest.shape[0])
        hi = np.full(rest.shape[0], float(t_max))
        for _ in range(iters):
            m1 = lo + (hi - lo) * (1.0 / 3.0)
            m2 = hi - (hi - lo) * (1.0 / 3.0)
            left = g(m1) < g(m2)
            hi = np.where(left, m2, hi)
            lo = np.where(left, lo, m1)
        s = (lo + hi) * 0.5
        slack = 1e-4 + 1e-5 * float(t_max)
        accept[rest] = g(s) <= slack
    return accept


def _collect_candidates(bvh: BVH, beams: TileBeams, t_max: float | None,
                        use_native: bool = True):
    """(tiles, faces, counts): per-tile reachable leaf faces, sorted by
    (tile, near-to-far centroid projection)."""
    node_min = np.asarray(bvh.node_min, np.float64)
    node_max = np.asarray(bvh.node_max, np.float64)
    node_face = np.asarray(bvh.node_face)
    node_skip = np.asarray(bvh.node_skip)
    n_nodes = node_face.shape[0]
    n_tiles = beams.center.shape[0]

    if t_max is None:
        diag = np.linalg.norm(node_max[0] - node_min[0])
        far = np.linalg.norm(
            beams.center - np.clip(beams.center, node_min[0], node_max[0]),
            axis=-1).max() + beams.radius.max()
        t_max = float(diag + far) + 1.0
    tan_half = beam_tan_half(beams.cos_half)

    # native C++ culler (OpenMP over tiles); numpy frontier as fallback
    if use_native:
        from ..io.native import cull_candidates_native
        res = cull_candidates_native(bvh, beams.center, beams.axis, tan_half,
                                     beams.radius, beams.valid, t_max)
        if res is not None:
            tiles, faces_out, _, counts = res
            return tiles, faces_out, counts

    # (tile, node) frontier BFS from the root
    live = beams.valid.nonzero()[0].astype(np.int64)
    pair_t = live
    pair_n = np.zeros(live.shape[0], np.int64)
    out_t: list[np.ndarray] = []
    out_f: list[np.ndarray] = []
    while pair_t.size:
        hit = _beam_box_overlap(
            beams.center[pair_t], beams.axis[pair_t], tan_half[pair_t],
            beams.radius[pair_t], node_min[pair_n], node_max[pair_n], t_max)
        t_in = pair_t[hit]
        n_in = pair_n[hit]
        leaf = node_face[n_in] >= 0
        if leaf.any():
            out_t.append(t_in[leaf])
            out_f.append(node_face[n_in[leaf]].astype(np.int64))
        internal_t = t_in[~leaf]
        internal_n = n_in[~leaf]
        left = internal_n + 1
        right = node_skip[left].astype(np.int64)
        in_range = right < n_nodes
        pair_t = np.concatenate([internal_t, internal_t[in_range]])
        pair_n = np.concatenate([left, right[in_range]])

    if not out_t:
        empty = np.zeros(0, np.int64)
        return empty, empty, np.zeros(n_tiles, np.int64)
    tiles = np.concatenate(out_t)
    faces_out = np.concatenate(out_f)
    # near-to-far ordering within each tile (centroid projection on axis)
    is_leaf = node_face >= 0
    leaf_ids = node_face[is_leaf]
    cent = np.zeros((leaf_ids.max() + 1, 3))
    cent[leaf_ids] = (node_min[is_leaf] + node_max[is_leaf]) * 0.5
    proj = np.einsum("ij,ij->i",
                     cent[faces_out] - beams.center[tiles],
                     beams.axis[tiles])
    order = np.lexsort((proj, tiles))
    tiles = tiles[order]
    faces_out = faces_out[order]
    counts = np.bincount(tiles, minlength=n_tiles)
    return tiles, faces_out, counts


def _tile_candidates(bvh: BVH, origins, directions, tile_rays: int,
                     t_max: float | None, use_native: bool):
    """The cull of rays tiled in flat order: (n_tiles, tiles, faces,
    counts, offsets) with each tile's list from ``offsets[t]``."""
    o = np.asarray(origins, np.float64).reshape(-1, 3)
    d = np.asarray(directions, np.float64).reshape(-1, 3)
    if o.shape[0] % tile_rays:
        raise ValueError(f"ray count {o.shape[0]} not a multiple of "
                         f"tile_rays={tile_rays}")
    beams = tile_beams(o, d, tile_rays)
    n_tiles = beams.center.shape[0]
    tiles, faces_out, counts = _collect_candidates(bvh, beams, t_max,
                                                   use_native)
    offsets = np.zeros(n_tiles + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return n_tiles, tiles, faces_out, counts, offsets


def build_tile_candidates(bvh: BVH, origins: np.ndarray,
                          directions: np.ndarray, *,
                          tile_rays: int = DEFAULT_TILE_RAYS,
                          t_max: float | None = None,
                          pad_to: int = DEFAULT_CHUNK,
                          use_native: bool = True) -> np.ndarray:
    """(n_tiles, C) int32 candidate face ids per ray tile, -1 padded, C a
    multiple of ``pad_to``.

    Rays are tiled in flat order: callers should pass coherently ordered
    rays (see `runtime.simulate.bsp_order`).  Ray count must be a multiple
    of ``tile_rays`` (pad with zero-direction rays).  ``t_max`` bounds the
    reachable range (None = conservative scene-diagonal bound).
    ``use_native=False`` takes the numpy culler (the JAX package reads
    ``LIDAR_BRDF_TPU_NO_NATIVE`` for that).
    """
    n_tiles, tiles, faces_out, counts, offsets = _tile_candidates(
        bvh, origins, directions, tile_rays, t_max, use_native)
    c_max = int(counts.max()) if counts.size else 0
    c_max = max(((c_max + pad_to - 1) // pad_to) * pad_to, pad_to)
    cand = np.full((n_tiles, c_max), -1, np.int32)
    if tiles.size:
        col = np.arange(tiles.shape[0]) - offsets[tiles]
        cand[tiles, col] = faces_out.astype(np.int32)
    return cand


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def build_bucketed_candidates(bvh: BVH, origins: np.ndarray,
                              directions: np.ndarray, *,
                              tile_rays: int = DEFAULT_TILE_RAYS,
                              t_max: float | None = None,
                              pad_to: int = DEFAULT_CHUNK,
                              quantize: bool = True,
                              use_native: bool = True):
    """Candidates grouped into size buckets so padding stays local.

    Returns a tuple of (tile_idx (B,) i32, cand (B, C_b) i32) buckets with
    C_b = pad_to * 2^k.  Tiles with no candidates appear in no bucket.  When
    ``quantize``, bucket tile counts are rounded up to powers of two with
    dummy rows (tile id = n_tiles, cand = -1) so repeated chunks mostly
    reuse compiled shapes.
    """
    n_tiles, _, faces_out, counts, offsets = _tile_candidates(
        bvh, origins, directions, tile_rays, t_max, use_native)
    padded = np.maximum(
        pad_to * (2 ** np.ceil(np.log2(np.maximum(
            (counts + pad_to - 1) // pad_to, 1))).astype(np.int64)),
        pad_to)
    buckets = []
    for size in np.unique(padded[counts > 0]):
        tidx = ((padded == size) & (counts > 0)).nonzero()[0]
        B = tidx.shape[0]
        B_pad = _next_pow2(B) if quantize else B
        cand = np.full((B_pad, int(size)), -1, np.int32)
        for row, t in enumerate(tidx):
            c = counts[t]
            cand[row, :c] = faces_out[offsets[t]:offsets[t] + c]
        tidx_arr = np.full(B_pad, n_tiles, np.int32)
        tidx_arr[:B] = tidx
        buckets.append((tidx_arr, cand))
    return tuple(buckets)


# ---------------------------------------------------------------------------
# Device half: the JAX package's culled-path interface over K1
# ---------------------------------------------------------------------------

def _no_exit_bounds(cand: torch.Tensor) -> torch.Tensor:
    """Block bounds that never stop K1 early (a hit's t may be as low as
    -EPSILON, so a bound of 0 could stop it), as the plain version never
    stops: (B, C // 8) f32 of -inf."""
    from ..kernels.traverse import CAND_BLOCK
    return torch.full((cand.shape[0], cand.shape[1] // CAND_BLOCK),
                      float("-inf"), dtype=torch.float32, device=cand.device)


def intersect_culled(wald, cand, origin, direction, *,
                     chunk: int = DEFAULT_CHUNK) -> Hit:
    """Nearest hit of tiled rays against per-tile candidate lists.

    ``wald`` (F, 12) f32 triangle rows; ``cand`` (T, C) i32 (-1 pad),
    C % ``chunk`` == 0 and ``chunk`` a multiple of 8; ``origin`` /
    ``direction`` (T, R, 3).  Returns a `Hit` of shape (T, R); misses are
    (BIG, -1).  On CUDA tensors one launch of K1 (`kernels/traverse.py::
    tile_traverse`): the array is one bucket of every tile (tidx =
    arange(T)), each tile's rays padded to a multiple of 128 with
    zero-direction rays (misses), no early exit, t_max BIG; on CPU tensors
    its plain version.  Ties follow K1's blocks of 8, not ``chunk`` (the
    module's note): ``chunk`` only checks the layout.
    """
    from ..kernels.traverse import CAND_BLOCK, LANES, tile_traverse
    T, C = cand.shape
    if chunk <= 0 or chunk % CAND_BLOCK or C % chunk:
        raise ValueError(f"chunk {chunk} must be a multiple of {CAND_BLOCK} "
                         f"and divide the {C} candidates")
    R = origin.shape[1]
    pad = (-R) % LANES
    o = torch.nn.functional.pad(origin.detach().float(), (0, 0, 0, pad))
    d = torch.nn.functional.pad(direction.detach().float(), (0, 0, 0, pad))
    cand = cand.to(torch.int32).contiguous()
    tidx = torch.arange(T, dtype=torch.int32, device=cand.device)
    t, f = tile_traverse(wald, o.reshape(-1, 3).contiguous(),
                         d.reshape(-1, 3).contiguous(),
                         ((tidx, cand, _no_exit_bounds(cand)),), BIG, R + pad)
    return Hit(t=t.view(T, R + pad)[:, :R], face=f.view(T, R + pad)[:, :R])


class CulledTraverser:
    """Scene-bound culled traverser with the JAX package's interface: the
    beam cull per call on the device (K5, `kernels/cull.py`), then K1,
    through the `kernels/traverse.py::TileTraverser` it wraps (the
    `Simulator`'s).

    Usage::

        tr = CulledTraverser(scene, tile_rays=512, device="cuda")
        data = tr.prepare(bvh, origins, directions)            # K5
        hits = tr(origin, direction, data)                     # K1

    ``traverse_data`` is either a dense (T, C) candidate array (from
    `build_candidates` or `build_tile_candidates`: one bucket of every
    tile) or a tuple of (tile_idx, cand) buckets (from `prepare` on the
    device, `build_buckets` or `build_bucketed_candidates` on the host),
    numpy or tensors.  The lists are those of the JAX package's native
    culler (sorted by (dnear, face)), padded to ``chunk``.  Each call
    launches K1 once on CUDA tensors, with no early exit and t_max BIG;
    ties follow K1's blocks of 8 (the module's note).
    """

    def __init__(self, scene: TriangleScene, *,
                 tile_rays: int = DEFAULT_TILE_RAYS,
                 chunk: int = DEFAULT_CHUNK, device="cuda"):
        from ..kernels.traverse import CAND_BLOCK, TileTraverser
        if chunk % CAND_BLOCK:
            raise ValueError(f"chunk must be a multiple of {CAND_BLOCK}")
        self._tiles = TileTraverser(scene, tile_rays=tile_rays, device=device)
        self._tiles.t_max = BIG
        self.tile_rays = tile_rays
        self.chunk = chunk
        self.device = self._tiles.device
        self.wald = self._tiles.wald

    def build_candidates(self, bvh: BVH, origin, direction,
                         t_max: float | None = None) -> np.ndarray:
        """`build_tile_candidates` (``pad_to`` = ``chunk``) of the device
        cull, as a host array."""
        from ..kernels.cull import list_rows, readback
        lists, beams = self._tiles.cull(bvh, origin, direction, t_max,
                                        pad_to=self.chunk)
        T = beams.center.shape[0]
        longest = readback(lists.counts.max()) if T else 0
        width = max(-(-longest // self.chunk) * self.chunk, self.chunk)
        ids = torch.arange(T, device=lists.counts.device)
        return list_rows(lists, ids, width).cpu().numpy()

    def prepare(self, bvh: BVH, origin, direction,
                t_max: float | None = None):
        """The device cull for one call: a tuple of (tile_idx, cand)
        buckets on the traverser's device (`build_bucketed_candidates`'
        buckets, ``pad_to`` = ``chunk``)."""
        from ..kernels.traverse import buckets_from_lists
        lists, beams = self._tiles.cull(bvh, origin, direction, t_max,
                                        pad_to=self.chunk)
        return buckets_from_lists(lists, beams.center.shape[0])

    def build_buckets(self, bvh: BVH, origin, direction,
                      t_max: float | None = None):
        """`prepare`'s buckets as host arrays."""
        return tuple((t.cpu().numpy(), c.cpu().numpy())
                     for t, c in self.prepare(bvh, origin, direction, t_max))

    def beams_ok(self, origin, direction) -> bool:
        return self._tiles.beams_ok(origin, direction)

    def __call__(self, origin, direction, traverse_data) -> Hit:
        put = lambda a: torch.as_tensor(a).to(
            self.device, torch.int32).contiguous()
        if isinstance(traverse_data, tuple):
            pairs = traverse_data
        else:
            cand = put(traverse_data)
            T = -(-origin.reshape(-1, 3).shape[0] // self.tile_rays)
            if cand.shape[0] != T:
                raise ValueError(f"candidates built for {cand.shape[0]} "
                                 f"tiles, rays give {T}")
            pairs = ((torch.arange(T, dtype=torch.int32), cand),)
        buckets = []
        for tidx, cand in pairs:
            cand = put(cand)
            buckets.append((put(tidx), cand, _no_exit_bounds(cand)))
        return self._tiles(origin, direction, buckets)
