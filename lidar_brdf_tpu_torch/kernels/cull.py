"""Beam cull on the device: the hand-written CUDA kernel K5 and its plain
PyTorch version.

Counterpart of the host C++ `lbt_cull` (`native/lidar_native.cpp`, called
from `lidar_brdf_tpu/geom/beamcull.py::_collect_candidates`), which the
JAX package runs on the host because a TPU does not walk a BVH per beam.
For every valid beam (`geom/beamcull.py::tile_beams_torch`: an origin
sphere and a cone, cast to f32 by `walk_inputs`) it lists the leaf faces
of the threaded BVH whose box, grown by the beam's radius, the beam can
reach within ``t_max``, with each face's conservative near distance, each
list sorted by (dnear, face) as the host's `std::sort` of the pairs sorts
it.  The result is CSR (`CullLists`).

`beam_cull` on CUDA tensors launches `csrc/beam_cull.cu` (built with nvcc
at first use into `build/kernels/`, loaded with ctypes): one walk of each
beam into a scratch of ``capacity`` entries a beam, an exclusive scan of
the counts (`torch.cumsum`), then a place pass that copies each list to
its CSR offset (walking again the beams whose lists did not fit) and a
sort of the long lists: `LAUNCHES` launches a call, whatever the data.
`schedule` picks the walk's lanes a beam (a block of 128 lanes a beam for
few beams, one thread a beam where the beams alone fill the card) and the
capacity from the number of beams.  On CPU tensors it runs `cull_plain`,
the same walk as a frontier over (beam, node) pairs in torch f32, every
operation written out per component in the host's order, through a
scratch of the same capacity.  It never falls back from one to the other.

Between the walk and the place pass the wrapper reads back one small
vector: the total (to allocate the lists), how many beams are over
capacity, and how many beams fall in each padded list size (``pad_to <<
k``), which fixes the shapes of the buckets and ladders built from the
lists (`kernels/traverse.py::buckets_from_lists`,
`kernels/pulse.py::ladders_from_lists`).  `readback` counts these reads
(`READBACKS`), and so the narrowness flag's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..runtime.metrics import count
from .cuda_build import CudaLibrary, check_tensor, raw_stream

LAUNCHES = 3          # K5 launches a `beam_cull` call: walk, place, sort
GROUP_LANES = 128     # lanes a beam where the beams are few (a block)
GROUP_BEAMS = 8192    # at most this many beams take GROUP_LANES lanes each
SCRATCH_ENTRIES = 1 << 22  # scratch entries a call aims at (32 MB)
CAP_MIN, CAP_MAX = 16, 1024  # scratch entries a beam
BLOCK = 128           # threads a block of the walk and place kernels
# lanes a beam the walk is written for; the source builds 1 and
# GROUP_LANES, `scripts/k5_variants.py` the others
LANES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
STACK_SMEM = 48 * 1024  # shared bytes a block's group stacks may take
SIZE_CLASSES = 40     # padded list sizes pad_to << k for k < 39; 39: none
NO_LIST = SIZE_CLASSES - 1
ITERS = 24            # ternary-search steps of the beam/box test
PLAIN_PAIRS = 1 << 21  # (beam, node) pairs the plain version tests at once
READBACKS = 0         # host reads of cull results (`readback`)


def _declare(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    beams = [vp, ci, vp, vp, vp, vp, vp, ci, cf, ci, ci, ci, vp]
    lib.lbt_beam_cull_walk.argtypes = beams + [vp, vp, vp, vp]
    lib.lbt_beam_cull_walk.restype = ci
    lib.lbt_beam_cull_place.argtypes = beams + [vp, vp, vp, vp, vp, vp, vp]
    lib.lbt_beam_cull_place.restype = ci


KERNEL = CudaLibrary("beam_cull.cu", _declare, "lbt_beam_cull_walk")


class CullLists(NamedTuple):
    """One cull's candidate lists, CSR, on the beams' device."""
    counts: torch.Tensor    # (T,) i32 faces of each beam
    offsets: torch.Tensor   # (T + 1,) i64 exclusive scan of the counts
    faces: torch.Tensor     # (total,) i32 beam by beam, (dnear, face) order
    dnear: torch.Tensor     # (total,) f32 conservative near distances
    order: torch.Tensor     # (T,) i64 beams by padded size, stable; empty last
    sizes: tuple            # ((padded size, beams), ...) ascending, host ints
    overflow: int = 0       # beams whose lists were over the scratch's capacity


class NodeCache:
    """A BVH's node records on one device (`geom/packet.py::pack_bvh`),
    packed at the first call for that BVH and kept: ``cache(bvh)`` gives
    the (box, skip, face) views that K5 and K4 read, and ``cache.depth``
    the tree's depth (`tree_depth`, which sizes K5's stacks)."""

    def __init__(self, device):
        self.device = device
        self._bvh = None
        self._nodes = None
        self.depth = None

    def __call__(self, bvh):
        if self._bvh is not bvh:
            from ..geom.packet import pack_bvh
            self._nodes = pack_bvh(bvh, self.device)
            self.depth = tree_depth(self._nodes[1], self._nodes[2])
            self._bvh = bvh
        return self._nodes


def tree_depth(skip: torch.Tensor, face: torch.Tensor) -> int:
    """The depth of a threaded BVH (the root at depth 0; -1 for no nodes),
    whose internal node n has the children n + 1 and ``skip[n + 1]`` (when
    that is a node), as `cull_plain` and K5 expand them: one level at a
    time, one host read a level."""
    N = face.shape[0]
    level = torch.zeros(min(N, 1), dtype=torch.int64, device=face.device)
    depth = -1
    while level.numel():
        depth += 1
        inner = level[face[level] < 0] + 1
        right = skip[inner].long()
        level = torch.cat([inner, right[right < N]])
    return depth


def schedule(n_beams: int) -> tuple:
    """(lanes a beam, scratch entries a beam) of a call on ``n_beams``
    beams: `GROUP_LANES` lanes a beam for up to `GROUP_BEAMS` beams (a
    `tls` chunk's 2,048 tiles: 2,048 blocks), else one thread a beam (an
    `als` chunk's 131,072 pulses fill the card alone); a capacity that
    keeps the scratch near `SCRATCH_ENTRIES`, a power of two within
    [`CAP_MIN`, `CAP_MAX`] (1,024 on the `tls` chunk, whose longest list is
    684; 32 on the `als` chunk, longest 10)."""
    lanes = GROUP_LANES if n_beams <= GROUP_BEAMS else 1
    fit = SCRATCH_ENTRIES // max(n_beams, 1)
    cap = 1 << max(fit.bit_length() - 1, 0)
    return lanes, min(max(cap, CAP_MIN), CAP_MAX)


def stack_entries(lanes: int, depth: int) -> int:
    """Stack entries a group of ``lanes`` lanes needs on a tree of
    ``depth``: each round pops up to ``lanes`` nodes from the top and
    pushes at most two children of each, so of a push batch at most
    ``lanes`` stay below the next, and the batches left hold nodes one
    level deeper each: at most ``lanes`` a level and 2 ``lanes`` on top."""
    return lanes * (max(depth, 0) + 2)


def stacks_in_shared(lanes: int, depth: int) -> bool:
    """Whether a block's group stacks fit `STACK_SMEM` (else the wrapper
    gives them device memory): a block holds `BLOCK` // ``lanes`` groups
    of up to a warp, or one wider group."""
    groups = BLOCK // lanes if lanes <= 32 else 1
    return groups * stack_entries(lanes, depth) * 4 <= STACK_SMEM


def readback(x: torch.Tensor) -> list:
    """``x`` as host numbers: one of the few reads a culled chunk makes
    from the card (counted in `READBACKS`)."""
    global READBACKS
    READBACKS += 1
    return x.tolist()


def walk_inputs(beams):
    """The f32 / u8 arrays the walk reads (center, axis, tan_half, radius,
    valid) from f64 beam tensors (`geom/beamcull.py::tile_beams_torch`),
    ``tan_half`` computed in float64 as `_collect_candidates` computes it:
    the casts of `io/native.py::cull_candidates_native`."""
    from ..geom.beamcull import beam_tan_half
    f32 = lambda a: a.to(torch.float32).contiguous()
    return (f32(beams.center), f32(beams.axis),
            f32(beam_tan_half(beams.cos_half)), f32(beams.radius),
            beams.valid.to(torch.uint8).contiguous())


def size_classes(counts: torch.Tensor, pad_to: int) -> torch.Tensor:
    """k (T,) i64 such that a list of c > 0 faces pads to ``pad_to << k``
    (``pad_to * 2 ** ceil(log2(ceil(c / pad_to)))``, the host bucketing's
    rule); `NO_LIST` for c = 0."""
    c = counts.long()
    blocks = torch.clamp((c + pad_to - 1) // pad_to, min=1)
    k = torch.ceil(torch.log2(blocks.double())).long()
    return torch.where(c > 0, k, torch.full_like(k, NO_LIST))


def _summary(counts: torch.Tensor, offsets: torch.Tensor, pad_to: int,
             capacity: int | None = None):
    """(total, sizes, order, beams over ``capacity``) of the counts: one
    read from the device."""
    key = size_classes(counts, pad_to)
    hist = torch.zeros(SIZE_CLASSES + 1, dtype=torch.int64,
                       device=key.device)     # the last: beams over capacity
    hist.scatter_add_(0, key, torch.ones_like(key))
    if capacity is not None:
        hist[-1] = (counts > capacity).sum()
    total, *hist = readback(torch.cat([offsets[-1:], hist]))
    sizes = tuple((pad_to << k, b) for k, b in enumerate(hist[:NO_LIST])
                  if b)
    return int(total), sizes, torch.argsort(key, stable=True), hist[-1]


def lists_of(counts, offsets, faces, dnear, pad_to: int = 8) -> CullLists:
    """`CullLists` of CSR lists (`cull_plain`'s), sized for ``pad_to``."""
    _, sizes, order, _ = _summary(counts, offsets, pad_to)
    return CullLists(counts, offsets, faces, dnear, order, sizes)


def _validate(box, skip, face, center, axis, tan_half, radius, valid):
    dev = center.get_device()
    base = box.data_ptr()
    if not (box.dtype is torch.float32 and skip.dtype is torch.int32
            and face.dtype is torch.int32 and box.get_device() == dev
            and box.dim() == 2 and box.shape[1] == 6
            and box.stride() == (8, 1) and skip.stride() == (8,)
            and face.stride() == (8,) and skip.data_ptr() == base + 24
            and face.data_ptr() == base + 28 and base % 16 == 0):
        raise ValueError("the node arrays must be views of one (N, 8) f32 "
                         "record on the beams' device, starting on a "
                         "16-byte boundary (geom/packet.py::pack_bvh)")
    for name, x, dt, nd in (("center", center, torch.float32, 2),
                            ("axis", axis, torch.float32, 2),
                            ("tan_half", tan_half, torch.float32, 1),
                            ("radius", radius, torch.float32, 1),
                            ("valid", valid, torch.uint8, 1)):
        check_tensor(name, x, dt, nd, dev)
    T = center.shape[0]
    if center.shape != (T, 3) or axis.shape != (T, 3) or any(
            x.shape != (T,) for x in (tan_half, radius, valid)):
        raise ValueError("beams must be center/axis (T, 3), tan_half/"
                         "radius/valid (T,)")
    if box.shape[0] >= 2 ** 30 or T >= 2 ** 31:
        raise ValueError("over the kernel's 2^30 nodes or 2^31 beams")


def beam_cull(nodes, center, axis, tan_half, radius, valid, t_max: float,
              pad_to: int = 8, *, depth: int | None = None,
              lanes: int | None = None,
              capacity: int | None = None) -> CullLists:
    """Candidate lists of beams over a threaded BVH.

    ``nodes``: (box (N, 6) f32, skip (N,) i32, face (N,) i32), the views of
    one (N, 8) record `geom/packet.py::pack_bvh` makes; beams (`walk_inputs`)
    ``center``/``axis`` (T, 3) f32, ``tan_half``/``radius`` (T,) f32,
    ``valid`` (T,) u8, on the same device; ``t_max`` the reach (rounded to
    f32 as the host's binding rounds it).  ``pad_to``: the list padding the
    caller's buckets take (sizes and order of `CullLists`).  ``depth``: the
    tree's (`NodeCache.depth`; None: `tree_depth`, one host read a level).
    ``lanes`` and ``capacity`` override `schedule`'s.  CUDA tensors launch
    K5 `LAUNCHES` times (none for no beams); CPU tensors take `cull_plain`
    through a scratch of ``capacity``.
    """
    box, skip, face = nodes
    T = center.shape[0]
    auto_lanes, auto_cap = schedule(T)
    lanes = auto_lanes if lanes is None else int(lanes)
    capacity = auto_cap if capacity is None else int(capacity)
    if lanes not in LANES or capacity < 1:
        raise ValueError(f"lanes must be one of {LANES} and capacity "
                         f"positive")
    if center.device.type == "cpu":
        counts, offsets, faces, dnear = cull_plain(
            nodes, center, axis, tan_half, radius, valid, t_max,
            capacity=capacity)
        total, sizes, order, over = _summary(counts, offsets, pad_to,
                                             capacity)
        count("pairs", total)
        return CullLists(counts, offsets, faces, dnear, order, sizes, over)
    if not center.is_cuda:
        raise ValueError(f"unsupported device {center.device}")
    _validate(box, skip, face, center, axis, tan_half, radius, valid)
    dev = center.device
    N = box.shape[0]
    if T == 0:      # the entry points launch nothing for no beams
        empty = lambda dt: torch.zeros(0, dtype=dt, device=dev)
        return CullLists(empty(torch.int32),
                         torch.zeros(1, dtype=torch.int64, device=dev),
                         empty(torch.int32), empty(torch.float32),
                         empty(torch.int64), ())
    stream = raw_stream(center.get_device())
    i32 = lambda n: torch.empty(n, dtype=torch.int32, device=dev)
    stack_cap, gstack = 0, None
    if lanes > 1:
        if depth is None:
            depth = tree_depth(skip, face)
        stack_cap = stack_entries(lanes, depth)
        if not stacks_in_shared(lanes, depth):
            gstack = i32(T * stack_cap)
    beams = (box.data_ptr(), N, center.data_ptr(), axis.data_ptr(),
             tan_half.data_ptr(), radius.data_ptr(), valid.data_ptr(), T,
             float(t_max), lanes, capacity, stack_cap,
             0 if gstack is None else gstack.data_ptr())
    counts = i32(T)
    sfaces = i32(T * capacity)
    sdnear = torch.empty(T * capacity, dtype=torch.float32, device=dev)
    KERNEL.check(KERNEL.launcher()(*beams, counts.data_ptr(),
                                   sfaces.data_ptr(), sdnear.data_ptr(),
                                   stream), "beam_cull walk")
    KERNEL.launches += 1
    offsets = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    total, sizes, order, over = _summary(counts, offsets, pad_to, capacity)
    count("pairs", total)
    faces = i32(total)
    dnear = torch.empty(total, dtype=torch.float32, device=dev)
    KERNEL.check(KERNEL.lib.lbt_beam_cull_place(
        *beams, counts.data_ptr(), sfaces.data_ptr(), sdnear.data_ptr(),
        offsets.data_ptr(), faces.data_ptr(), dnear.data_ptr(), stream),
        "beam_cull place")
    KERNEL.launches += 2
    return CullLists(counts, offsets, faces, dnear, order, sizes, over)


def cull_rays(nodes, origin, direction, rays_per_beam: int,
              t_max: float | None, pad_to: int = 8, *,
              narrow_only: bool = False, depth: int | None = None):
    """(lists, beams) of the beams of ``rays_per_beam`` consecutive rays,
    ``origin``/``direction`` (N, 3) f32 on the nodes' device: the float64
    beams (`geom/beamcull.py::tile_beams_torch`), then `beam_cull` (on a
    tree of ``depth``).
    ``t_max`` None is `_collect_candidates`' rule (one host read).  With
    ``narrow_only``, None when a beam is too wide to cull
    (`beams_are_narrow`; one host read)."""
    from ..geom.beamcull import (cull_t_max_torch, narrow_flag,
                                 tile_beams_torch)
    beams = tile_beams_torch(origin, direction, rays_per_beam)
    if narrow_only and not readback(narrow_flag(beams)):
        return None
    if t_max is None:
        box = nodes[0]
        t_max = readback(cull_t_max_torch(box[0, :3], box[0, 3:], beams))
    return beam_cull(nodes, *walk_inputs(beams), t_max, pad_to,
                     depth=depth), beams


def list_rows(lists: CullLists, ids: torch.Tensor, size: int) -> torch.Tensor:
    """(len(ids), size) i32: the lists of beams ``ids``, -1 padded."""
    col = torch.arange(size, device=ids.device)
    cnt = lists.counts[ids].long()
    src = lists.offsets[ids][:, None] + col[None, :]
    ok = col[None, :] < cnt[:, None]
    if lists.faces.numel() == 0:
        return torch.full(src.shape, -1, dtype=torch.int32,
                          device=ids.device)
    vals = lists.faces[torch.clamp(src, max=lists.faces.numel() - 1)]
    return torch.where(ok, vals, torch.full_like(vals, -1))


def bucket_rows(lists: CullLists, rows_of, fill_id: int):
    """((ids (B_pad,) i32, cand (B_pad, size) i32) per padded size): the
    beams of each size in ascending id, ``rows_of(B)`` rows, dummy rows
    with id ``fill_id`` and no candidates."""
    out, start = [], 0
    for size, B in lists.sizes:
        ids = lists.order[start:start + B]
        start += B
        rows = rows_of(B)
        dev = ids.device
        idx = torch.full((rows,), fill_id, dtype=torch.int32, device=dev)
        idx[:B] = ids
        cand = torch.full((rows, size), -1, dtype=torch.int32, device=dev)
        cand[:B] = list_rows(lists, ids, size)
        out.append((idx, cand))
    return tuple(out)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _min(a, b):
    """``std::min(a, b)``."""
    return torch.where(b < a, b, a)


def _max(a, b):
    """``std::max(a, b)``."""
    return torch.where(a < b, b, a)


class _F32:
    """The host source's f32 constants on one device."""

    def __init__(self, device):
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        self.zero, self.half, self.one = f(0.0), f(0.5), f(1.0)
        self.third = f(1.0 / 3.0)
        self.tiny, self.neg_tiny = f(1e-12), f(-1e-12)
        self.big, self.neg_big = f(3.4e38), f(-3.4e38)
        self.slack0, self.slack1 = f(1e-4), f(1e-5)


def _gap(c, a, tan, g0, g1, s):
    """`beam_gap`: dist(c + s a, grown box) - s tan, with the three
    components of ``c``, ``a``, ``g0``, ``g1`` stacked in the first
    dimension (3, n) (each operation is elementwise; the squares are summed
    in the host's order)."""
    p = c + s * a
    q = _min(_max(p, g0), g1) - p
    q = q * q
    return torch.sqrt((q[0] + q[1]) + q[2]) - s * tan


def _overlap_plain(c, a, tan, r, box, tm, k: _F32):
    """`beam_box_overlap` over pairs: (accept (n,) bool, pairs that reached
    the ternary search).  ``c``/``a`` (3, n), ``box`` (n, 6)."""
    g0 = box[:, :3].t() - r
    g1 = box[:, 3:].t() + r
    tiny = torch.where(a < 0, k.neg_tiny, k.tiny)
    inv = k.one / torch.where(torch.abs(a) < k.tiny, tiny, a)
    t0 = (g0 - c) * inv
    t1 = (g1 - c) * inv
    lo, hi = _min(t0, t1), _max(t0, t1)
    t_near = _max(_max(_max(k.neg_big, lo[0]), lo[1]), lo[2])
    t_far = _min(_min(_min(k.big, hi[0]), hi[1]), hi[2])
    accept = (t_far >= _max(t_near, k.zero)) & (t_near <= tm)
    rest = torch.nonzero(~accept)[:, 0]
    n = rest.numel()
    if n:
        # m1 and m2 side by side: (3, 2n) copies of the pairs' beams
        two = lambda x: torch.cat([x[..., rest], x[..., rest]], dim=-1)
        c2, a2, g02, g12, tan2 = two(c), two(a), two(g0), two(g1), two(tan)
        lo = k.zero.expand(n)
        hi = tm.expand(n)
        for _ in range(ITERS):
            m1 = lo + (hi - lo) * k.third
            m2 = hi - (hi - lo) * k.third
            g = _gap(c2, a2, tan2, g02, g12, torch.cat([m1, m2]))
            left = g[:n] < g[n:]
            hi = torch.where(left, m2, hi)
            lo = torch.where(left, lo, m1)
        slack = k.slack0 + k.slack1 * tm
        accept[rest] = _gap(c2[:, :n], a2[:, :n], tan2[:n], g02[:, :n],
                            g12[:, :n], k.half * (lo + hi)) <= slack
    return accept, n


def _near_plain(c, a, r, box, k: _F32):
    """The host's near distance of leaf boxes along the beam axis
    (``c``/``a`` (3, n), ``box`` (n, 6))."""
    mid = k.half * (box[:, :3] + box[:, 3:]).t()
    ext = k.half * (box[:, 3:] - box[:, :3]).t()
    proj = (mid - c) * a
    slack = ext * torch.abs(a)
    dn = (((proj[0] + proj[1]) + proj[2])
          - ((slack[0] + slack[1]) + slack[2])) - r
    return _max(dn, k.zero)


def _frontier(nodes, center, axis, tan_half, radius, valid, t_max: float,
              k: _F32, stats: dict | None = None):
    """(beam, face, dnear) of every listed leaf of the valid beams, in the
    frontier's order: each (beam, node) pair is tested
    (`_overlap_plain`, at most `PLAIN_PAIRS` at a time), a leaf that
    passes joins its beam's list with its near distance, an internal node
    that passes gives its two children (node + 1 and that child's skip
    link).  ``stats`` gets the node tests and those that reached the
    ternary search."""
    box, skip, face = nodes
    dev = center.device
    tm = torch.tensor(float(t_max), dtype=torch.float32, device=dev)
    N = face.shape[0]
    ct, at = center.t(), axis.t()
    pair_t = torch.nonzero(valid.bool())[:, 0]
    pair_n = torch.zeros_like(pair_t)
    if N == 0:
        pair_t = pair_n = pair_t[:0]
    out_t = [pair_t[:0]]
    out_f = [torch.zeros(0, dtype=torch.int32, device=dev)]
    out_d = [torch.zeros(0, dtype=torch.float32, device=dev)]
    n_tests = n_ternary = 0
    while pair_t.numel():
        hit = torch.empty(pair_t.shape, dtype=torch.bool, device=dev)
        for lo in range(0, pair_t.numel(), PLAIN_PAIRS):
            sl = slice(lo, lo + PLAIN_PAIRS)
            t, n = pair_t[sl], pair_n[sl]
            hit[sl], n_rest = _overlap_plain(ct[:, t], at[:, t], tan_half[t],
                                             radius[t], box[n], tm, k)
            n_ternary += n_rest
        n_tests += pair_t.numel()
        t_in, n_in = pair_t[hit], pair_n[hit]
        fid = face[n_in]
        leaf = fid >= 0
        lt, ln = t_in[leaf], n_in[leaf]
        out_t.append(lt)
        out_f.append(fid[leaf])
        out_d.append(_near_plain(ct[:, lt], at[:, lt], radius[lt], box[ln],
                                 k))
        it, inode = t_in[~leaf], n_in[~leaf]
        left = inode + 1
        right = skip[left].long()
        more = right < N
        pair_t = torch.cat([it, it[more]])
        pair_n = torch.cat([left, right[more]])
    if stats is not None:
        stats["node_tests"] = stats.get("node_tests", 0) + n_tests
        stats["ternary_tests"] = stats.get("ternary_tests", 0) + n_ternary
    return torch.cat(out_t), torch.cat(out_f), torch.cat(out_d)


def _through_scratch(beam, fcs, dn, counts, capacity: int, rewalk):
    """K5's place pass on the walk's entries: each beam's first
    ``capacity`` entries in walk order are what its scratch holds
    ((T, capacity) faces and near distances); a beam of at most
    ``capacity`` is copied from there, one over it is walked again
    (``rewalk(mask)``: (beam, face, dnear) of the beams ``mask`` names).
    Returns the entries placed, unsorted."""
    T = counts.shape[0]
    dev = beam.device
    by_beam = torch.argsort(beam, stable=True)
    start = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts.long(), 0, out=start[1:])
    pos = torch.arange(beam.numel(), device=dev) - start[beam[by_beam]]
    kept = by_beam[pos < capacity]
    slot = pos[pos < capacity]
    sf = torch.full((T, capacity), -1, dtype=torch.int32, device=dev)
    sd = torch.zeros((T, capacity), dtype=torch.float32, device=dev)
    sf[beam[kept], slot] = fcs[kept]
    sd[beam[kept], slot] = dn[kept]
    fits = counts.long() <= capacity
    col = torch.arange(capacity, device=dev)
    take = fits[:, None] & (col[None, :] < counts.long()[:, None])
    rows = torch.arange(T, device=dev)[:, None].expand(T, capacity)
    rt, rf, rd = rewalk(~fits)
    return (torch.cat([rows[take], rt]), torch.cat([sf[take], rf]),
            torch.cat([sd[take], rd]))


def cull_plain(nodes, center, axis, tan_half, radius, valid, t_max: float,
               stats: dict | None = None, capacity: int | None = None):
    """Plain PyTorch version of K5: (counts (T,) i32, offsets (T + 1,) i64,
    faces (total,) i32, dnear (total,) f32), bit-equal to the kernel.

    The walk is a frontier over (beam, node) pairs from the root
    (`_frontier`); with ``capacity``, its entries then go through K5's
    scratch of that many entries a beam (`_through_scratch`: the beams
    over it walked again), which gives the same lists.  The lists are then
    sorted by (beam, dnear, face).  ``stats``, when given, gets the node
    tests, those that reached the ternary search and the leaves listed of
    the first walk (the work the kernel's bound counts).
    """
    k = _F32(center.device)
    T = center.shape[0]
    walk = lambda ok: _frontier(nodes, center, axis, tan_half, radius, ok,
                                t_max, k, stats)
    beam, fcs, dn = walk(valid)
    counts = torch.bincount(beam, minlength=T).to(torch.int32)
    if stats is not None:
        stats["leaves"] = stats.get("leaves", 0) + int(beam.numel())
    if capacity is not None:
        beam, fcs, dn = _through_scratch(
            beam, fcs, dn, counts, capacity,
            lambda over: _frontier(nodes, center, axis, tan_half, radius,
                                   valid.bool() & over, t_max, k))
    # (beam, dnear, face) order; -0 and +0 compare equal, as in the host
    idx = torch.argsort(fcs, stable=True)
    idx = idx[torch.argsort((dn + k.zero)[idx], stable=True)]
    idx = idx[torch.argsort(beam[idx], stable=True)]
    offsets = torch.zeros(T + 1, dtype=torch.int64, device=center.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return counts, offsets, fcs[idx].contiguous(), dn[idx].contiguous()
