"""Packet walk of the threaded BVH: the hand-written CUDA kernel K4 and its
plain PyTorch version.

Counterpart of the loop of `lidar_brdf_tpu/geom/packet.py::
intersect_packed_scene`, which the JAX package leaves to XLA as a
`lax.while_loop` on the device (it is not a Pallas kernel).  Rays are cut
into packets of consecutive rays; each packet walks the tree once,
descending into a node when any of its rays hits the node's box closer
than that ray's best hit, and testing every leaf it reaches on all of its
rays.  The JAX package walks tiles of 128 rays; K4 walks packets of
`PACKET` = 1 by default (each ray its own walk, one lane a ray: measured
fastest, `PERF.md`), or the JAX tile of 128 rays a warp.  The width
changes which leaves a ray is tested against but not, in exact
arithmetic, its nearest hit.

An optional ``active`` mask limits the walk to the rays that need it: the
active rays' indices are compacted in order (`compact`: a cumsum and a
scatter, on the mask's device, no host sync), packets are cut from that
list, and every inactive ray gets the miss (BIG, -1) untested.

`packet_traverse` takes the packed scene's arrays (`geom/packet.py::
pack_scene`): the three node arrays are views of one (N, 8) record and the
triangle rows a view of (F, 12) rows (`node_records`, `geom/packet.py::
triangle_rows`), the layouts K4 reads in 16-byte loads.  On a CUDA tensor
it launches `csrc/packet_traverse.cu` once (built with nvcc at first use
into `build/kernels/`, loaded with ctypes); on a CPU tensor it runs
`packet_traverse_plain`.  It never falls back from one to the other.
Eager PyTorch has no device loop: the plain version's loop tests on the
host, every step, which packets are still walking.
"""

from __future__ import annotations

import ctypes

import torch

from ..geom.intersect import BIG, EPSILON, slab_test
from ..utils.safemath import cross3, dot3
from .cuda_build import CudaLibrary, check_tensor, raw_stream

PACKET = 1           # rays of a packet (K4's default: each ray walks alone)
WIDTHS = (1, 128)    # packet widths K4 is built for (128: one warp, the JAX tile)
TINY_DIR = 1e-12     # |d| below this is replaced by +-TINY_DIR for 1 / d
PAD_ORIGIN = 1e10    # a packet's lanes past the last ray: never hit


def _declare(lib):
    vp = ctypes.c_void_p
    lib.lbt_packet_traverse.argtypes = [
        vp, vp, ctypes.c_int, vp, vp, ctypes.c_int64, vp, vp, vp, vp, vp, vp,
        vp, ctypes.c_int, vp]
    lib.lbt_packet_traverse.restype = ctypes.c_int


KERNEL = CudaLibrary("packet_traverse.cu", _declare, "lbt_packet_traverse")


def node_records(node_box, node_skip, node_face):
    """(box (N, 6), skip (N,), face (N,)) as views of one (N, 8) f32 record
    per node, [min.xyz max.xyz skip face], the two ints stored bit for bit
    in f32 lanes: the layout K4 reads (32 bytes a node, as the three
    arrays take apart)."""
    n = node_box.shape[0]
    rec = torch.empty((n, 8), dtype=torch.float32, device=node_box.device)
    rec[:, :6] = node_box
    ints = rec.view(torch.int32)
    ints[:, 6] = node_skip
    ints[:, 7] = node_face
    return rec[:, :6], ints[:, 6], ints[:, 7]


def packets(n: int, width: int = PACKET) -> int:
    """Packets of ``width`` rays that ``n`` rays make: the rows of
    ``steps``."""
    return -(-n // width)


def _layout_ok(node_box, node_skip, node_face, tri_rows) -> bool:
    base = node_box.data_ptr()
    return (node_box.stride() == (8, 1) and node_skip.stride() == (8,)
            and node_face.stride() == (8,)
            and node_skip.data_ptr() == base + 24
            and node_face.data_ptr() == base + 28
            and tri_rows.stride() == (12, 1))


def _validate(node_box, node_skip, node_face, tri_rows, origin, direction,
              steps, active, width):
    dev = origin.get_device()
    for name, x, dtype, ndim in (("node_box", node_box, torch.float32, 2),
                                 ("node_skip", node_skip, torch.int32, 1),
                                 ("node_face", node_face, torch.int32, 1),
                                 ("tri_rows", tri_rows, torch.float32, 2)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if x.dtype is not dtype or x.dim() != ndim or x.get_device() != dev:
            raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor on "
                             f"{origin.device}")
    check_tensor("origin", origin, torch.float32, 2, dev)
    check_tensor("direction", direction, torch.float32, 2, dev)
    n = node_box.shape[0]
    if node_box.shape[1] != 6 or tri_rows.shape[1] != 9 \
            or node_skip.shape[0] != n or node_face.shape[0] != n:
        raise ValueError("node_box must be (N, 6), node_skip and node_face "
                         "(N,), tri_rows (F, 9)")
    if n and tri_rows.shape[0] and not _layout_ok(node_box, node_skip,
                                                  node_face, tri_rows):
        raise ValueError("the node arrays must be views of one (N, 8) record "
                         "and tri_rows of (F, 12) rows (geom/packet.py::"
                         "pack_scene, triangle_rows; node_records)")
    if origin.shape[1] != 3 or direction.shape != origin.shape:
        raise ValueError("origin/direction must be (N, 3)")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}")
    if active is not None:
        check_tensor("active", active, torch.bool, 1, dev)
        if active.shape[0] != origin.shape[0]:
            raise ValueError("active must be (N,)")
    if steps is not None:
        check_tensor("steps", steps, torch.int32, 2, dev)
        if tuple(steps.shape) != (packets(origin.shape[0], width), 2):
            raise ValueError(f"steps must be (packets of {width} rays, 2)")


def compact(active):
    """The active rays' indices in order, and their count, on the mask's
    device without a host sync: (order (2N,) i32, whose first `count`
    entries are the list; count (1,) i32).  Inactive ray i is written to
    slot N + i, never read: one slot for them all would make every write
    of a mostly inactive mask wait on the same address."""
    n = active.shape[0]
    idx = torch.arange(n, device=active.device)
    pos = torch.cumsum(active, 0, dtype=torch.int32)
    slot = torch.where(active, pos - 1, idx + n)
    order = torch.empty(2 * n, dtype=torch.int32, device=active.device)
    order.scatter_(0, slot, idx.int())
    return order, pos[n - 1:]


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def packet_traverse(node_box, node_skip, node_face, tri_rows, origin,
                    direction, steps=None, *, active=None, width=PACKET):
    """Nearest (t, face) per ray by the packet walk.

    ``node_box`` (N, 6) f32 [min, max], ``node_skip`` and ``node_face``
    (N,) i32 (leaf face, -1 internal), views of one (N, 8) record;
    ``tri_rows`` (F, 9) f32 [v0, e1, e2], a view of (F, 12) rows;
    ``origin``/``direction`` (R, 3) f32.  ``active`` (R,) bool or None
    (every ray walks); packets are ``width`` consecutive rays of the active
    ones (`WIDTHS`).  Returns (t (R,) f32, face (R,) i32); misses and
    inactive rays are (BIG, -1).  ``steps``, when given, a (`packets`(R,
    width), 2) i32 tensor whose first rows (one per packet walked) receive
    the walk lengths: node steps, of which leaf steps; rows past the last
    packet are left as they are.  CUDA tensors launch K4 once; CPU tensors
    take `packet_traverse_plain`.
    """
    _validate(node_box, node_skip, node_face, tri_rows, origin, direction,
              steps, active, width)
    if not origin.is_cuda:
        if origin.device.type == "cpu":
            return packet_traverse_plain(node_box, node_skip, node_face,
                                         tri_rows, origin, direction, steps,
                                         active=active, width=width)
        raise ValueError(f"unsupported device {origin.device}")
    if node_box.shape[0] >= 2 ** 31 or origin.shape[0] >= 2 ** 31:
        raise ValueError("over 2^31 nodes or rays")
    n = origin.shape[0]
    out_t = torch.empty((n,), dtype=torch.float32, device=origin.device)
    out_f = torch.empty((n,), dtype=torch.int32, device=origin.device)
    if n:
        order = count = None
        if active is not None:
            order, count = compact(active)
        work = torch.zeros(1, dtype=torch.int32, device=origin.device)
        rc = KERNEL.launcher()(
            node_box.data_ptr(), tri_rows.data_ptr(), node_box.shape[0],
            origin.data_ptr(), direction.data_ptr(), n, _ptr(order),
            _ptr(count), _ptr(active), work.data_ptr(), out_t.data_ptr(),
            out_f.data_ptr(), _ptr(steps), width,
            raw_stream(origin.get_device()))
        KERNEL.check(rc, "packet_traverse")
        KERNEL.launches += 1
    return out_t, out_f


def packet_traverse_plain(node_box, node_skip, node_face, tri_rows, origin,
                          direction, steps=None, *, active=None,
                          width=PACKET):
    """Plain PyTorch version of K4: same signature and results.

    The active rays are compacted as the kernel's wrapper does it and cut
    into packets of ``width``, the last padded with rays at 1e10 of
    direction 0.  One loop step advances every packet that is still walking
    by one node, all of them at once; a packet leaves the loop when its
    walk passes the last node.  Each step computes both the slab test and
    the triangle test, as the JAX loop body does, and keeps the one the
    node needs.
    """
    dev = origin.device
    n = origin.shape[0]
    N = node_box.shape[0]
    W = width
    if active is None:
        idx = torch.arange(n, device=dev)
    else:
        order, count = compact(active)
        idx = order[:int(count) if n else 0].long()
    m = idx.numel()
    T = packets(m, W)
    pad = T * W - m
    o, d = origin[idx], direction[idx]
    if pad:
        o = torch.cat([o, o.new_full((pad, 3), PAD_ORIGIN)])
        d = torch.cat([d, d.new_zeros((pad, 3))])
    o = o.reshape(T, W, 3)
    d = d.reshape(T, W, 3)
    tiny = torch.full_like(d, TINY_DIR)
    d_safe = torch.where(torch.abs(d) < TINY_DIR,
                         torch.where(d < 0, -tiny, tiny), d)
    inv_d = 1.0 / d_safe
    node = torch.zeros(T, dtype=torch.int64, device=dev)
    t_best = torch.full((T, W), BIG, dtype=torch.float32, device=dev)
    f_best = torch.full((T, W), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((T, 2), dtype=torch.int32, device=dev)
    live = torch.arange(T, device=dev) if N else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    while live.numel():
        nd = node[live]
        box = node_box[nd][:, None, :]                       # (A, 1, 6)
        skip = node_skip[nd].long()
        face = node_face[nd]
        leaf = face >= 0
        oo, dd, ii = o[live], d[live], inv_d[live]
        tb, fb = t_best[live], f_best[live]
        hit_ray = slab_test(oo, ii, box[..., 0:3], box[..., 3:6], tb)  # (A, W)
        # Moller-Trumbore on the leaf's row [v0, e1, e2]
        tri = tri_rows[torch.clamp(face, min=0).long()][:, None, :]
        v0, e1, e2 = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
        h = cross3(dd, e2)
        a = dot3(e1, h)
        one = torch.ones_like(a)
        ok_det = torch.abs(a) >= EPSILON
        f = 1.0 / torch.where(ok_det, a, torch.where(a < 0, -one, one))
        s = oo - v0
        u = f * dot3(s, h)
        q = cross3(s, e1)
        v = f * dot3(dd, q)
        t = f * dot3(e2, q)
        ok = (ok_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= -EPSILON))
        closer = ok & (t < tb) & leaf[:, None]
        t_best[live] = torch.where(closer, t, tb)
        f_best[live] = torch.where(closer, face[:, None].expand_as(fb), fb)
        nxt = torch.where(hit_ray.any(dim=-1) & ~leaf, nd + 1, skip)
        node[live] = nxt
        count[live] += torch.stack([torch.ones_like(face), leaf.int()], 1)
        live = live[nxt < N]
    out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    out_f = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t[idx] = t_best.reshape(-1)[:m]
    out_f[idx] = f_best.reshape(-1)[:m]
    if steps is not None:
        steps[:T] = count
    return out_t, out_f
