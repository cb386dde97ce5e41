"""Packet walk of the threaded BVH: the hand-written CUDA kernel K4 and its
plain PyTorch version.

Counterpart of the loop of `lidar_brdf_tpu/geom/packet.py::
intersect_packed_scene`, which the JAX package leaves to XLA as a
`lax.while_loop` on the device (it is not a Pallas kernel).  Rays are cut
into tiles of consecutive rays; each tile walks the tree once, descending
into a node when any of its rays hits the node's box closer than that
ray's best hit, and testing every leaf it reaches on all of its rays.

`packet_traverse` takes padded rays (a multiple of the tile) and the
packed scene's arrays (`geom/packet.py::pack_scene`).  On a CUDA tensor it
launches `csrc/packet_traverse.cu` once over all tiles (built with nvcc at
first use into `build/kernels/`, loaded with ctypes); on a CPU tensor it
runs `packet_traverse_plain`.  It never falls back from one to the other.
Eager PyTorch has no device loop: the plain version's loop tests on the
host, every step, which tiles are still walking.
"""

from __future__ import annotations

import ctypes

import torch

from ..geom.intersect import BIG, EPSILON
from ..utils.safemath import cross3, dot3
from .cuda_build import CudaLibrary, check_tensor, raw_stream

TILE = 128           # rays of a tile: K4 runs one 128-thread block a tile
TINY_DIR = 1e-12     # |d| below this is replaced by +-TINY_DIR for 1 / d


def _declare(lib):
    vp = ctypes.c_void_p
    lib.lbt_packet_traverse.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp,
                                        ctypes.c_int64, vp, vp, vp, vp]
    lib.lbt_packet_traverse.restype = ctypes.c_int


KERNEL = CudaLibrary("packet_traverse.cu", _declare, "lbt_packet_traverse")


def _validate(node_box, node_skip, node_face, tri_rows, origin, direction,
              steps):
    dev = origin.get_device()
    check_tensor("node_box", node_box, torch.float32, 2, dev)
    check_tensor("node_skip", node_skip, torch.int32, 1, dev)
    check_tensor("node_face", node_face, torch.int32, 1, dev)
    check_tensor("tri_rows", tri_rows, torch.float32, 2, dev)
    check_tensor("origin", origin, torch.float32, 2, dev)
    check_tensor("direction", direction, torch.float32, 2, dev)
    n = node_box.shape[0]
    if node_box.shape[1] != 6 or tri_rows.shape[1] != 9 \
            or node_skip.shape[0] != n or node_face.shape[0] != n:
        raise ValueError("node_box must be (N, 6), node_skip and node_face "
                         "(N,), tri_rows (F, 9)")
    if origin.shape[1] != 3 or direction.shape != origin.shape \
            or origin.shape[0] % TILE:
        raise ValueError(f"origin/direction must be (T * {TILE}, 3)")
    if steps is not None:
        check_tensor("steps", steps, torch.int32, 2, dev)
        if tuple(steps.shape) != (origin.shape[0] // TILE, 2):
            raise ValueError("steps must be (tiles, 2)")


def packet_traverse(node_box, node_skip, node_face, tri_rows, origin,
                    direction, steps=None):
    """Nearest (t, face) per ray by the packet walk.

    ``node_box`` (N, 6) f32 [min, max], ``node_skip`` and ``node_face``
    (N,) i32 (leaf face, -1 internal), ``tri_rows`` (F, 9) f32 [v0, e1,
    e2]; ``origin``/``direction`` (T * 128, 3) f32, tiles of 128
    consecutive rays.  Returns (t (T * 128,) f32, face (T * 128,) i32);
    misses are (BIG, -1).  ``steps``, when given, a (T, 2) i32 tensor that
    receives each tile's walk length: node steps, of which leaf steps.
    CUDA tensors launch K4 once; CPU tensors take
    `packet_traverse_plain`.
    """
    _validate(node_box, node_skip, node_face, tri_rows, origin, direction,
              steps)
    if not origin.is_cuda:
        if origin.device.type == "cpu":
            return packet_traverse_plain(node_box, node_skip, node_face,
                                         tri_rows, origin, direction, steps)
        raise ValueError(f"unsupported device {origin.device}")
    if node_box.shape[0] >= 2 ** 31:
        raise ValueError("over 2^31 nodes")
    n = origin.shape[0]
    out_t = torch.empty((n,), dtype=torch.float32, device=origin.device)
    out_f = torch.empty((n,), dtype=torch.int32, device=origin.device)
    if n:
        rc = KERNEL.launcher()(
            node_box.data_ptr(), node_skip.data_ptr(), node_face.data_ptr(),
            tri_rows.data_ptr(), node_box.shape[0], origin.data_ptr(),
            direction.data_ptr(), n // TILE, out_t.data_ptr(),
            out_f.data_ptr(), 0 if steps is None else steps.data_ptr(),
            raw_stream(origin.get_device()))
        KERNEL.check(rc, "packet_traverse")
        KERNEL.launches += 1
    return out_t, out_f


def packet_traverse_plain(node_box, node_skip, node_face, tri_rows, origin,
                          direction, steps=None):
    """Plain PyTorch version of K4: same signature and results.

    One loop step advances every tile that is still walking by one node,
    all of them at once; a tile leaves the loop when its walk passes the
    last node.  Each step computes both the slab test and the triangle
    test, as the JAX loop body does, and keeps the one the node needs.
    """
    dev = origin.device
    n = origin.shape[0]
    T = n // TILE
    N = node_box.shape[0]
    o = origin.reshape(T, TILE, 3)
    d = direction.reshape(T, TILE, 3)
    tiny = torch.full_like(d, TINY_DIR)
    d_safe = torch.where(torch.abs(d) < TINY_DIR,
                         torch.where(d < 0, -tiny, tiny), d)
    inv_d = 1.0 / d_safe
    node = torch.zeros(T, dtype=torch.int64, device=dev)
    t_best = torch.full((T, TILE), BIG, dtype=torch.float32, device=dev)
    f_best = torch.full((T, TILE), -1, dtype=torch.int32, device=dev)
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
        # slab test
        t0 = (box[..., 0:3] - oo) * ii
        t1 = (box[..., 3:6] - oo) * ii
        t_near = torch.minimum(t0, t1).amax(dim=-1)         # (A, tile)
        t_far = torch.maximum(t0, t1).amin(dim=-1)
        hit_ray = (t_far >= torch.clamp(t_near, min=0.0)) & (t_near < tb)
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
    if steps is not None:
        steps.copy_(count)
    return t_best.reshape(n), f_best.reshape(n)
