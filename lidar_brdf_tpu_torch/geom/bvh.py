"""LBVH construction (host-side, vectorized numpy).

The reference builds its BVH on the GPU: Morton codes + 30-pass radix sort
(`Group3D.cpp:521-635`) followed by an agglomerative PLOC merge loop
(`Group3D.cpp:41-181`).  That design exists because OpenGL compute has cheap
atomics and the app rebuilds per interactive scene load.

The port builds once per scene on the host with a Karras-style radix tree
over Morton-sorted faces (vectorized numpy, O(F log F)), then *thread* the
tree: nodes are emitted in DFS pre-order with a ``skip`` link, so device
traversal needs no stack at all (single int32 of state per ray instead of the
reference's 200-entry stack, `findBVHCollision-comp.glsl:113`).
Host numpy, copied from `lidar_brdf_tpu/geom/bvh.py`; the result is a
`BVH` of CPU tensors.

Key layout: 53-bit sort keys (30-bit Morton | 23-bit index) keep keys unique
and exactly representable in float64, bounding tree depth by the key width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import BVH, as_numpy
from .morton import morton3d_np

_KEY_BITS = 53
_INDEX_BITS = 23
MAX_FACES = (1 << _INDEX_BITS) - 1  # ~8.38M faces


def face_aabbs(vertices: np.ndarray, faces: np.ndarray):
    """Per-face AABBs (reference `computeFaceAABB-comp.glsl:19-39`)."""
    tri = vertices[faces]                       # (F, 3, 3)
    return tri.min(axis=1), tri.max(axis=1)


def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Exact bit length for values < 2^53 (float64 exponent trick)."""
    _, e = np.frexp(x.astype(np.float64))
    return e.astype(np.int64)


def _bvh(node_min, node_max, node_face, node_skip) -> BVH:
    return BVH(node_min=torch.from_numpy(np.asarray(node_min, np.float32)),
               node_max=torch.from_numpy(np.asarray(node_max, np.float32)),
               node_face=torch.from_numpy(np.asarray(node_face, np.int32)),
               node_skip=torch.from_numpy(np.asarray(node_skip, np.int32)))


def build_bvh(vertices: np.ndarray, faces: np.ndarray,
              use_native: bool = True) -> BVH:
    """Build a threaded LBVH over the triangle soup.

    Returns nodes in DFS pre-order: internal node's left child is at
    ``node + 1``; ``node_skip`` jumps over the subtree.  Leaves carry the
    original face index in ``node_face`` (internal nodes carry -1).

    Uses the native C++ builder (native/lidar_native.cpp) when available;
    the vectorized numpy path below is the portable reference.  Set
    ``use_native=False`` to force numpy.
    """
    if use_native and len(faces) > 1:
        from ..io.native import build_bvh_native
        tree = build_bvh_native(np.asarray(vertices, np.float32),
                                np.asarray(faces, np.int64).astype(np.int32))
        if tree is not None:
            return tree
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64)
    n = faces.shape[0]
    if n > MAX_FACES:
        raise ValueError(f"scene has {n} faces; max supported is {MAX_FACES}")
    fmin, fmax = face_aabbs(vertices, faces)
    if n == 1:
        return _bvh(fmin, fmax, np.zeros(1, np.int32), np.ones(1, np.int32))

    centroid = (fmin + fmax) * 0.5
    scene_min, scene_max = fmin.min(axis=0), fmax.max(axis=0)
    morton = morton3d_np(centroid, scene_min, scene_max).astype(np.uint64)

    order = np.argsort(morton, kind="stable").astype(np.int64)
    keys = ((morton[order] << _INDEX_BITS)
            | np.arange(n, dtype=np.uint64)).astype(np.uint64)

    left, right = _karras_radix_tree(keys)

    # --- node arrays: internal nodes 0..n-2, leaves n-1..2n-2 -------------
    num_internal = n - 1
    num_nodes = 2 * n - 1
    # child encoding from _karras_radix_tree: value < n-1 => internal node id;
    # else leaf id (value - (n-1)) in sorted order.
    node_left = left
    node_right = right

    leaf_face = order.astype(np.int32)          # sorted position -> face id

    # --- bottom-up AABB union + subtree sizes (<= key-width iterations) ---
    node_min = np.empty((num_nodes, 3), np.float32)
    node_max = np.empty((num_nodes, 3), np.float32)
    size = np.empty(num_nodes, np.int64)
    node_min[num_internal:] = fmin[leaf_face]
    node_max[num_internal:] = fmax[leaf_face]
    size[num_internal:] = 1
    done = np.zeros(num_nodes, bool)
    done[num_internal:] = True
    internal_ids = np.arange(num_internal)
    while not done[:num_internal].all():
        ready = (~done[:num_internal]) & done[node_left] & done[node_right]
        ids = internal_ids[ready]
        l, r = node_left[ids], node_right[ids]
        node_min[ids] = np.minimum(node_min[l], node_min[r])
        node_max[ids] = np.maximum(node_max[l], node_max[r])
        size[ids] = 1 + size[l] + size[r]
        done[ids] = True

    # --- DFS pre-order numbering + skip links (top-down propagation) ------
    pre = np.full(num_nodes, -1, np.int64)
    skip = np.full(num_nodes, -1, np.int64)
    pre[0] = 0
    skip[0] = num_nodes
    frontier = np.array([0], np.int64)
    while frontier.size:
        internal = frontier[frontier < num_internal]
        if internal.size == 0:
            break
        l, r = node_left[internal], node_right[internal]
        pre[l] = pre[internal] + 1
        pre[r] = pre[internal] + 1 + size[l]
        skip[l] = pre[r]
        skip[r] = skip[internal]
        frontier = np.concatenate([l, r])

    # --- scatter into pre-order layout ------------------------------------
    out_min = np.empty_like(node_min)
    out_max = np.empty_like(node_max)
    out_face = np.full(num_nodes, -1, np.int32)
    out_skip = np.empty(num_nodes, np.int32)
    out_min[pre] = node_min
    out_max[pre] = node_max
    out_skip[pre] = skip.astype(np.int32)
    out_face[pre[num_internal:]] = leaf_face
    return _bvh(out_min, out_max, out_face, out_skip)


def _karras_radix_tree(keys: np.ndarray):
    """Vectorized Karras 2012 internal-node construction.

    Children encoding: id < n-1 -> internal node id; id >= n-1 -> leaf
    (n-1 + sorted position).
    """
    n = keys.shape[0]
    num_internal = n - 1
    i = np.arange(num_internal, dtype=np.int64)

    def delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Common-prefix length between sorted key positions a, b (vector)."""
        out = np.full(a.shape, -1, np.int64)
        ok = (b >= 0) & (b < n)
        xa, xb = a[ok], b[ok]
        x = keys[xa] ^ keys[xb]
        out[ok] = _KEY_BITS - _bit_length_u64(x)
        return out

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d[d == 0] = 1
    delta_min = delta(i, i - d)

    # upper bound on range length by doubling
    lmax = np.full(num_internal, 2, np.int64)
    while True:
        probe = delta(i, i + lmax * d) > delta_min
        if not probe.any():
            break
        lmax[probe] *= 2
        if (lmax > 2 * n).all():
            break

    # binary search exact range length l
    l = np.zeros(num_internal, np.int64)
    t = lmax // 2
    while t.max() >= 1:
        cand = l + t
        ok = delta(i, i + cand * d) > delta_min
        l[ok] = cand[ok]
        t = t // 2
    j = i + l * d

    # binary search split position
    delta_node = delta(i, j)
    s = np.zeros(num_internal, np.int64)
    t = np.int64(1)
    # ceil(l / 2^k) loop
    div = np.ones(num_internal, np.int64)
    while True:
        div *= 2
        t_arr = -(-l // div)           # ceil division
        active = t_arr >= 1
        if not active.any():
            break
        cand = s + t_arr
        ok = active & (delta(i, i + cand * d) > delta_node)
        s[ok] = cand[ok]
        if (t_arr <= 1).all():
            break
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = np.where(lo == gamma, num_internal + gamma, gamma)
    right = np.where(hi == gamma + 1, num_internal + gamma + 1, gamma + 1)
    return left.astype(np.int64), right.astype(np.int64)


def validate_bvh(bvh: BVH, vertices, faces) -> None:
    """Structural invariants (test helper; a copy of the JAX package's
    `validate_bvh`): every face appears exactly once in a leaf, every
    node's AABB contains its subtree, skip links are a valid DFS
    threading.  Raises AssertionError where one fails."""
    vertices, faces = as_numpy(vertices), as_numpy(faces)
    node_face = as_numpy(bvh.node_face)
    node_skip = as_numpy(bvh.node_skip)
    node_min = as_numpy(bvh.node_min)
    node_max = as_numpy(bvh.node_max)
    n_nodes = node_face.shape[0]
    leaves = node_face[node_face >= 0]
    assert len(leaves) == faces.shape[0]
    assert len(np.unique(leaves)) == faces.shape[0]
    fmin, fmax = face_aabbs(vertices, faces)
    # leaf AABBs match faces
    leaf_ids = np.nonzero(node_face >= 0)[0]
    assert np.allclose(node_min[leaf_ids], fmin[node_face[leaf_ids]])
    assert np.allclose(node_max[leaf_ids], fmax[node_face[leaf_ids]])
    # DFS threading: walking node+1/skip visits each node exactly once
    visited = np.zeros(n_nodes, bool)
    node = 0
    count = 0
    while node < n_nodes:
        assert not visited[node]
        visited[node] = True
        count += 1
        if node_face[node] >= 0:
            node = node_skip[node]
        else:
            # child AABBs inside parent
            assert (node_min[node] <= node_min[node + 1] + 1e-6).all()
            node = node + 1
    assert count == n_nodes
