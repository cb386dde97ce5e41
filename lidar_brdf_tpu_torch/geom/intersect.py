"""Ray-triangle intersection (counterpart of `lidar_brdf_tpu/geom/intersect.py`).

Semantics of the reference hot kernel `findBVHCollision-comp.glsl` (slab
ray-AABB test :21-31, Moller-Trumbore :34-91, nearest forward hit).  The
traversal picks a face (discrete, no gradient); the hit is then
re-evaluated from the chosen face with plain differentiable arithmetic
(`refine_hit`, `refine_hit_verts`).  The per-ray BVH walk `intersect_bvh`
is the packet walk of `geom/packet.py` at one ray a packet (the CUDA
kernel K4 on the card).
"""

from __future__ import annotations

import torch

from ..core.types import BVH, Hit, TriangleScene
from ..utils.safemath import cross3, dot3, maximum, rsqrt

EPSILON = 1e-8
BIG = 3.4e38          # exactly representable as f32 after rounding


def moller_trumbore(origin, direction, v0, v1, v2):
    """Vectorized Moller-Trumbore; returns (t, u, v, hit_mask).

    A parallel ray (|det| < EPSILON) misses; u in [0,1], v >= 0, u+v <= 1;
    forward hits t >= -EPSILON.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross3(direction, e2)
    a = dot3(e1, h)
    safe_a = torch.where(a == 0, torch.ones_like(a), a)
    f = torch.where(torch.abs(a) < EPSILON, torch.zeros_like(a), 1.0 / safe_a)
    s = origin - v0
    u = f * dot3(s, h)
    q = cross3(s, e1)
    v = f * dot3(direction, q)
    t = f * dot3(e2, q)
    ok = ((torch.abs(a) >= EPSILON)
          & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0)
          & (t >= -EPSILON))
    return t, u, v, ok


def slab_test(origin, inv_dir, box_min, box_max, t_best):
    """Slab ray-AABB test (`findBVHCollision-comp.glsl:21-31`), tightened
    with forward-range and current-best pruning (pruning only removes work,
    never hits).  Operands broadcast over their leading axes; the last axis
    is xyz."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_far >= torch.clamp(t_near, min=0.0)) & (t_near < t_best)


def _gather_tri(scene: TriangleScene, face_idx):
    """The three vertex positions of faces (invalid ids read face 0)."""
    idx = scene.faces[torch.clamp(face_idx, min=0).long()].long()
    return tuple(scene.vertices[idx[..., k]] for k in range(3))


def intersect_brute(scene: TriangleScene, origin, direction,
                    ray_block: int = 4096) -> Hit:
    """O(rays x faces) oracle for tests; nearest forward hit per ray (the
    first face on a tie, as `jnp.argmin`)."""
    idx = scene.faces.long()
    v0, v1, v2 = (scene.vertices[idx[:, k]][None] for k in range(3))
    shape = origin.shape[:-1]
    flat_o = origin.reshape(-1, 3)
    flat_d = direction.reshape(-1, 3)
    ts, fs = [], []
    for lo in range(0, flat_o.shape[0], ray_block):
        o = flat_o[lo:lo + ray_block, None, :]
        d = flat_d[lo:lo + ray_block, None, :]
        t, _, _, ok = moller_trumbore(o, d, v0, v1, v2)
        dist = torch.where(ok, t, torch.full_like(t, BIG))
        best = torch.argmin(dist, dim=1)
        tb = dist.gather(1, best[:, None])[:, 0]
        has = tb < BIG
        ts.append(torch.where(has, tb, torch.full_like(tb, BIG)))
        fs.append(torch.where(has, best.to(torch.int32),
                              torch.full_like(best, -1, dtype=torch.int32)))
    return Hit(t=torch.cat(ts).reshape(shape), face=torch.cat(fs).reshape(shape))


def intersect_bvh(scene: TriangleScene, bvh: BVH, origin, direction) -> Hit:
    """Nearest hit of each ray by a stackless walk of the threaded BVH, one
    walk per ray: `geom/packet.py::pack_scene` and
    `intersect_packed_scene` at width 1, so on CUDA tensors one launch of
    K4 per call and on CPU tensors its plain version.

    The JAX function tests a leaf's triangle only when the ray hits the
    leaf's box; the packet walk tests it whatever the box says.  In exact
    arithmetic the two agree; in f32 they can part where a ray grazes a box
    face.  ``t`` carries no gradient (re-evaluate with `refine_hit`)."""
    from .packet import intersect_packed_scene, pack_scene   # imports BIG
    return intersect_packed_scene(pack_scene(scene, bvh), origin, direction,
                                  width=1)


def face_normal_from_verts(v0, v1, v2):
    """Unit facet normal normalize(cross(v1 - v0, v2 - v0)), safe at zero."""
    n = cross3(v1 - v0, v2 - v0)
    n2 = dot3(n, n)[..., None]
    return n * rsqrt(maximum(n2, 1e-24))


def refine_hit(scene: TriangleScene, origin, direction, face_idx):
    """Differentiable re-evaluation of the hit for a fixed face choice.

    Returns (t, point, (u, v), face normal, valid).  Gradients flow to
    ``scene.vertices``, ``origin`` and ``direction``, the facet normal
    included (recomputed from the gathered vertices); the face index is
    data."""
    v0, v1, v2 = _gather_tri(scene, face_idx)
    normal = face_normal_from_verts(v0, v1, v2)
    t, point, uv, valid = refine_hit_verts(origin, direction, v0, v1, v2,
                                           face_idx)
    return t, point, uv, normal, valid


def refine_hit_verts(origin, direction, v0, v1, v2, face_idx):
    """Differentiable re-evaluation of a hit for a fixed face choice.

    Returns (t, point, (u, v), valid); invalid slots get t = BIG.
    """
    t, u, v, ok = moller_trumbore(origin, direction, v0, v1, v2)
    valid = (face_idx >= 0) & ok
    t = torch.where(valid, t, torch.full_like(t, BIG))
    point = origin + direction * t[..., None]
    return t, point, (u, v), valid
