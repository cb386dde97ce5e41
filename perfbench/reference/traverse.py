"""Plain nearest-hit reference: every ray against the scene's triangles.

No BVH, candidate list, Wald row or ladder of the program: the faces are
sorted by the Morton code of their centroids and grouped into a fixed tree
of boxes (``leaf`` faces a group, ``branch`` boxes a parent) built here
from the vertices.  A block of rays is tested against every top box; each
(ray, box) pair that passes the slab test expands to the box's children,
down to the faces, where a Moller-Trumbore test gives t.  A ray's hit is
the least t in [-1e-8, t_max] over all its faces, the lowest face id on a
tie.  Plain PyTorch on any device, in the dtype of the vertices given.
"""

from __future__ import annotations

import math

import torch

EPSILON = 1e-8
_FAR = 1.0e30            # padding boxes: a point no ray reaches
_NO_HIT = torch.iinfo(torch.int64).max


def _spread10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton(points, lo, hi):
    """30-bit Morton codes of points in the box [lo, hi]."""
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0)
    q = torch.clamp(q, 0, 1023).long()
    return _spread10(q[:, 0]) | (_spread10(q[:, 1]) << 1) \
        | (_spread10(q[:, 2]) << 2)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def moller_trumbore(o, d, v0, e1, e2):
    """(t, hit) of rays against triangles (v0, v0 + e1, v0 + e2)."""
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = torch.where(torch.abs(a) < EPSILON, torch.zeros_like(a),
                    1.0 / torch.where(a == 0, torch.ones_like(a), a))
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    ok = ((torch.abs(a) >= EPSILON) & (u >= 0) & (u <= 1) & (v >= 0)
          & (u + v <= 1) & (t >= -EPSILON))
    return t, ok


def _slab(o, inv, lo, hi, t_max):
    """(hit, entry t) of rays against boxes."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tf >= torch.clamp(tn, min=0)) & (tn <= t_max), tn


def _key(t, low):
    """int64 keys ordered by t >= 0, then by ``low`` (< 2**32)."""
    t = torch.clamp(t.float(), min=0.0)
    return (t.view(torch.int32).long() << 32) | low


class ClusterTree:
    """The faces of one scene, grouped for `nearest_hits`."""

    def __init__(self, vertices, faces, leaf: int = 8, branch: int = 8,
                 top: int = 1024):
        tri = vertices[faces.long()]                      # (F, 3, 3)
        F = tri.shape[0]
        cent = tri.float().mean(1)
        order = torch.argsort(morton(cent, cent.amin(0), cent.amax(0)))
        Fp = -(-F // leaf) * leaf
        dev, dt = vertices.device, vertices.dtype
        pad = torch.zeros((Fp, 3, 3), dtype=dt, device=dev)
        pad[:F] = tri[order]
        self.face_id = torch.full((Fp,), -1, dtype=torch.int64, device=dev)
        self.face_id[:F] = order
        self.v0 = pad[:, 0]
        self.e1 = pad[:, 1] - pad[:, 0]
        self.e2 = pad[:, 2] - pad[:, 0]
        lo, hi = pad.amin(1), pad.amax(1)
        far = torch.full_like(lo[F:], _FAR)
        lo[F:], hi[F:] = far, far
        self.leaf, self.branch = leaf, branch
        self.levels = []                                   # fine to coarse
        lo = lo.view(-1, leaf, 3).amin(1)
        hi = hi.view(-1, leaf, 3).amax(1)
        self.levels.append((lo, hi))
        while lo.shape[0] > top:
            n = -(-lo.shape[0] // branch) * branch
            extra = torch.full((n - lo.shape[0], 3), _FAR, dtype=dt,
                               device=dev)
            lo, hi = torch.cat([lo, extra]), torch.cat([hi, extra])
            self.levels[-1] = (lo, hi)          # children of every parent
            lo = lo.view(-1, branch, 3).amin(1)
            hi = hi.view(-1, branch, 3).amax(1)
            self.levels.append((lo, hi))

    def nearest_hits(self, origin, direction, t_max: float,
                     ray_block: int = 1 << 18, pair_block: int = 1 << 24):
        """(t float32, face int64, -1 on a miss) of each ray; ``origin``,
        ``direction`` (N, 3) in the tree's dtype.  Per block of rays, the
        faces of each ray's nearest leaf box (by entry t) first; then only
        the boxes that the ray enters before that hit."""
        N = origin.shape[0]
        dev = origin.device
        keys = torch.full((N,), _NO_HIT, dtype=torch.int64, device=dev)
        d_safe = torch.where(torch.abs(direction) < 1e-12,
                             torch.where(direction < 0, -1e-12, 1e-12)
                             .to(direction.dtype), direction)
        inv_all = 1.0 / d_safe
        for r0 in range(0, N, ray_block):
            o = origin[r0:r0 + ray_block]
            d = direction[r0:r0 + ray_block]
            inv = inv_all[r0:r0 + ray_block]
            n = o.shape[0]
            lo, hi = self.levels[-1]
            hit, tn = _slab(o[:, None], inv[:, None], lo[None], hi[None],
                            t_max)
            ray, node = hit.nonzero(as_tuple=True)
            tn = tn[ray, node]
            for lo, hi in reversed(self.levels[:-1]):
                ray, node = self._expand(ray, node, self.branch)
                keep, tns = [], []
                for p0 in range(0, ray.shape[0], pair_block):
                    r, m = ray[p0:p0 + pair_block], node[p0:p0 + pair_block]
                    k, t = _slab(o[r], inv[r], lo[m], hi[m], t_max)
                    keep.append(k)
                    tns.append(t)
                if not keep:
                    break
                keep = torch.cat(keep)
                ray, node, tn = ray[keep], node[keep], torch.cat(tns)[keep]
            best = torch.full((n,), _NO_HIT, dtype=torch.int64, device=dev)
            best.scatter_reduce_(0, ray, _key(tn, node), "amin")
            first = best[ray] == _key(tn, node)
            self._faces(o, d, ray[first], node[first], t_max, keys, r0,
                        pair_block)
            bound = (keys[r0:r0 + n] >> 32).to(torch.int32).view(torch.float32)
            bound = torch.where(keys[r0:r0 + n] == _NO_HIT,
                                torch.full_like(bound, t_max), bound)
            rest = ~first & (tn.float() <= bound[ray])
            self._faces(o, d, ray[rest], node[rest], t_max, keys, r0,
                        pair_block)
        miss = keys == _NO_HIT
        face = torch.where(miss, -1, keys & 0xFFFFFFFF)
        t = (keys >> 32).to(torch.int32).view(torch.float32)
        return torch.where(miss, torch.full_like(t, 3.4e38), t), face

    def _faces(self, o, d, ray, node, t_max, keys, r0, pair_block):
        """Test the faces of (ray, leaf box) pairs; fold the hits into
        ``keys``."""
        step = max(pair_block // self.leaf, 1)
        for p0 in range(0, ray.shape[0], step):
            r, f = self._expand(ray[p0:p0 + step], node[p0:p0 + step],
                                self.leaf)
            t, ok = moller_trumbore(o[r], d[r], self.v0[f], self.e1[f],
                                    self.e2[f])
            ok = ok & (torch.clamp(t.float(), min=0.0) <= t_max)
            keys.scatter_reduce_(0, r[ok] + r0,
                                 _key(t[ok], self.face_id[f][ok]), "amin")

    @staticmethod
    def _expand(ray, node, k):
        kk = torch.arange(k, device=node.device)
        return (ray.repeat_interleave(k),
                (node[:, None] * k + kk[None, :]).reshape(-1))


def tree_for(vertices, faces) -> ClusterTree:
    """A tree sized to the scene: leaves of 8 faces, 8 boxes a parent."""
    return ClusterTree(vertices, faces, leaf=8, branch=8,
                       top=max(64, int(math.sqrt(faces.shape[0]))))
