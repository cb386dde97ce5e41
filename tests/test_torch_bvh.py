"""The BVH helpers and the per-ray walk of the port vs the JAX package:
`validate_bvh`, the Morton codes, `slab_test`, `refine_hit` (values and
gradients) and `intersect_bvh`, on `tests/test_bvh.py`'s inputs.

Inputs are numpy, made from a seed, and go through both packages.
Tolerances:
- Morton codes, `slab_test` and `validate_bvh`'s verdicts: exact.
- `intersect_bvh`: faces exact; t to rtol 1e-6 plus 8 ulps of the inputs'
  magnitude where a face is hit, misses exactly (BIG, -1).  XLA contracts
  the multiply-adds of the jitted walk's Moller-Trumbore test into FMAs,
  the port does not (`ROADMAP.md` §C): t = f (e2 . q) then differs by a few
  ulps of its operands.  The port's walk (K4's plain version at width 1)
  tests a leaf's triangle whatever the leaf's box says, where the JAX walk
  tests it only inside the box; a ray that grazes a box face could then
  part the two, and any such ray would be shown in float64 to lie on the
  box face or a barycentric threshold.  On these inputs none does: the
  faces are equal on every ray.
- `refine_hit`: values to rtol 1e-6 (atol 8 ulps, as above), gradients
  w.r.t. vertices, origins and directions within 1e-5 of max |g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene
from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.geom import intersect as jint
from lidar_brdf_tpu.geom import morton as jmorton
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom import bvh as tbvh
from lidar_brdf_tpu_torch.geom import intersect as tint
from lidar_brdf_tpu_torch.geom import morton as tmorton

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

BIG = np.float32(3.4e38)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _ulps8(*arrays) -> float:
    """8 ulps of the largest input magnitude, in f32."""
    return 8 * float(np.spacing(np.float32(max(
        float(np.abs(a).max()) for a in arrays))))


def _random_rays(rng, n, spread=10.0):
    """`tests/test_bvh.py::_random_rays`, as numpy."""
    origin = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    target = rng.uniform(-spread / 4, spread / 4, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origin, d


def _single():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    o = np.array([[0.2, 0.2, -1.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    return jsyn.scene_from_arrays(verts, faces), o, d


def _terrain(rng):
    scene = jsyn.terrain_with_boxes(rng, num_boxes=6)
    n = 128
    xs = np.linspace(-30, 30, n)
    o = np.stack([xs, np.full(n, 50.0), xs * 0.5], -1).astype(np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    return scene, o, d


def _case(kind, rng):
    """(JAX scene, JAX BVH, origins, directions) of one of
    `tests/test_bvh.py`'s inputs."""
    if kind == "single":
        scene, o, d = _single()
    elif kind == "random":
        scene = make_random_scene(rng, num_tris=200)
        o, d = _random_rays(rng, 512)
    else:
        scene, o, d = _terrain(rng)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    return scene, tree, o, d


def _port(scene, tree):
    return (convert.scene_from_numpy(_np(scene)),
            convert.bvh_from_numpy(_np(tree)))


@pytest.mark.parametrize("kind", ["single", "random", "terrain"])
def test_intersect_bvh_matches_jax(kind, rng):
    scene, tree, o, d = _case(kind, rng)
    hj = jint.intersect_bvh(scene, tree, jnp.asarray(o), jnp.asarray(d))
    tscene, ttree = _port(scene, tree)
    ht = tint.intersect_bvh(tscene, ttree, torch.from_numpy(o),
                            torch.from_numpy(d))
    fj, tj = np.asarray(hj.face), np.asarray(hj.t)
    np.testing.assert_array_equal(ht.face.numpy(), fj)
    hit = fj >= 0
    assert hit.sum() >= {"single": 1, "random": 300, "terrain": 128}[kind]
    np.testing.assert_allclose(ht.t.numpy()[hit], tj[hit], rtol=1e-6,
                               atol=_ulps8(o, np.asarray(scene.vertices)))
    assert (ht.t.numpy()[~hit] == BIG).all() and (tj[~hit] == BIG).all()
    assert not ht.t.requires_grad
    if kind == "single":
        assert abs(float(ht.t[0]) - 1.0) < 1e-5


def test_intersect_bvh_takes_the_walk_at_width_1(rng, monkeypatch):
    """`intersect_bvh` is one call of the packet walk at width 1."""
    from lidar_brdf_tpu_torch.kernels import packet as kpk
    scene, tree, o, d = _case("random", rng)
    widths = []
    real = kpk.packet_traverse

    def spy(*a, width, **kw):
        widths.append(width)
        return real(*a, width=width, **kw)

    monkeypatch.setattr("lidar_brdf_tpu_torch.geom.packet.packet_traverse",
                        spy)
    tint.intersect_bvh(*_port(scene, tree), torch.from_numpy(o),
                       torch.from_numpy(d))
    assert widths == [1]


def test_validate_bvh_accepts_and_rejects(rng):
    for scene in (make_random_scene(rng, num_tris=257),
                  jsyn.terrain_with_boxes(rng, num_boxes=6)):
        v, f = np.asarray(scene.vertices), np.asarray(scene.faces)
        tree = tbvh.build_bvh(v, f)
        tbvh.validate_bvh(tree, v, f)
        tbvh.validate_bvh(tree, torch.from_numpy(v), torch.from_numpy(f))
        jtree = jbvh.build_bvh(v, f)
        jbvh.validate_bvh(jtree, v, f)
        # a leaf's skip link turned back to the root: the walk revisits it
        leaf = int(np.nonzero(np.asarray(jtree.node_face) >= 0)[0][0])
        skip = np.asarray(jtree.node_skip).copy()
        skip[leaf] = 0
        with pytest.raises(AssertionError):
            jbvh.validate_bvh(dataclasses.replace(jtree, node_skip=skip),
                              v, f)
        bad = dataclasses.replace(tree, node_skip=torch.from_numpy(skip))
        with pytest.raises(AssertionError):
            tbvh.validate_bvh(bad, v, f)
        # a leaf's box that no longer bounds its face
        lo = tree.node_min.clone()
        lo[leaf] += 1.0
        with pytest.raises(AssertionError):
            tbvh.validate_bvh(dataclasses.replace(tree, node_min=lo), v, f)


def test_morton_torch_is_bit_equal(rng):
    pts = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    pts[:3] = [[-5, -5, -5], [5, 5, 5], [0, 0, 0]]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    want = np.asarray(jmorton.morton3d_jnp(jnp.asarray(pts), jnp.asarray(lo),
                                           jnp.asarray(hi)))
    got = tmorton.morton3d_torch(torch.from_numpy(pts), torch.from_numpy(lo),
                                 torch.from_numpy(hi))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        got.numpy(), tmorton.morton3d_np(pts, lo, hi).astype(np.int64))
    q = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        tmorton.expand_bits_torch(torch.from_numpy(q)).numpy(),
        np.asarray(jmorton.expand_bits_jnp(jnp.asarray(q))).astype(np.int64))


def test_slab_test_is_bit_equal(rng):
    n = 4096
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 3, (n, 3)).astype(np.float32)
    bmin, bmax = c - h, c + h
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    # aimed near the box; a zero direction component keeps the origin's
    # coordinate, inside the box's slab or out of it
    d = (c + rng.normal(size=(n, 3)) * h - o).astype(np.float32)
    flat = rng.random((n, 3)) < 0.2
    d[flat] = 0.0
    inside = flat & (rng.random((n, 3)) < 0.5)
    o[inside] = (c + rng.uniform(-1, 1, (n, 3)) * h)[inside]
    d[:8] = [0.0, -0.0, 0.0]
    d_safe = np.where(np.abs(d) < 1e-12, np.where(d < 0, -1e-12, 1e-12), d)
    inv = (1.0 / d_safe).astype(np.float32)
    t_best = rng.uniform(0, 30, n).astype(np.float32)
    t_best[::3] = BIG
    want = np.asarray(jint.slab_test(*(jnp.asarray(a) for a in
                                       (o, inv, bmin, bmax, t_best))))
    got = tint.slab_test(*(torch.from_numpy(a) for a in
                           (o, inv, bmin, bmax, t_best)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


def test_refine_hit_values_and_grads_match_jax(rng):
    scene, tree, o, d = _case("random", rng)
    face = np.asarray(jint.intersect_bvh(scene, tree, jnp.asarray(o),
                                         jnp.asarray(d)).face)
    assert (face >= 0).sum() > 300 and (face < 0).any()
    v = np.asarray(scene.vertices)
    w = rng.normal(size=(5,)).astype(np.float32)

    def jloss(verts, org, dirn):
        s = dataclasses.replace(scene, vertices=verts)
        t, p, (uu, vv), nrm, ok = jint.refine_hit(s, org, dirn,
                                                  jnp.asarray(face))
        m = ok.astype(jnp.float32)
        return (w[0] * jnp.sum(t * m) + w[1] * jnp.sum(p * m[:, None])
                + w[2] * jnp.sum(uu * m) + w[3] * jnp.sum(vv * m)
                + w[4] * jnp.sum(nrm * m[:, None]))

    jvals = jint.refine_hit(scene, jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(face))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(o), jnp.asarray(d))

    tscene, _ = _port(scene, tree)
    tv = torch.from_numpy(v).requires_grad_()
    to = torch.from_numpy(o).requires_grad_()
    td = torch.from_numpy(d).requires_grad_()
    t, p, (uu, vv), nrm, ok = tint.refine_hit(
        dataclasses.replace(tscene, vertices=tv), to, td,
        torch.from_numpy(face.copy()))
    m = ok.float()
    loss = (w[0] * (t * m).sum() + w[1] * (p * m[:, None]).sum()
            + w[2] * (uu * m).sum() + w[3] * (vv * m).sum()
            + w[4] * (nrm * m[:, None]).sum())
    loss.backward()

    okj = np.asarray(jvals[4])
    np.testing.assert_array_equal(ok.numpy(), okj)
    atol = _ulps8(o, v)
    for got, want in ((t, jvals[0]), (p, jvals[1]), (uu, jvals[2][0]),
                      (vv, jvals[2][1]), (nrm, jvals[3])):
        got, want = got.detach().numpy()[okj], np.asarray(want)[okj]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    for got, want in zip((tv.grad, to.grad, td.grad), jgrads):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
