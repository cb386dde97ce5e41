"""The culled path's JAX interface in the port vs the JAX package:
`build_tile_candidates`, `intersect_culled` and `CulledTraverser` (dense
candidate arrays and buckets).

Inputs are numpy, made from a seed, and go through both packages; both
culls run on numpy (the JAX package with ``LIDAR_BRDF_TPU_NO_NATIVE=1``,
the port with ``use_native=False``): the native culler orders a tile's
equidistant candidates its own way (`ROADMAP.md` §C).  Tolerances:
- candidate arrays: bit-equal.
- hits at ``chunk=8``: faces and t bit-equal.  There K1's tie rule (the
  least face id among equal t within a block of 8, the earlier block across
  blocks; the port's plain version here) and the JAX package's (the least
  face id within a chunk) are the same rule.
- hits at ``chunk=128``: t bit-equal; faces equal except on exact-t ties
  across blocks of one chunk, where K1 keeps the earlier block's face and
  the JAX package the least id.  Each such ray is checked: both faces are
  candidates of its tile, the port's in an earlier block, the JAX
  package's of lower id, and in float64 the ray meets both triangles at
  the same t (to rtol 1e-5) within 1e-5 of their barycentric bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.geom import beamcull as jbc
from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom import beamcull as tbc

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

TILE = 128


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _fan(n_side):
    """A fan of rays from above a grid vertex of the terrain (rays along
    its shared edges tie)."""
    o0 = np.array([0.0, 9.0, 0.0], np.float32)
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(-1.2, -0.2, n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


@pytest.fixture(scope="module")
def case():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=6)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    o, d = _fan(32)
    return (scene, tree, convert.scene_from_numpy(_np(scene)),
            convert.bvh_from_numpy(_np(tree)), o, d)


@pytest.mark.parametrize("tile_rays,pad_to", [(16, 8), (TILE, 128)])
def test_build_tile_candidates_bit_equal(case, monkeypatch, tile_rays,
                                         pad_to):
    scene, tree, _, ttree, o, d = case
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    want = jbc.build_tile_candidates(tree, o, d, tile_rays=tile_rays,
                                     pad_to=pad_to)
    got = tbc.build_tile_candidates(ttree, o, d, tile_rays=tile_rays,
                                    pad_to=pad_to, use_native=False)
    assert got.dtype == np.int32 and got.shape[1] % pad_to == 0
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 0
    with pytest.raises(ValueError):
        tbc.build_tile_candidates(ttree, o[:-1], d[:-1], tile_rays=tile_rays)


def _moller_trumbore64(o, d, tri):
    """(t, u, v) of one ray against one triangle in float64."""
    v0, v1, v2 = tri.astype(np.float64)
    e1, e2 = v1 - v0, v2 - v0
    o, d = o.astype(np.float64), d.astype(np.float64)
    h = np.cross(d, e2)
    f = 1.0 / np.dot(e1, h)
    s = o - v0
    q = np.cross(s, e1)
    return f * np.dot(e2, q), f * np.dot(s, h), f * np.dot(d, q)


def _check_ties(scene, cand, o, d, hj, ht):
    """Faces of ``hj`` (JAX) and ``ht`` (port) equal but on exact-t ties of
    the kind the module's note describes, ray i of ``o``/``d`` in tile
    i // TILE of the lists ``cand``; returns the number of ties."""
    fj, ft = np.asarray(hj.face).reshape(-1), ht.face.numpy().reshape(-1)
    tj, tt = np.asarray(hj.t).reshape(-1), ht.t.numpy().reshape(-1)
    np.testing.assert_array_equal(tt, tj)
    v = np.asarray(scene.vertices)
    f = np.asarray(scene.faces)
    for ray in np.nonzero(fj != ft)[0]:
        row = list(cand[ray // TILE])
        assert fj[ray] >= 0 and ft[ray] >= 0, ray
        assert row.index(ft[ray]) // 8 < row.index(fj[ray]) // 8, ray
        assert fj[ray] < ft[ray], ray
        for face in (fj[ray], ft[ray]):
            t, u, w = _moller_trumbore64(o[ray], d[ray], v[f[face]])
            np.testing.assert_allclose(t, tj[ray], rtol=1e-5)
            assert min(u, w, 1.0 - u - w) > -1e-5, (ray, face)
    return int((fj != ft).sum())


@pytest.mark.parametrize("chunk", [8, 128])
def test_intersect_culled_matches_jax(case, monkeypatch, chunk):
    scene, tree, tscene, _, o, d = case
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    cand = jbc.build_tile_candidates(tree, o, d, tile_rays=TILE,
                                     pad_to=chunk)
    T = cand.shape[0]
    wald = jbc.wald_rows_np(np.asarray(scene.vertices),
                            np.asarray(scene.faces))
    ot, dt = o.reshape(T, TILE, 3), d.reshape(T, TILE, 3)
    hj = jbc.intersect_culled(jnp.asarray(wald), jnp.asarray(cand),
                              jnp.asarray(ot), jnp.asarray(dt), chunk=chunk)
    ht = tbc.intersect_culled(torch.from_numpy(wald), torch.from_numpy(cand),
                              torch.from_numpy(ot), torch.from_numpy(dt),
                              chunk=chunk)
    assert ht.face.shape == (T, TILE)
    assert (ht.face.numpy() >= 0).sum() > 900
    ties = _check_ties(scene, cand, o, d, hj, ht)
    assert ties == 0 if chunk == 8 else ties > 0
    # a tile of fewer rays than K1's 128 lanes is padded, not refused
    hs = tbc.intersect_culled(torch.from_numpy(wald),
                              torch.from_numpy(cand),
                              torch.from_numpy(ot[:, :100].copy()),
                              torch.from_numpy(dt[:, :100].copy()),
                              chunk=chunk)
    np.testing.assert_array_equal(hs.face.numpy(), ht.face.numpy()[:, :100])
    with pytest.raises(ValueError):
        tbc.intersect_culled(torch.from_numpy(wald), torch.from_numpy(cand),
                             torch.from_numpy(ot), torch.from_numpy(dt),
                             chunk=12)


@pytest.mark.parametrize("chunk", [8, 128])
def test_culled_traverser_matches_jax(case, monkeypatch, chunk):
    scene, tree, tscene, ttree, o, d = case
    monkeypatch.setenv("LIDAR_BRDF_TPU_NO_NATIVE", "1")
    n = o.shape[0] - 37                    # the traverser pads the tail
    o, d = o[:n], d[:n]
    jtr = jbc.CulledTraverser(scene, tile_rays=TILE, chunk=chunk)
    ttr = tbc.CulledTraverser(tscene, tile_rays=TILE, chunk=chunk,
                              device="cpu")
    np.testing.assert_array_equal(ttr.wald.numpy(), np.asarray(jtr.wald))
    assert ttr.beams_ok(o, d) == jtr.beams_ok(o, d)
    cand = jtr.build_candidates(tree, o, d)
    np.testing.assert_array_equal(
        cand, tbc.build_tile_candidates(
            ttree, *ttr._tiles._pad_np(o, d), tile_rays=TILE, pad_to=chunk,
            use_native=False))
    buckets = jtr.prepare(tree, o, d)
    for data, lists in ((cand, cand), (buckets, _dense(buckets, len(cand)))):
        hj = jtr(jnp.asarray(o), jnp.asarray(d), data)
        ht = ttr(torch.from_numpy(o), torch.from_numpy(d), data)
        assert ht.face.shape == (n,)
        ties = _check_ties(scene, lists, o, d, hj, ht)
        assert ties == 0 if chunk == 8 else ties > 0
    with pytest.raises(ValueError):
        ttr(torch.from_numpy(o), torch.from_numpy(d), cand[:-1])
    with pytest.raises(ValueError):
        tbc.CulledTraverser(tscene, chunk=12, device="cpu")


def _dense(buckets, T):
    """Each tile's candidate list from (tidx, cand) buckets (dummy rows
    dropped), as rows of a dense array."""
    rows = {}
    for tidx, cand in buckets:
        for t, row in zip(tidx, cand):
            if t < T:
                rows[int(t)] = row
    width = max(len(r) for r in rows.values())
    out = np.full((T, width), -1, np.int32)
    for t, row in rows.items():
        out[t, :len(row)] = row
    return out


def test_culled_traverser_is_bit_equal_to_the_tile_traverser(case):
    """The bucketed call is `TileTraverser`'s K1 call with no early exit and
    t_max BIG: the same hits as `tile_traverse_plain` on its buckets."""
    from lidar_brdf_tpu_torch.geom.intersect import BIG
    from lidar_brdf_tpu_torch.kernels import traverse as ktr
    _, _, tscene, ttree, o, d = case
    ttr = tbc.CulledTraverser(tscene, tile_rays=TILE, chunk=8, device="cpu")
    buckets = ttr.prepare(ttree, o, d)
    dev = tuple((t, c, torch.zeros((c.shape[0], c.shape[1] // 8)))
                for t, c in buckets)
    want_t, want_f = ktr.tile_traverse_plain(
        ttr.wald, torch.from_numpy(o), torch.from_numpy(d), dev, BIG, TILE)
    got = ttr(torch.from_numpy(o), torch.from_numpy(d), buckets)
    assert torch.equal(got.face, want_f) and torch.equal(got.t, want_t)
