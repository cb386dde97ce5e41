"""The packet walk: the port's `geom/packet.py` and the plain PyTorch version
of the CUDA kernel K4 (`kernels/packet.py`) vs the JAX package's
`geom/packet.py::intersect_packed_scene` and the port's brute-force oracle.

Inputs are numpy, made from a seed, and go through both packages.  The
packed arrays must be bit-equal.  Hits: t to rtol 1e-6 where both sides hit
the same face; faces exact except where the deciding comparison sits
within 1e-5 of its threshold, checked in float64.  XLA contracts the
cross products' multiply-adds into FMAs inside `jit` and the port does
not, so a ray running exactly along a shared edge (the fans start above a
grid vertex, along the grid's axes) may be taken by one triangle on one
side and by its neighbour, or by none, on the other; against the brute
force, two faces at the same t (a shared edge) may also be taken in either
order.  The port walks packets of `kernels/packet.py::PACKET` rays (the
JAX package tiles 128), and with an ``active`` mask only the active rays,
compacted in order: both change which leaves a ray is tested against, and
the same rules hold.  K4 itself is held against the plain version on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.geom import packet as jpk
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom import packet as tpk
from lidar_brdf_tpu_torch.geom.intersect import BIG, intersect_brute
from lidar_brdf_tpu_torch.kernels import packet as kpk

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _fan(n_side, o0, el):
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(el[0], el[1], n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(np.float32(o0), d.shape).copy(), d


def _case(name):
    """(JAX scene, origins, directions) of one input set."""
    if name == "fan":                         # tests/test_pallas.py's fan
        scene = jsyn.terrain_with_boxes(np.random.default_rng(1234),
                                        num_boxes=6)
        o, d = _fan(48, (0.0, 9.0, 0.0), (-1.2, -0.2))
        return scene, o, d
    if name == "grazing":     # tests/test_torch_pulse.py::_grazing's fan
        scene = jsyn.rough_terrain(np.random.default_rng(1234),
                                   num_tris=20_000, half=30.0)
        o, d = _fan(16, (0.0, 3.0, 0.0), (-0.25, -0.02))
        return scene, o, d
    # zero-direction padding rays (at 1e10, as the walk pads, and inside
    # the scene) between real ones, in a count that is no multiple of 128
    scene = jsyn.terrain_with_boxes(np.random.default_rng(7), num_boxes=3)
    o, d = _fan(16, (0.0, 9.0, 0.0), (-1.2, -0.2))
    o[40:80], d[40:80] = 1e10, 0.0
    d[200:230] = 0.0
    return scene, o[:250], d[:250]


def _margin(scene, o, d, face):
    """min(u, v, 1-u-v) of ray (o, d) against a face, in float64."""
    v = np.asarray(scene.vertices, np.float64)[np.asarray(scene.faces)[face]]
    o, d = o.astype(np.float64), d.astype(np.float64)
    e1, e2 = v[1] - v[0], v[2] - v[0]
    h = np.cross(d, e2)
    a = e1 @ h
    s = o - v[0]
    q = np.cross(s, e1)
    u, w = (s @ h) / a, (d @ q) / a
    return min(u, w, 1.0 - u - w)


def _assert_hits_match(scene, fa, ta, fb, tb, o, d):
    """Same faces and t, up to rounding at a barycentric threshold or a tie
    in t between two faces."""
    same = fa == fb
    hit = same & (fb >= 0)
    np.testing.assert_allclose(tb[hit], ta[hit], rtol=1e-6)
    assert (tb[fb < 0] == np.float32(BIG)).all()
    for i in np.nonzero(~same)[0]:
        near = fa[i] if ta[i] <= tb[i] else fb[i]
        far = fb[i] if ta[i] <= tb[i] else fa[i]
        t_near, t_far = min(ta[i], tb[i]), max(ta[i], tb[i])
        tie = far >= 0 and t_far - t_near <= 1e-5 * t_far
        m = _margin(scene, o[i], d[i], near)
        assert tie or abs(m) <= 1e-5, (
            f"ray {i}: faces {fa[i]} (t {ta[i]}) and {fb[i]} (t {tb[i]}); "
            f"nearer face margin {m:.3e}")
    return int((~same).sum())


def _port(scene):
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    ts = convert.scene_from_numpy(_np(scene))
    return tree, ts, tpk.pack_scene(ts, convert.bvh_from_numpy(_np(tree)))


def test_pack_scene_bit_equal():
    """Every field holds the JAX pack's values; the node arrays are views
    of one (N, 8) record and the rows of (F, 12) zero-padded rows."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(3), num_boxes=4)
    tree, _, packed = _port(scene)
    pj = jpk.pack_scene(scene, tree)
    for name in tpk.PackedScene._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(packed, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    box, skip, face, rows = packed
    n, f = box.shape[0], rows.shape[0]
    rec = torch.as_strided(box, (n, 8), (8, 1))
    assert skip.data_ptr() == box.data_ptr() + 24 == face.data_ptr() - 4
    np.testing.assert_array_equal(rec.numpy().view(np.int32)[:, 6:],
                                  np.stack([np.asarray(pj.node_skip),
                                            np.asarray(pj.node_face)], 1))
    assert rows.stride() == (12, 1)
    assert not torch.as_strided(rows, (f, 12), (12, 1))[:, 9:].any()


@pytest.mark.parametrize("case", ["fan", "grazing", "padding"])
def test_plain_walk_matches_jax_and_brute(case):
    scene, o, d = _case(case)
    tree, ts, packed = _port(scene)
    hj = jpk.intersect_packed_scene(jpk.pack_scene(scene, tree),
                                    jnp.asarray(o), jnp.asarray(d))
    steps = torch.zeros((kpk.packets(o.shape[0]), 2), dtype=torch.int32)
    ht = tpk.intersect_packed_scene(packed, torch.from_numpy(o),
                                    torch.from_numpy(d), steps=steps)
    fj, tj = np.asarray(hj.face), np.asarray(hj.t)
    ft, tt = ht.face.numpy(), ht.t.numpy()
    n_jax = _assert_hits_match(scene, fj, tj, ft, tt, o, d)
    hb = intersect_brute(ts, torch.from_numpy(o), torch.from_numpy(d))
    n_brute = _assert_hits_match(scene, hb.face.numpy(), hb.t.numpy(), ft,
                                 tt, o, d)
    # the grazing fan runs along the grid's edges by design (16 of its 256
    # rays); the fan over boxes has a few such rays
    assert max(n_jax, n_brute) <= 0.1 * o.shape[0]
    assert int((ft >= 0).sum()) > 0.5 * o.shape[0] if case != "padding" \
        else int((ft >= 0).sum()) > 100
    # every packet walked (leaf steps among its node steps), and reached a
    # leaf wherever one of its rays hits
    W = kpk.PACKET
    hit_pk = np.pad(ft >= 0, (0, (-ft.shape[0]) % W)).reshape(-1, W).any(1)
    assert bool((steps[:, 0] > 0).all())
    assert (steps[:, 1].numpy()[hit_pk] >= 1).all()
    assert bool((steps[:, 1] <= steps[:, 0]).all())
    if case == "padding":
        pad = (np.abs(d).sum(axis=1) == 0)
        assert (ft[pad] == -1).all() and (tt[pad] == np.float32(BIG)).all()
        assert (fj[pad] == -1).all()


@pytest.mark.parametrize("width", kpk.WIDTHS)
def test_tiles_change_the_walk_not_the_hits(width):
    """The same rays in scan order, shifted by half a tile and shuffled
    into other packets: the same hits up to box-versus-triangle rounding
    (what lets the Simulator hand the walk its pulses in bucket order)."""
    scene, o, d = _case("fan")
    _, _, packed = _port(scene)
    hit = lambda oo, dd: tpk.intersect_packed_scene(
        packed, torch.from_numpy(oo), torch.from_numpy(dd), width=width)
    base = hit(o, d)
    n = o.shape[0]
    for perm in (np.roll(np.arange(n), 64),
                 np.random.default_rng(0).permutation(n)):
        h = hit(o[perm], d[perm])
        inv = np.argsort(perm)
        f, t = h.face.numpy()[inv], h.t.numpy()[inv]
        _assert_hits_match(scene, base.face.numpy(), base.t.numpy(), f, t,
                           o, d)


def _mask(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(n) < 0.6)


@pytest.mark.parametrize("width", kpk.WIDTHS)
@pytest.mark.parametrize("case", ["fan", "padding"])
def test_masked_walk_matches_unmasked(case, width):
    """With a mask the plain walk answers the active rays as the unmasked
    walk does (bit for bit where a ray walks alone, up to the rules of
    `_assert_hits_match` in packets: compaction puts other rays beside
    it) and gives every inactive ray the miss; a mask with every ray
    active is no mask; an all-False mask walks nothing."""
    scene, o, d = _case(case)
    _, _, packed = _port(scene)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    walk = lambda a: kpk.packet_traverse(*packed, ot, dt, active=a,
                                         width=width)
    t0, f0 = walk(None)
    act = _mask(o.shape[0])
    t1, f1 = walk(act)
    a = act.numpy()
    assert (t1.numpy()[~a] == np.float32(BIG)).all()
    assert (f1.numpy()[~a] == -1).all()
    if width == 1:
        assert torch.equal(t1[act], t0[act]) and torch.equal(f1[act], f0[act])
    else:
        _assert_hits_match(scene, f0.numpy()[a], t0.numpy()[a],
                           f1.numpy()[a], t1.numpy()[a], o[a], d[a])
    t2, f2 = walk(torch.ones(o.shape[0], dtype=torch.bool))
    assert torch.equal(t2, t0) and torch.equal(f2, f0)
    steps = torch.full((kpk.packets(o.shape[0], width), 2), 7,
                       dtype=torch.int32)
    t3, f3 = kpk.packet_traverse(*packed, ot, dt, steps,
                                 active=torch.zeros_like(act), width=width)
    assert (f3 == -1).all() and (t3 == np.float32(BIG)).all()
    assert (steps == 7).all()


@pytest.mark.parametrize("width", kpk.WIDTHS)
def test_walk_lengths_follow_the_packet_width(width):
    """``steps`` holds one row per packet of ``width`` active rays (rows
    past the last packet untouched); a packet walks at least as far as the
    longest solo walk of its rays, which is each ray's row at width 1."""
    scene, o, d = _case("fan")
    _, _, packed = _port(scene)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    act = _mask(o.shape[0], seed=1)
    m = int(act.sum())
    steps = torch.full((kpk.packets(o.shape[0], width), 2), -5,
                       dtype=torch.int32)
    kpk.packet_traverse(*packed, ot, dt, steps, active=act, width=width)
    solo = torch.zeros((m, 2), dtype=torch.int32)
    kpk.packet_traverse(*packed, ot[act], dt[act], solo, width=1)
    walked, rest = steps[:kpk.packets(m, width)], steps[kpk.packets(m, width):]
    assert (rest == -5).all() and (walked[:, 0] >= 1).all()
    assert (walked[:, 1] >= 0).all() and (walked[:, 1] <= walked[:, 0]).all()
    pad = (-m) % width
    longest = torch.cat([solo[:, 0], solo.new_zeros(pad)]).reshape(
        -1, width).amax(dim=1)
    assert (walked[:, 0] >= longest).all()
    if width == 1:
        assert torch.equal(walked, solo)
    else:                              # wider packets walk the union
        assert int(walked[:, 0].sum()) < width * int(solo[:, 0].sum()) // 2


def test_traverser_shapes_and_counts():
    """`make_packet_traverser` keeps the rays' leading shape; a count of
    rays that is no multiple of the tile is padded; the plain walk
    launches nothing."""
    scene, o, d = _case("fan")
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    walk = tpk.make_packet_traverser(convert.scene_from_numpy(_np(scene)),
                                     convert.bvh_from_numpy(_np(tree)))
    before = kpk.KERNEL.launches
    n = 100 * 7
    h = walk(torch.from_numpy(o[:n].reshape(100, 7, 3)),
             torch.from_numpy(d[:n].reshape(100, 7, 3)))
    assert h.t.shape == (100, 7) and h.face.shape == (100, 7)
    assert h.face.dtype == torch.int32 and kpk.KERNEL.launches == before
    flat = tpk.intersect_packed_scene(tpk.pack_scene(
        convert.scene_from_numpy(_np(scene)),
        convert.bvh_from_numpy(_np(tree))), torch.from_numpy(o[:n]),
        torch.from_numpy(d[:n]))
    assert torch.equal(flat.face, h.face.reshape(-1))


def test_pack_and_wrapper_refuse_bad_inputs():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(3), num_boxes=1)
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    bad = _np(tree)
    bad["node_skip"] = bad["node_skip"].copy()
    bad["node_skip"][3] = 1                  # a link back up the tree
    ts = convert.scene_from_numpy(_np(scene))
    with pytest.raises(ValueError, match="forward"):
        tpk.pack_scene(ts, convert.bvh_from_numpy(bad))
    packed = tpk.pack_scene(ts, convert.bvh_from_numpy(_np(tree)))
    o = torch.zeros((128, 3))
    with pytest.raises(ValueError, match="N, 3"):
        kpk.packet_traverse(*packed, o[:100], o[:99])
    with pytest.raises(ValueError):
        kpk.packet_traverse(*packed, o.double(), o.double())
    with pytest.raises(ValueError, match="steps"):
        kpk.packet_traverse(*packed, o, o,
                            steps=torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="active"):
        kpk.packet_traverse(*packed, o, o, active=torch.ones(100, dtype=bool))
    for width in (32, 64):
        with pytest.raises(ValueError, match="width"):
            kpk.packet_traverse(*packed, o, o, width=width)
    # arrays that are not views of the records K4 reads
    with pytest.raises(ValueError, match="record"):
        kpk.packet_traverse(*[x.contiguous() for x in packed], o, o)


def test_pack_helpers_bit_equal():
    """`pack_bvh` and `pack_triangles` hold the JAX helpers' values, in the
    layouts K4 reads; `pack_scene` is the two together."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(3), num_boxes=4)
    tree, ts, packed = _port(scene)
    nodes = tpk.pack_bvh(convert.bvh_from_numpy(_np(tree)))
    for got, want in zip(nodes, jpk.pack_bvh(tree)):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert nodes[0].stride() == (8, 1)
    assert nodes[1].data_ptr() == nodes[0].data_ptr() + 24
    rows = tpk.pack_triangles(ts)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jpk.pack_triangles(scene)))
    assert rows.stride() == (12, 1)
    for a, b in zip(packed, (*nodes, rows)):
        assert torch.equal(a, b)
    assert tpk.DEFAULT_TILE == jpk.DEFAULT_TILE in kpk.WIDTHS


@pytest.mark.parametrize("tile", [1, 128])
@pytest.mark.parametrize("case", ["fan", "grazing"])
def test_intersect_packed_matches_jax(case, tile):
    """The tuple-input walk at ``tile`` against the JAX package's at the
    same tile, under the rules of `_assert_hits_match`; a tile outside
    K4's widths raises."""
    scene, o, d = _case(case)
    tree, ts, _ = _port(scene)
    hj = jpk.intersect_packed(jpk.pack_bvh(tree), jpk.pack_triangles(scene),
                              jnp.asarray(o), jnp.asarray(d), tile=tile)
    nodes = tpk.pack_bvh(convert.bvh_from_numpy(_np(tree)))
    rows = tpk.pack_triangles(ts)
    ht = tpk.intersect_packed(nodes, rows, torch.from_numpy(o),
                              torch.from_numpy(d), tile=tile)
    n = _assert_hits_match(scene, np.asarray(hj.face), np.asarray(hj.t),
                           ht.face.numpy(), ht.t.numpy(), o, d)
    assert n <= 0.1 * o.shape[0]
    assert int((ht.face >= 0).sum()) > 0.5 * o.shape[0]
    if tile == 128:
        hd = tpk.intersect_packed(nodes, rows, torch.from_numpy(o),
                                  torch.from_numpy(d))
        assert torch.equal(hd.face, ht.face) and torch.equal(hd.t, ht.t)
    with pytest.raises(ValueError, match="width"):
        tpk.intersect_packed(nodes, rows, torch.from_numpy(o),
                             torch.from_numpy(d), tile=64)


@pytest.mark.parametrize("name", ["base", "packet32", "prefetch",
                                  "min_blocks=0"])
def test_variant_script_edits_apply(name, monkeypatch):
    """`scripts/k4_variants.py` makes each variant by a text change of K4's
    source: every change still finds its text there, as often as the
    variant expects."""
    import importlib
    import pathlib
    monkeypatch.syspath_prepend(
        str(pathlib.Path(__file__).parent.parent / "scripts"))
    mod = importlib.import_module("k4_variants")
    base = open(kpk.KERNEL.source).read()
    out = mod.source(name, base)
    assert (out == base) == (name == "base")
