"""Pulse-ladder traversal: the port's host half and the plain PyTorch version
of the CUDA ladder kernel (K2) vs the JAX package's Pallas kernel in
interpret mode, on the cases of `tests/test_pallas.py:127-254`.

Ladders are host numpy on both sides and must be bit-equal.  Hits: t to
rtol 1e-6 where both sides hit the same face, and faces exact except where
the deciding comparison sits within 1e-5 of its threshold, checked in
float64: XLA contracts multiply-adds into FMAs inside `jit` and the port
does not, so a ray running exactly along a shared mesh edge (the grazing
fan starts above a grid vertex, along the grid's axes and diagonals) may
be accepted by one triangle on one side and by its neighbour, or by none,
on the other.  K2 itself is held against the plain version on the card by
`tests/test_torch_cuda.py`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.geom import bvh as jbvh
from lidar_brdf_tpu.geom.intersect import intersect_brute
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.kernels import pulse_pallas as jpp
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom.beamcull import wald_rows_np
from lidar_brdf_tpu_torch.kernels import pulse as tpp
from lidar_brdf_tpu_torch.runtime.simulate import (PULSE_MIN_FACES,
                                                   pick_pulse_ladders)

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _fan_rays(n_side=16, o0=(0.0, 9.0, 0.0), el=(-1.2, -0.2)):
    o0 = np.array(o0, np.float32)
    az = np.linspace(0, 2 * np.pi, n_side, endpoint=False)
    el = np.linspace(el[0], el[1], n_side)
    aa, ee = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                  np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.broadcast_to(o0, d.shape).copy(), d


def _grazing():
    """`test_pulse_ladder_chunked_matches`'s fan: fat ladders."""
    scene = jsyn.rough_terrain(np.random.default_rng(1234), num_tris=20_000,
                               half=30.0)
    o, d = _fan_rays(16, (0.0, 3.0, 0.0), (-0.25, -0.02))
    return scene, o, d, 2


def _both(scene, o, d, R, t_max, group=1):
    """(JAX hit, port hit, port traverser, port data) for one input; the
    hits are held against each other by `_assert_hits_match`."""
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    jt = jpp.PulseLadderTraverser(scene, rays_per_pulse=R, group=group,
                                  interpret=True)
    hj = jt(jnp.asarray(o.reshape(-1, R, 3)), jnp.asarray(d.reshape(-1, R, 3)),
            jt.prepare(tree, o, d, t_max=t_max))
    tt = tpp.PulseLadderTraverser(convert.scene_from_numpy(_np(scene)),
                                  rays_per_pulse=R, group=group, device="cpu")
    data = tt.prepare(convert.bvh_from_numpy(_np(tree)), o, d, t_max=t_max)
    ht = tt(torch.from_numpy(o.reshape(-1, R, 3)),
            torch.from_numpy(d.reshape(-1, R, 3)), data)
    assert jt.t_max == tt.t_max
    _assert_hits_match(hj, ht, tt.wald.numpy(), o, d)
    return hj, ht, tt, data


def _margin(wald, o, d, face):
    """(t, min(u, v, 1-u-v)) of ray (o, d) against a face's Wald row, in
    float64."""
    r = wald[face].astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    t = (r[3] - r[0:3] @ o) / (r[0:3] @ d)
    u = r[4:7] @ o + r[7] + t * (r[4:7] @ d)
    v = r[8:11] @ o + r[11] + t * (r[8:11] @ d)
    return t, min(u, v, 1.0 - u - v)


def _assert_hits_match(hj, ht, wald, o, d):
    fj = np.asarray(hj.face).reshape(-1)
    fo = ht.face.numpy().reshape(-1)
    tj = np.asarray(hj.t).reshape(-1)
    to = ht.t.numpy().reshape(-1)
    same = fj == fo
    hit = same & (fo >= 0)
    np.testing.assert_allclose(to[hit], tj[hit], rtol=1e-6)
    assert (to[fo < 0] == np.float32(3.4e38)).all()
    for i in np.nonzero(~same)[0]:
        near, far = (fj[i], fo[i]) if tj[i] <= to[i] else (fo[i], fj[i])
        t_near = min(tj[i], to[i])
        t_far = max(tj[i], to[i])
        # either a tie in t between two faces, or one side rejected the
        # nearer face by rounding at a barycentric threshold
        tie = far >= 0 and t_far - t_near <= 1e-5 * t_far
        _, m = _margin(wald, o[i], d[i], near)
        assert tie or abs(m) <= 1e-5, (
            f"ray {i}: JAX face {fj[i]} t {tj[i]}, port face {fo[i]} t "
            f"{to[i]}; nearer face margin {m:.3e}")


@pytest.mark.parametrize("case", ["fan", "grazing"])
def test_ladders_and_permutation_bit_equal(case, monkeypatch):
    """Both packages' host ladders through one native library, the port's
    (built without fused multiply-adds, the arithmetic of the device
    cull): the JAX package's own build may fuse them, which moves near
    distances by an ulp and the order of near-equal candidates with them."""
    from lidar_brdf_tpu.io import native as jnative
    from lidar_brdf_tpu_torch.io import native as tnative
    monkeypatch.delenv("LIDAR_BRDF_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_lib", tnative.get_lib())
    monkeypatch.setattr(jnative, "_tried", True)
    if case == "fan":
        scene = jsyn.terrain_with_boxes(np.random.default_rng(1234),
                                        num_boxes=6)
        o, d = _fan_rays()
        R = 4
    else:
        scene, o, d, R = _grazing()
    tree = jbvh.build_bvh(np.asarray(scene.vertices), np.asarray(scene.faces))
    bj = jpp.build_pulse_ladders(tree, o, d, R, t_max=500.0)
    bt = tpp.build_pulse_ladders(convert.bvh_from_numpy(_np(tree)), o, d, R,
                                 t_max=500.0)
    assert len(bj) == len(bt) >= 1
    for (pj, cj), (pt, ct) in zip(bj, bt):
        assert pt.dtype == pj.dtype and ct.dtype == cj.dtype
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(ct, cj)
    P = o.shape[0] // R
    perm_j, layout_j = jpp.permute_pulse_ladders(bj, P)
    perm_t, layout_t = tpp.permute_pulse_ladders(bt, P)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert layout_t == layout_j
    # renumbered buckets point at each pulse's slot in the new order
    for (start, B, B_pad), (pidx, _), (new, _) in zip(
            layout_t, bt, tpp.renumber_pulse_ladders(bt, perm_t)):
        np.testing.assert_array_equal(new[:B], np.arange(start, start + B))
        np.testing.assert_array_equal(perm_t[new[:B]], pidx[:B])
        assert (new[B:] == P).all() and new.shape[0] == B_pad


def test_plain_matches_pallas_and_brute():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=6)
    o, d = _fan_rays()
    hj, ht, _, _ = _both(scene, o, d, 4, 500.0)
    np.testing.assert_array_equal(ht.face.numpy(), np.asarray(hj.face))
    brute = intersect_brute(scene, jnp.asarray(o), jnp.asarray(d))
    hit = ht.face.numpy().reshape(-1) >= 0
    assert hit.sum() > 100
    np.testing.assert_array_equal(hit, np.asarray(brute.face) >= 0)


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_equals_group_1(group):
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=6)
    o, d = _fan_rays()
    _, ht, _, _ = _both(scene, o, d, 4, 500.0, group=group)
    _, h1, _, _ = _both(scene, o, d, 4, 500.0)
    np.testing.assert_array_equal(ht.face.numpy(), h1.face.numpy())
    np.testing.assert_array_equal(ht.t.numpy(), h1.t.numpy())


def test_group_pad_boundary():
    """A group straddling real and zero-direction pad pulses culls from the
    real rays only: pads miss, reals keep their hits."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=4)
    o, d = _fan_rays()
    R = 4
    o2, d2 = o.copy().reshape(-1, R, 3), d.copy().reshape(-1, R, 3)
    o2[-2:] = 1e10
    d2[-2:] = 0.0
    o2, d2 = o2.reshape(-1, 3), d2.reshape(-1, 3)
    _, ht, _, _ = _both(scene, o2, d2, R, 500.0, group=4)
    assert (ht.face.numpy()[-2:] == -1).all()
    _, h1, _, _ = _both(scene, o2[:-2 * R], d2[:-2 * R], R, 500.0)
    np.testing.assert_array_equal(ht.face.numpy()[:-2], h1.face.numpy())


def test_fat_ladder_single_pass_equals_split_passes(monkeypatch):
    """The JAX wrapper splits fat ladders into MAX_KB-block passes merged by
    strict <; the port walks each ladder once.  Same hits either way."""
    scene, o, d, R = _grazing()
    _, ht, tt, data = _both(scene, o, d, R, 500.0)
    assert any(c.shape[1] > 8 for _, c in data), "no fat ladder"
    monkeypatch.setattr(jpp, "MAX_KB", 1)
    _, ht1, _, _ = _both(scene, o, d, R, 500.0)      # checks JAX vs port
    np.testing.assert_array_equal(ht1.face.numpy(), ht.face.numpy())
    # the plain version's own row slicing changes nothing
    t1, f1 = tpp.pulse_traverse_plain(
        tt.wald, torch.from_numpy(o), torch.from_numpy(d), data, tt.t_max, R,
        max_pairs=1)
    np.testing.assert_array_equal(f1.numpy(), ht.face.numpy().reshape(-1))
    np.testing.assert_array_equal(t1.numpy(), ht.t.numpy().reshape(-1))


def test_t_max_cut():
    verts = np.array([[-1, -1, 50], [1, -1, 50], [0, 1, 50]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    scene = jsyn.scene_from_arrays(verts, faces)
    o = np.zeros((tpp.LANES, 3), np.float32)
    d = np.tile(np.array([0, 0, 1], np.float32), (tpp.LANES, 1))
    hj, ht, _, _ = _both(scene, o, d, 1, 100.0)
    np.testing.assert_array_equal(np.asarray(hj.face), ht.face.numpy())
    assert (ht.face.numpy() == 0).all()
    np.testing.assert_allclose(ht.t.numpy(), 50.0, rtol=1e-6)
    hj, ht, _, _ = _both(scene, o, d, 1, 10.0)
    np.testing.assert_array_equal(np.asarray(hj.face), ht.face.numpy())
    assert (ht.face.numpy() == -1).all()


def test_wrapper_rejects_bad_inputs():
    wald = torch.zeros((4, 12))
    o = torch.zeros((40, 3))
    good = (torch.zeros(2, dtype=torch.int32),
            torch.zeros((2, 8), dtype=torch.int32))
    t, f = tpp.pulse_traverse(wald, o, o, [good], 1.0, 4)
    assert t.shape == f.shape == (40,)
    bad = [
        (wald.double(), o, [good], 4),                      # dtype
        (wald, o, [(good[0].long(), good[1])], 4),          # pidx dtype
        (wald, o, [good], 3),                               # 40 % 3 rays
        (wald, o, [good], 0),
        (wald, o[:, :2], [good], 4),                        # shape
        (wald[:, :8], o, [good], 4),
        (wald, o, [(good[0], good[1][:, :6])], 4),          # K % 8
        (wald, o, [(good[0][:1], good[1])], 4),             # B mismatch
        (wald.t(), o, [good], 4),                           # contiguity
    ]
    for w, oo, buckets, kr in bad:
        with pytest.raises(ValueError):
            tpp.pulse_traverse(w, oo, oo, buckets, 1.0, kr)
    with pytest.raises(TypeError):
        tpp.pulse_traverse(wald, o, o, [(good[0].numpy(), good[1])], 1.0, 4)
    with pytest.raises(ValueError):
        tpp.pulse_traverse(wald.to("meta"), o.to("meta"), o.to("meta"), [],
                           1.0, 4)


def test_dummy_rows_and_uncovered_pulses_miss():
    verts = np.array([[-1, -1, 5], [1, -1, 5], [0, 1, 5]], np.float32)
    wald = torch.from_numpy(wald_rows_np(verts, np.array([[0, 1, 2]])))
    o = torch.zeros((6, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(6, 1)
    pidx = torch.tensor([1, 3, -1], dtype=torch.int32)      # 3 == P: dummy
    cand = torch.tensor([[0] + [-1] * 7] * 3, dtype=torch.int32)
    t, f = tpp.pulse_traverse(wald, o, d, [(pidx, cand)], 100.0, 2)
    assert f.tolist() == [-1, -1, 0, 0, -1, -1]
    assert t[2].item() == 5.0 and (t[[0, 1, 4, 5]] == 3.4e38).all()


def test_traverser_choice_rule():
    assert PULSE_MIN_FACES == 100_000
    assert not pick_pulse_ladders(100_000)
    assert not pick_pulse_ladders(40_000)
    assert pick_pulse_ladders(100_001)
    assert pick_pulse_ladders(4_999_122)
    assert pick_pulse_ladders(10, use_pulse=True)
    assert not pick_pulse_ladders(5_000_000, use_pulse=False)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K2 vs its plain version on the fan input (needs a card and JAX; the
    JAX-free card tests are in `tests/test_torch_cuda.py`)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K2 runs only on the card")
    scene = jsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=6)
    o, d = _fan_rays()
    _, ht, tt, data = _both(scene, o, d, 4, 500.0)
    cuda = lambda a: a.cuda()
    t, f = tpp.pulse_traverse(
        tt.wald.cuda(), cuda(torch.from_numpy(o)), cuda(torch.from_numpy(d)),
        [(cuda(p), cuda(c)) for p, c in data], tt.t_max, 4)
    torch.cuda.synchronize()
    assert torch.equal(f.cpu(), ht.face.reshape(-1))
    hit = f.cpu() >= 0
    torch.testing.assert_close(t.cpu()[hit], ht.t.reshape(-1)[hit],
                               rtol=1e-6, atol=0)
