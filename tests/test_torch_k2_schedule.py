"""K2's one-launch work list, its ladder contract and its staged walk, on
the CPU.

The pulse-ladder kernel (`kernels/csrc/pulse_traverse.cu`) runs every
bucket of a call in one launch over the blocks `pulse_schedule` lays out,
a block taking whole groups of rays, one thread per ray.  It tests no
padding id (-1), skips a block of 8 that holds padding only wherever it
sits in a ladder row, and stages ladders 16 candidates at a time.  The
kernel runs only on the card (`tests/test_torch_cuda.py` holds it against
the plain version there); here the schedule is decoded block by block and
thread by thread as the kernel decodes it, `build_pulse_ladders` is shown
to keep the real ids of every row as its prefix, and the kernel's walk,
written out in Python, is held bit for bit against
`pulse_traverse_plain`, which tests every candidate.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu_torch import api
from lidar_brdf_tpu_torch.core.config import LiDARType, SensorConfig
from lidar_brdf_tpu_torch.geom.beamcull import wald_rows_np
from lidar_brdf_tpu_torch.geom.intersect import BIG
from lidar_brdf_tpu_torch.io import synthetic
from lidar_brdf_tpu_torch.kernels import pulse as pp
from lidar_brdf_tpu_torch.kernels import traverse as tr

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

# (rows, K, real rows): the `tls` city chunk's K2 buckets cut by 1/80
# (79,360 x 8 ... 512 x 128 there), and an empty bucket
SHAPES = [(1024, 8, 996), (384, 16, 300), (128, 32, 120), (128, 64, 70),
          (0, 8, 0), (128, 128, 7)]
ORDERS = {"as culled": lambda n: range(n),
          "reversed": lambda n: reversed(range(n)),
          "shuffled": lambda n: np.random.default_rng(5).permutation(n)}


def _buckets(rng, n_groups, order):
    """Buckets of SHAPES in the given order: real rows first, each a
    distinct group; dummy rows (pidx == n_groups) after."""
    groups = rng.permutation(n_groups)
    out, at = [], 0
    for j in order(len(SHAPES)):
        B, K, real = SHAPES[j]
        pidx = np.full(B, n_groups, np.int32)
        pidx[:real] = groups[at:at + real]
        at += real
        out.append((torch.from_numpy(pidx),
                    torch.full((B, K), -1, dtype=torch.int32)))
    return out, groups[at:]


def _decode(sched, buckets, n_groups, R):
    """Writes per output ray of one launch, as the kernel decodes its grid:
    block (x, y) -> bucket and rows by x, ray slice y; thread (tx, ty) ->
    (ray, row)."""
    RB, Rs = sched.rows_per_block, sched.slice_rays
    firsts = np.array([e[3] for e in sched.entries])
    bx, by, ty, tx = np.meshgrid(np.arange(sched.n_blocks),
                                 np.arange(sched.slices), np.arange(RB),
                                 np.arange(Rs), indexing="ij")
    k = np.searchsorted(firsts, bx, side="right") - 1
    row = (bx - firsts[k]) * RB + ty
    r = by * Rs + tx
    writes = np.zeros(n_groups * R, np.int64)
    for j, (i, B, K, _) in enumerate(sched.entries):
        pidx = buckets[i][0].numpy()
        mine = (k == j) & (r < R) & (row < B)
        q = pidx[row[mine]]
        ok = (q >= 0) & (q < n_groups)
        np.add.at(writes, q[ok].astype(np.int64) * R + r[mine][ok], 1)
    return writes


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("R", [1, 4, 10, 40, 300])
def test_schedule_covers_every_real_ray_once(R, order):
    n_groups = 2000
    rng = np.random.default_rng(R)
    buckets, untouched = _buckets(rng, n_groups, ORDERS[order])
    sched = pp.pulse_schedule(buckets, R)
    # longest ladders first, the empty bucket dropped, blocks end to end
    assert [e[2] for e in sched.entries] == [128, 64, 32, 16, 8]
    assert all(tuple(buckets[e[0]][1].shape) == (e[1], e[2])
               for e in sched.entries)
    RB, Rs = sched.rows_per_block, sched.slice_rays
    assert Rs == min(R, pp.MAX_THREADS) and sched.slices == -(-R // Rs)
    assert 1 <= RB <= pp.MAX_ROWS and RB * Rs <= pp.MAX_THREADS
    assert RB == pp.MAX_ROWS or RB * Rs > pp.MAX_THREADS - Rs
    # the block's staged ladders fit in 48 KB of shared memory
    assert RB * pp.STAGE * 52 <= 48 * 1024
    first = 0
    for i, B, K, first_block in sched.entries:
        assert first_block == first
        first += -(-B // RB)
    assert sched.n_blocks == first
    writes = _decode(sched, buckets, n_groups, R).reshape(n_groups, R)
    covered = np.setdiff1d(np.arange(n_groups), untouched)
    assert (writes[covered] == 1).all()
    assert (writes[untouched] == 0).all()


def test_schedule_rows_per_block_at_the_workloads_widths():
    """12 groups of 10 rays (120 threads) on `als`; one group of 128 for the
    planted tie; slices of 128 rays past 128."""
    one = [(torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.int32))]
    geo = {R: pp.pulse_schedule(one, R)[2:] for R in (10, 128, 2, 600)}
    assert geo == {10: (12, 10, 1), 128: (1, 128, 1), 2: (32, 2, 1),
                   600: (1, 128, 5)}
    assert pp.pulse_schedule(one, 600).n_blocks == 1


def test_schedule_keeps_input_order_among_equal_lengths():
    i32 = dict(dtype=torch.int32)
    b = [(torch.zeros(n, **i32), torch.zeros((n, K), **i32))
         for n, K in ((30, 16), (50, 64), (60, 16))]
    sched = pp.pulse_schedule(b, 10)
    assert [e[0] for e in sched.entries] == [1, 0, 2]
    assert [e[3] for e in sched.entries] == [0, 5, 8] and sched.n_blocks == 13


def test_schedule_of_a_call_without_rows_and_too_many_buckets():
    i32 = dict(dtype=torch.int32)
    empty = (torch.zeros(0, **i32), torch.zeros((0, 8), **i32))
    no_cand = (torch.zeros(4, **i32), torch.zeros((4, 0), **i32))
    assert pp.pulse_schedule([], 10).entries == ()
    assert pp.pulse_schedule([empty, no_cand], 10).n_blocks == 0
    one = (torch.zeros(1, **i32), torch.zeros((1, 8), **i32))
    assert len(pp.pulse_schedule([one] * pp.MAX_BUCKETS, 10).entries) == 32
    with pytest.raises(ValueError):
        pp.pulse_schedule([one] * (pp.MAX_BUCKETS + 1), 10)


def _als_small():
    """The ALS zig-zag of `chip_smoke.py` phase 5 over a small rough
    terrain: 2,048 pulses of 4 rays."""
    scene = synthetic.rough_terrain(np.random.default_rng(0),
                                    num_tris=20_000, half=30.0)
    cfg = SensorConfig(lidar_type=LiDARType.AERIAL_ZIGZAG,
                       als_position=(0.0, 40.0, 0.0), als_scan_frequency=40,
                       als_pulse_frequency=2560, als_speed=30.0,
                       max_range=400.0, rays_per_pulse=4, pulse_radius=0.3,
                       chunk_pulses=2048)
    rays = api.build_rays(cfg, scene, device="cpu")
    return (scene, rays.origin[:2048].reshape(-1, 3).numpy(),
            rays.direction[:2048].reshape(-1, 3).numpy(), 4)


def _ladder_inputs(case):
    if case == "fan":
        scene = synthetic.terrain_with_boxes(np.random.default_rng(1234),
                                             num_boxes=6)
        return (scene, *chip_smoke.fan_rays(16), 4)
    if case == "grazing":
        scene = synthetic.rough_terrain(np.random.default_rng(1234),
                                        num_tris=20_000, half=30.0)
        az = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        el = np.linspace(-0.25, -0.02, 16)
        aa, ee = np.meshgrid(az, el, indexing="ij")
        d = np.stack([np.cos(ee) * np.cos(aa), np.sin(ee),
                      np.cos(ee) * np.sin(aa)], -1).reshape(-1, 3)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        return scene, np.tile(np.float32([0, 3, 0]), (256, 1)), d, 2
    return _als_small()


@pytest.mark.parametrize("case", ["fan", "grazing", "als"])
def test_ladders_keep_real_ids_as_a_prefix(case):
    """What K2's stop at the first all-padding block relies on; and the
    bucket-contiguous layout leaves exactly the uncovered range
    `uncovered_groups` names, every other group with one real row (what
    lets K2 write the uncovered groups instead of the wrapper's fills)."""
    scene, o, d, R = _ladder_inputs(case)
    raw = pp.build_pulse_ladders(api.build_scene_bvh(scene), o, d, R,
                                 t_max=500.0)
    P = o.shape[0] // R
    if case == "grazing":
        assert max(c.shape[1] for _, c in raw) >= 64
    for pidx, cand in raw:
        real = cand >= 0
        n_real = real.sum(axis=1)
        assert (real == (np.arange(cand.shape[1]) < n_real[:, None])).all()
        assert (n_real[pidx == P] == 0).all() and (n_real[pidx < P] > 0).all()
    perm, layout = pp.permute_pulse_ladders(raw, P)
    lo, hi = pp.uncovered_groups(layout, P)
    assert hi == P and 0 < lo <= P
    rows = np.zeros(P, np.int64)
    for pidx, _ in pp.renumber_pulse_ladders(raw, perm):
        np.add.at(rows, pidx[pidx < P], 1)
    assert (rows[:lo] == 1).all() and (rows[lo:] == 0).all()


def _kernel_walk(wald, o, d, ladder, tm):
    """One ladder row's rays (R, 3) as `pulse_traverse_kernel` walks them:
    stages of `pp.STAGE` candidates; per block of 8, no test on a padding
    id, the real candidates' min t_m (tm when none is lower) and the min
    id at it, merged by strict <; a block of padding only is skipped.
    Returns (t, face, candidates tested per ray)."""
    R, K = o.shape[0], ladder.shape[0]
    t_m = tr.wald_t_m_plain(wald, o[None, :, None], d[None, :, None],
                            ladder[None], tm)[0]                 # (R, K)
    t_best = tm.expand(R).clone()
    f_best = torch.full((R,), -1, dtype=torch.int32)
    tested = 0
    for s in range(0, K, pp.STAGE):
        for b in range(s, min(s + pp.STAGE, K), tr.CAND_BLOCK):
            ids = [int(x) for x in ladder[b:b + tr.CAND_BLOCK]]
            if max(ids) < 0:
                continue
            t_c = tm.expand(R).clone()
            f_c = torch.full((R,), tr.INT_MISS, dtype=torch.int32)
            for m, cid in enumerate(ids):
                if cid < 0:
                    continue
                tested += 1
                lt = t_m[:, b + m] < t_c
                eq = (t_m[:, b + m] == t_c) & (cid < f_c)
                t_c = torch.where(lt, t_m[:, b + m], t_c)
                f_c = torch.where(lt | eq, torch.full_like(f_c, cid), f_c)
            better = t_c < t_best
            t_best = torch.where(better, t_c, t_best)
            f_best = torch.where(better, f_c, f_best)
    return torch.where(f_best < 0, torch.full_like(t_best, BIG), t_best), \
        f_best, tested


def _walk_vs_plain(wald, o, d, ladders, R, t_max):
    """Every ladder row through `_kernel_walk` and `pulse_traverse_plain`
    (row g holds group g): equal bit for bit.  Returns (t, face, tested)."""
    P = len(ladders)
    K = max(len(x) for x in ladders)
    cand = torch.full((P, K), -1, dtype=torch.int32)
    for g, x in enumerate(ladders):
        cand[g, :len(x)] = torch.as_tensor(x, dtype=torch.int32)
    t_p, f_p = pp.pulse_traverse_plain(
        wald, o, d, [(torch.arange(P, dtype=torch.int32), cand)], t_max, R)
    tm = torch.tensor(t_max, dtype=torch.float32)
    walks = [_kernel_walk(wald, o[g * R:(g + 1) * R], d[g * R:(g + 1) * R],
                          cand[g], tm) for g in range(P)]
    t_k = torch.cat([w[0] for w in walks])
    f_k = torch.cat([w[1] for w in walks])
    assert torch.equal(f_k, f_p)
    assert torch.equal(t_k, t_p)
    return t_k, f_k, [w[2] for w in walks]


@pytest.mark.parametrize("n_cand", [64, 128, 256])
def test_staged_walk_equals_plain_with_a_planted_tie(n_cand):
    """Coincident faces 40 (block 1) and 12 (block 6, stage 3 at K >= 64):
    the earlier block wins though its id is larger, and the walk stops
    after the 64 real candidates."""
    wald, o, d, ids = (torch.from_numpy(a)
                       for a in chip_smoke.planted_tie(n_cand))
    _, f, tested = _walk_vs_plain(wald, o, d, [ids] * 16, 8, 100.0)
    assert int((f == 40).sum()) > 10 and not bool((f == 12).any())
    assert tested == [64] * 16


def test_staged_walk_padding_anywhere_and_real_misses():
    """Padding inside a block is skipped wherever it sits; a ladder whose
    real candidates all miss gives (BIG, -1); a ladder of padding only
    tests nothing."""
    wald, o, d, ids = (torch.from_numpy(a) for a in chip_smoke.planted_tie(64))
    holes = ids.clone()
    holes[torch.arange(0, 64, 3)] = -1          # -1 inside real blocks
    away = [int(x) for x in ids[:3]] + [-1] * 5
    ladders = [ids, holes, away, [-1] * 8]
    o4, d4 = o[:32].clone(), d[:32].clone()
    d4[16:24] = -d4[16:24]                      # group 2 looks away
    t, f, tested = _walk_vs_plain(wald, o4, d4, ladders, 8, 100.0)
    assert bool((f[16:] == -1).all()) and bool((t[16:] == BIG).all())
    assert bool((f[:16] >= 0).any())
    assert tested == [64, 64 - 22, 3, 0]


def _interior_padding():
    """The planted tie's ladder with whole blocks of 8 of padding inside
    it: the tie's two faces (block 1 and block 6 of the original) then sit
    behind an all-padding block, in the same and in a later stage."""
    wald, o, d, ids = (torch.from_numpy(a) for a in chip_smoke.planted_tie(64))
    gap = torch.full((tr.CAND_BLOCK,), -1, dtype=torch.int32)
    one = torch.cat([ids[:8], gap, ids[8:]])            # block 1 of 16
    three = torch.cat([gap, ids[:40], gap, gap, ids[40:]])
    return wald, o, d, [one, three, ids]


@pytest.mark.parametrize("tail_padded", [False, True])
def test_staged_walk_interior_padding_both_modes(tail_padded):
    """Ladders with an all-padding block of 8 before real ids (a bucket a
    caller builds by hand) and the same ladders with their padding moved
    to the tail (as `build_pulse_ladders` makes them): the kernel's walk
    skips every block of padding, tests each real id once and equals the
    plain version, which tests every candidate, in both layouts."""
    wald, o, d, ladders = _interior_padding()
    if tail_padded:
        ladders = [torch.cat([x[x >= 0], x[x < 0]]) for x in ladders]
        assert all(bool((x[64:] == -1).all()) for x in ladders)
    _, f, tested = _walk_vs_plain(wald, o[:24], d[:24], ladders, 8, 100.0)
    assert tested == [64, 64, 64] and int((f == 40).sum()) > 0


def test_ladders_carry_the_tail_padding_promise():
    """The traverser's upload (what the Simulator and the bench hand K2) is
    a `PulseLadders` whose rows hold their real ids first and their padding
    after; K2 gives it the same faces as the same buckets as a plain
    tuple, and a hand-built `PulseLadders` names no uncovered groups."""
    scene, o, d, R = _ladder_inputs("fan")
    tt = pp.PulseLadderTraverser(scene, rays_per_pulse=R, device="cpu")
    data = tt.prepare(api.build_scene_bvh(scene), o, d, t_max=500.0)
    assert isinstance(data, pp.PulseLadders)
    assert pp.PulseLadders(list(data)).uncovered is None
    for _, cand in data:
        pad = cand < 0
        assert bool((pad[:, 1:] >= pad[:, :-1]).all())    # no id after -1
    og, dg = torch.from_numpy(o), torch.from_numpy(d)
    f1 = pp.pulse_traverse(tt.wald, og, dg, data, tt.t_max, R)[1]
    f2 = pp.pulse_traverse(tt.wald, og, dg, tuple(data), tt.t_max, R)[1]
    assert torch.equal(f1, f2) and bool((f1 >= 0).any())


def test_staged_walk_hit_at_exactly_t_max():
    """A hit at t == t_max is no hit (strict < from t_max), in the walk as
    in the plain version; just below t_max it wins."""
    v = np.array([[-1, -1, 50], [1, -1, 50], [0, 1, 50]], np.float32)
    wald = torch.from_numpy(wald_rows_np(v, np.array([[0, 1, 2]])))
    o = torch.zeros((8, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    t, f, _ = _walk_vs_plain(wald, o, d, [[0] + [-1] * 7], 8, 100.0)
    assert bool((f == 0).all()) and bool((t == 50.0).all())
    t, f, _ = _walk_vs_plain(wald, o, d, [[0] + [-1] * 7], 8, 50.0)
    assert bool((f == -1).all()) and bool((t == BIG).all())
    t, f, _ = _walk_vs_plain(wald, o, d, [[0] + [-1] * 7], 8,
                             float(np.nextafter(np.float32(50), 100)))
    assert bool((f == 0).all())


def test_uncovered_range_checked_and_ignored_on_the_cpu():
    """The CPU path fills every uncovered group itself: a named uncovered
    range changes nothing there, and one outside [0, P) raises."""
    wald, o, d, ids = (torch.from_numpy(a) for a in chip_smoke.planted_tie(64))
    bucket = (torch.arange(4, dtype=torch.int32), ids.repeat(4, 1))
    t0, f0 = pp.pulse_traverse(wald, o, d, [bucket], 100.0, 8)
    data = pp.PulseLadders([bucket], (4, 16))
    assert data.uncovered == (4, 16) and len(data) == 1
    t1, f1 = pp.pulse_traverse(wald, o, d, data, 100.0, 8)
    assert torch.equal(t0, t1) and torch.equal(f0, f1)
    assert bool((f1[32:] == -1).all()) and bool((f1[:32] >= 0).any())
    for bad in ((5, 3), (-1, 4), (4, 17)):
        with pytest.raises(ValueError):
            pp.pulse_traverse(wald, o, d, pp.PulseLadders([bucket], bad),
                              100.0, 8)


@pytest.mark.parametrize("name", ["base", "cg", "min_blocks=8", "no_tests",
                                  "no_rays"])
def test_variant_script_edits_apply(name, monkeypatch):
    """`scripts/k2_variants.py` makes each variant by a text change of K2's
    source: every change still finds its text there."""
    import importlib
    import pathlib
    monkeypatch.syspath_prepend(
        str(pathlib.Path(chip_smoke.__file__).parent / "scripts"))
    mod = importlib.import_module("k2_variants")
    base = open(pp.KERNEL.source).read()
    out = mod.source(name, base)
    assert (out == base) == (name == "base")
