"""K1's one-launch work list and its staged walk, on the CPU.

The tile kernel (`kernels/csrc/tile_traverse.cu`) runs every bucket of a
call in one launch over the blocks `tile_schedule` lays out, four units of
128 rays a block, and walks each ray's candidates in stages of 128 with
two exits on the blocks' lower distance bounds: a ray stops at the first
block whose bound exceeds its best t, and a unit stops at a stage whose
first bound exceeds the best t of all its rays.  The kernel runs only on
the card (`tests/test_torch_cuda.py` holds it against the plain version
there); here the schedule is decoded block by block as the kernel decodes
it, and the staged walk with its exits is held against the serial walk of
`wald_blocks_plain`, which has no exit.  Results are compared exactly.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu_torch.kernels import traverse as tr

# (rows, candidates, real rows) of the `tls` workload's 131,072-pulse chunk
# (2,048 tiles of 640 rays), as the host cull buckets it
TLS_BUCKETS = [(1024, 8, 996), (512, 16, 323), (256, 32, 192),
               (256, 64, 137), (64, 128, 43), (64, 256, 57), (128, 512, 76),
               (128, 1024, 91)]
TLS_TILES = 2048
STAGE_BLOCKS = 16      # blocks of 8 in one of K1's 128-candidate stages


def _tls_like_buckets(rng, n_tiles, order):
    """Buckets of the tls chunk's shapes, plus an empty one, in the given
    order: real rows first, each a distinct tile; dummy rows (tidx ==
    n_tiles) after."""
    tiles = rng.permutation(n_tiles)
    shapes = TLS_BUCKETS[:4] + [(0, 8, 0)] + TLS_BUCKETS[4:]
    buckets, at = [], 0
    for j in order(len(shapes)):
        B, C, real = shapes[j]
        tidx = np.full(B, n_tiles, np.int32)
        tidx[:real] = tiles[at:at + real]
        at += real
        buckets.append((torch.from_numpy(tidx),
                        torch.full((B, C), -1, dtype=torch.int32),
                        torch.zeros((B, C // 8))))
    return buckets, tiles[at:]


def _units(entries, block):
    """The kernel's decode: (entry, unit) of each group of a block."""
    k = 0
    while k + 1 < len(entries) and block >= entries[k + 1][3]:
        k += 1
    return [(entries[k], (block - entries[k][3]) * tr.GROUPS + group)
            for group in range(tr.GROUPS)]


ORDERS = {"as culled": lambda n: range(n),
          "reversed": lambda n: reversed(range(n)),
          "shuffled": lambda n: np.random.default_rng(5).permutation(n)}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("tile_rays", [128, 640, 1280])
def test_schedule_covers_every_real_ray_once(tile_rays, order):
    rng = np.random.default_rng(tile_rays)
    buckets, untouched = _tls_like_buckets(rng, TLS_TILES, ORDERS[order])
    entries, n_blocks = tr.tile_schedule(buckets, tile_rays)
    # longest lists first, the empty bucket dropped, blocks laid end to end
    assert [e[2] for e in entries] == [1024, 512, 256, 128, 64, 32, 16, 8]
    assert all(buckets[e[0]][1].shape == (e[1], e[2]) for e in entries)
    first = 0
    for i, B, C, first_block, per_row in entries:
        assert first_block == first
        assert per_row * tr.LANES == tile_rays
        first += -(-B * per_row // tr.GROUPS)
    assert n_blocks == first
    cover = np.zeros((TLS_TILES, tile_rays), np.int64)
    writes = 0
    for block in range(n_blocks):
        for (i, B, C, _, per_row), unit in _units(entries, block):
            if unit >= B * per_row:      # past the bucket's last unit
                continue
            row, sub = divmod(unit, per_row)
            tile = int(buckets[i][0][row])
            if tile == TLS_TILES:        # dummy row: returns, writes nothing
                continue
            cover[tile, sub * tr.LANES:(sub + 1) * tr.LANES] += 1
            writes += tr.LANES
    real = sum(r for _, _, r in TLS_BUCKETS)
    assert writes == real * tile_rays
    assert (cover[np.setdiff1d(np.arange(TLS_TILES), untouched)] == 1).all()
    assert (cover[untouched] == 0).all()


def test_schedule_keeps_input_order_among_equal_lengths():
    i32 = dict(dtype=torch.int32)
    b = [(torch.zeros(n, **i32), torch.zeros((n, C), **i32),
          torch.zeros((n, C // 8))) for n, C in ((3, 16), (5, 64), (6, 16))]
    entries, n_blocks = tr.tile_schedule(b, 256)
    assert [e[0] for e in entries] == [1, 0, 2]
    assert [e[3] for e in entries] == [0, 3, 5] and n_blocks == 8


def test_schedule_of_a_call_without_rows():
    i32 = dict(dtype=torch.int32)
    empty = (torch.zeros(0, **i32), torch.zeros((0, 8), **i32),
             torch.zeros((0, 1)))
    assert tr.tile_schedule([], 640) == ((), 0)
    assert tr.tile_schedule([empty, empty], 640) == ((), 0)


def _tie_scene(n_cand, seed):
    """`chip_smoke.planted_tie` as tensors shaped for `wald_blocks_plain`:
    face 40 in block 1 and the coincident face 12 in block 6."""
    wald, o, d, ids = chip_smoke.planted_tie(n_cand, seed)
    return (torch.from_numpy(wald), torch.from_numpy(o)[None, :, None, :],
            torch.from_numpy(d)[None, :, None, :], torch.from_numpy(ids)[None])


def _walk(wald, o, d, ids, tm):
    t0 = tm.expand(1, o.shape[1]).clone()
    return tr.wald_blocks_plain(wald, o, d, ids, tm, t0,
                                torch.full_like(t0, -1, dtype=torch.int32))


def _block_bounds(wald, o, d, ids, tm, kind):
    """Lower distance bounds of a list's blocks for all rays of the tile:
    0 everywhere, or each block's nearest hit over the rays (inf where no
    ray hits it before ``tm``), made a monotone prefix as
    `TileTraverser.bucket_bounds` makes it, then lowered by 0.5 for
    "loose"."""
    n_blk = ids.shape[1] // tr.CAND_BLOCK
    if kind == "zero":
        return torch.zeros(n_blk)
    near = []
    for blk in range(n_blk):
        t_c, f_c = _walk(wald, o, d, ids[:, 8 * blk:8 * blk + 8], tm)
        near.append(float(t_c[f_c >= 0].min()) if bool((f_c >= 0).any())
                    else float("inf"))
    bnd = np.minimum.accumulate(np.array(near)[::-1])[::-1]
    return torch.from_numpy(bnd - (0.5 if kind == "loose" else 0.0)).float()


def _staged_walk(wald, o, d, ids, bnd, tm):
    """One unit's walk as `tile_traverse_kernel` runs it, for all its rays
    at once.  Returns (t, face, (ray, block) pairs tested)."""
    n_blk = ids.shape[1] // tr.CAND_BLOCK
    t = tm.expand(1, o.shape[1]).clone()
    f = torch.full_like(t, -1, dtype=torch.int32)
    done = torch.zeros_like(t, dtype=torch.bool)
    tested = 0
    for ch in range(0, n_blk, STAGE_BLOCKS):
        if not bool((~done & ~(bnd[ch] > t)).any()):
            break                        # no ray of the unit is live
        for blk in range(ch, min(ch + STAGE_BLOCKS, n_blk)):
            done |= bnd[blk] > t         # the bounds only grow from here
            t_c, f_c = _walk(wald, o, d, ids[:, 8 * blk:8 * blk + 8], tm)
            better = ~done & (t_c < t)
            t = torch.where(better, t_c, t)
            f = torch.where(better, f_c, f)
            tested += int((~done).sum())
    return t, f, tested


@pytest.mark.parametrize("bounds", ["zero", "exact", "loose"])
@pytest.mark.parametrize("n_cand", [64, 128, 1024, 4096])
def test_staged_walk_equals_serial_walk(n_cand, bounds):
    """The kernel's exits skip only blocks that cannot win: its staged walk
    gives the serial walk's (t, face) bit for bit, the planted tie
    included (the earlier block, face 40, wins though its id is larger).
    Real bounds make it test fewer pairs: exact ones always, loose ones
    where padding follows the 64 real candidates."""
    wald, o, d, ids = _tie_scene(n_cand, n_cand)
    tm = torch.tensor(100.0)
    t_ser, f_ser = _walk(wald, o, d, ids, tm)
    assert int((f_ser == 40).sum()) > 10 and not bool((f_ser == 12).any())
    bnd = _block_bounds(wald, o, d, ids, tm, bounds)
    t, f, tested = _staged_walk(wald, o, d, ids, bnd, tm)
    assert torch.equal(f, f_ser)
    assert torch.equal(t, t_ser)
    every = o.shape[1] * (n_cand // tr.CAND_BLOCK)
    if bounds == "zero":
        assert tested == every
    elif bounds == "exact" or n_cand > 64:
        assert tested < every


@pytest.mark.parametrize("n_cand", [128, 512, 1024])
def test_planted_tie_through_tile_traverse(n_cand):
    """The bucket `tests/test_torch_cuda.py` runs through K1, here through
    the wrapper's CPU path: the serial walk's faces, face 40 where the
    coincident pair is nearest."""
    wald, o, d, ids = (torch.from_numpy(a)
                       for a in chip_smoke.planted_tie(n_cand))
    bucket = (torch.zeros(1, dtype=torch.int32), ids[None],
              torch.zeros((1, n_cand // 8)))
    t, f = tr.tile_traverse(wald, o, d, [bucket], 100.0, 128)
    tm = torch.tensor(100.0)
    t_ser, f_ser = _walk(wald, o[None, :, None], d[None, :, None], ids[None],
                         tm)
    assert torch.equal(f, f_ser[0])
    assert int((f == 40).sum()) > 10 and not bool((f == 12).any())
    hit = f >= 0
    assert torch.equal(t[hit], t_ser[0][hit])
