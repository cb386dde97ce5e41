"""Row gathers with a sort-free backward (`physics/rows.py::RowGather`,
`kernels/scatter.py::row_scatter_add`): the forward is ``src[idx]`` bit for
bit; the backward sums each source row's cotangents as autograd's own
backward of ``src[idx]`` does, within n * 2^-23 * sum |g| a cell (two
orders of n f32 additions), against a float64 sum; a source that takes no
part in a gradient makes no Function node; the record pass's steps
(packed and unpacked) build no autograd index backward and count the
rows they scatter.  The `cuda` case holds the row scatter (K6 over the
flat cells ``row * C + col``) against its plain version on the card, an
all-colliding index included.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu_torch import bench
from lidar_brdf_tpu_torch.kernels import scatter
from lidar_brdf_tpu_torch.physics.rows import RowGather, gather_rows
from lidar_brdf_tpu_torch.runtime import metrics

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _within_bound(got, idx, g, rows):
    """``got`` (rows, C) against the float64 sum of the rows of ``g`` at
    ``idx``: every cell within count_r * 2^-23 * sum_r |g|, or NaN in
    both."""
    i = idx.reshape(-1).numpy()
    g64 = g.reshape(i.size, g.shape[-1]).double().numpy()
    want = np.zeros((rows, g64.shape[1]))
    mag = np.zeros_like(want)
    np.add.at(want, i, g64)
    np.add.at(mag, i, np.abs(g64))
    count = np.bincount(i, minlength=rows)[:, None]
    got = got.double().numpy()
    err = np.abs(got - want)
    ok = (err <= count * 2.0 ** -23 * mag) | (np.isnan(got) & np.isnan(want))
    assert ok.all(), float(np.nanmax(err))


def _index_cases():
    gen = torch.Generator().manual_seed(23)
    return {
        "unique": (torch.randperm(400, generator=gen)[:300], 400),
        "one row": (torch.full((517,), 7, dtype=torch.int64), 40),
        "colliding": (torch.randint(0, 30, (1000,), generator=gen), 30),
        "empty": (torch.zeros(0, dtype=torch.int64), 12),
        "2-D index": (torch.randint(0, 50, (333, 3), generator=gen), 50),
    }


@pytest.mark.parametrize("cols", [3, 6, 23])
@pytest.mark.parametrize("case", list(_index_cases()))
def test_row_gather_matches_autograd_indexing(case, cols):
    """Forward bit-equal to ``src[idx]``; backward within the scatter
    bound of autograd's backward of plain indexing and of float64."""
    idx, rows = _index_cases()[case]
    gen = torch.Generator().manual_seed(cols)
    base = torch.randn((rows, cols), generator=gen)
    cot = torch.randn(tuple(idx.shape) + (cols,), generator=gen)
    src = base.clone().requires_grad_(True)
    out = gather_rows(src, idx)
    assert type(out.grad_fn).__name__ == "RowGatherBackward"
    assert torch.equal(out, base[idx])
    out.backward(cot)
    ref = base.clone().requires_grad_(True)
    ref[idx].backward(cot)
    _within_bound(src.grad, idx, cot, rows)
    _within_bound(ref.grad, idx, cot, rows)
    assert src.grad.shape == (rows, cols)


@pytest.mark.parametrize("levels", [1, 2])
def test_winner_rows_sum_the_levels(levels):
    """Winner rows ``p * R + w`` of L levels: a ray that wins at both
    levels gets both levels' cotangents, as the JAX package's dense
    compare-select over the R rays of a pulse (`_winner_rows_pr_bwd`)."""
    P, R, C = 64, 10, 6
    gen = torch.Generator().manual_seed(levels)
    w = torch.randint(0, R, (levels, P), generator=gen)
    if levels == 2:
        w[1, :8] = w[0, :8]              # these rays win at both levels
    flat = (torch.arange(P) * R + w).reshape(-1)
    cat = torch.randn((P * R, C), generator=gen, requires_grad=True)
    cot = torch.randn((levels * P, C), generator=gen)
    gather_rows(cat, flat).backward(cot)
    dense = chip_smoke.winner_rows_dense(flat, cot, (levels, P, R))
    torch.testing.assert_close(cat.grad, dense, rtol=0,
                               atol=levels * 2.0 ** -23 * float(
                                   cot.abs().max()))
    _within_bound(cat.grad, flat, cot, P * R)
    if levels == 2:
        both = torch.arange(8) * R + w[0, :8]
        assert torch.equal(cat.grad[both] != 0,
                           (cot[:8] + cot[P:P + 8]) != 0)


def test_no_function_node_without_a_gradient():
    """A source that does not require grad, or a gather under no_grad, is
    plain indexing: no `RowGather` node, the same values."""
    src = torch.randn(20, 4)
    idx = torch.tensor([3, 3, 19, 0])
    out = gather_rows(src, idx)
    assert out.grad_fn is None and torch.equal(out, src[idx])
    leaf = src.clone().requires_grad_(True)
    with torch.no_grad():
        out = gather_rows(leaf, idx)
    assert out.grad_fn is None and torch.equal(out, src[idx])


def test_row_scatter_counts_its_rows():
    """One backward adds the gathered rows to ``row_scatter_rows`` while
    recording is on, and nothing while it is off."""
    metrics.clear()
    src = torch.randn(10, 3, requires_grad=True)
    idx = torch.tensor([[1, 2, 2], [9, 0, 1]])
    gather_rows(src, idx).sum().backward()
    assert "row_scatter_rows" not in metrics.recorded()["counts"]
    with metrics.recording():
        RowGather.apply(src, idx).sum().backward()
    assert metrics.recorded()["counts"]["row_scatter_rows"] == 6
    metrics.clear()


def _graph_nodes(t) -> dict:
    """{node class name: count} of the autograd graph behind ``t``."""
    seen, out, stack = set(), {}, [t.grad_fn]
    while stack:
        n = stack.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        name = type(n).__name__
        out[name] = out.get(name, 0) + 1
        stack.extend(f for f, _ in n.next_functions)
    return out


@pytest.mark.parametrize("config,tris,pulses,scatters",
                         [("tls", 2000, 512, 2), ("tls", 2000, 1024, 3),
                          ("als", 2000, 512, 2)],
                         ids=["tile unpacked", "tile packed", "pulse"])
def test_step_has_no_index_backward(config, tris, pulses, scatters):
    """The bench's full step (L = 2): no autograd index backward in its
    graph; one `RowGather` for the winner rows and one (corner vertices)
    or two (the face pack's build and rows) for the vertices."""
    scene, bvh, cfg, rays, mats = bench.build_workload(
        config, pulses, 10, 2, "city" if config == "tls" else "terrain",
        tris)
    ws = bench.cull(scene, bvh, cfg, rays, mats,
                    "tile" if config == "tls" else "pulse", "cpu")
    assert chip_smoke.row_scatters(ws, "full") == scatters
    loss = bench.step_loss(ws, bench.leaf_params(ws))
    nodes = _graph_nodes(loss)
    assert not [k for k in nodes if k.startswith("Index")], nodes
    assert nodes["RowGatherBackward"] == scatters


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform 23", "one row 23", "unique 6",
                                  "4099 x 3", "0 x 23", "masked slots"])
def test_row_scatter_on_the_card_matches_plain(monkeypatch, case):
    """`row_scatter_add` on the card against its plain version on
    `chip_smoke.py` phase 16's cases: within count_r * 2^-23 * sum_r |g|
    a cell, NaN at the same cells, one K6 launch a call (none for N =
    0)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")
    monkeypatch.setattr(chip_smoke, "ROW_ROWS", 1 << 16)
    idx, g, rows, _ = chip_smoke.row_cases({})[case]
    assert idx.is_cuda and g.is_cuda
    before = scatter.KERNEL.launches
    got = scatter.row_scatter_add(idx, g, rows)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches == before + (1 if g.shape[0] else 0)
    want = scatter.row_scatter_add(idx.cpu(), g.cpu(), rows)   # plain
    assert torch.equal(got.isnan().cpu(), want.isnan())
    _within_bound(got.cpu(), idx.cpu(), g.cpu(), rows)
