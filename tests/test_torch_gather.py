"""The forward row gathers (`kernels/gather.py::row_gather`, K7 on the
card): ``src[idx]`` bit for bit for f32 and int32 sources of several
widths, 1-D, 2-D and empty indices holding the last row; the wrapper's
refusals; `physics/rows.py::gather_rows` and `utils/noise.py::stream_rows`
on it where the input allows.  The `cuda` cases hold K7 to ``src[idx]`` on
the card (`chip_smoke.py` phase 17's cases, the terrain step's shapes
among them), one launch a call, and the return extraction's records bit
for bit with and without it.
"""

import pytest
import torch

import chip_smoke
from lidar_brdf_tpu_torch import bench
from lidar_brdf_tpu_torch.kernels import gather
from lidar_brdf_tpu_torch.physics import rows as prows
from lidar_brdf_tpu_torch.physics.returns import simulate_returns
from lidar_brdf_tpu_torch.runtime import metrics
from lidar_brdf_tpu_torch.utils import noise

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _source(dtype, rows, cols, gen):
    if dtype is torch.float32:
        return torch.randn((rows, cols), generator=gen)
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, cols), generator=gen,
                         dtype=torch.int32)


def _index(kind, rows, gen):
    if kind == "empty":
        return torch.zeros(0, dtype=torch.int64)
    shape = (517,) if kind == "1-D" else (61, 7)
    idx = torch.randint(0, rows, shape, generator=gen)
    idx.view(-1)[-1] = rows - 1
    return idx


@pytest.mark.parametrize("kind", ["1-D", "2-D", "empty"])
@pytest.mark.parametrize("cols", [1, 2, 3, 4, 6, 16, 23])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32],
                         ids=["f32", "i32"])
def test_row_gather_is_plain_indexing(dtype, cols, kind):
    """On the CPU `row_gather` is ``src[idx]``: same shape, same bits."""
    gen = torch.Generator().manual_seed(cols)
    src = _source(dtype, 300 + cols, cols, gen)
    idx = _index(kind, src.shape[0], gen)
    got = gather.row_gather(src, idx)
    want = src[idx]
    assert got.shape == tuple(idx.shape) + (cols,) and got.dtype is dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", ["f64 src", "i64 src", "i16 src",
                                  "i32 idx", "1-D src", "3-D src",
                                  "strided src", "idx on another device"])
def test_row_gather_refuses(case):
    """A source of another dtype or rank, a non-contiguous source, an
    index that is not int64 or lies on another device: ValueError."""
    src, idx = torch.randn(20, 4), torch.tensor([0, 19, 3])
    src, idx = {
        "f64 src": (src.double(), idx),
        "i64 src": (src.long(), idx),
        "i16 src": (src.to(torch.int16), idx),
        "i32 idx": (src, idx.int()),
        "1-D src": (src.reshape(-1), idx),
        "3-D src": (src.reshape(20, 2, 2), idx),
        "strided src": (torch.randn(4, 20).t(), idx),
        "idx on another device": (src, idx.to("meta")),
    }[case]
    with pytest.raises(ValueError):
        gather.row_gather(src, idx)
    assert not gather.gathers_rows(src, idx)


def test_row_gather_counts_its_rows():
    """``row_gather_rows`` grows by the rows of each call while recording
    is on, and not otherwise."""
    metrics.clear()
    src = torch.randn(10, 4)
    gather.row_gather(src, torch.tensor([1, 2]))
    assert "row_gather_rows" not in metrics.recorded()["counts"]
    with metrics.recording():
        gather.row_gather(src, torch.zeros((3, 5), dtype=torch.int64))
        gather.row_gather(src, torch.tensor([9]))
    assert metrics.recorded()["counts"]["row_gather_rows"] == 16
    metrics.clear()


def _spy(monkeypatch):
    calls = []
    real = gather.row_gather

    def spy(src, idx):
        calls.append((src.dtype, tuple(src.shape), tuple(idx.shape)))
        return real(src, idx)

    monkeypatch.setattr(gather, "row_gather", spy)
    return calls


def test_gather_rows_takes_row_gather_where_the_input_allows(monkeypatch):
    """`gather_rows` reaches `row_gather` for a contiguous 2-D f32 or int32
    source, with or without a gradient, and keeps ``src[idx]`` for a
    float64 or a strided source; `stream_rows` reads 16-column rows of an
    f32 buffer and indexes a float64 one."""
    calls = _spy(monkeypatch)
    idx = torch.tensor([[0, 3], [2, 2]])
    f = torch.randn(4, 3)
    leaf = f.clone().requires_grad_(True)
    for src in (f, f.int(), leaf, f.double(), torch.randn(3, 4).t()):
        out = prows.gather_rows(src, idx)
        assert torch.equal(out.detach(), src.detach()[idx])
    assert [c[0] for c in calls] == [torch.float32, torch.int32,
                                     torch.float32]
    buf = noise.make_sim_noise(3, size=1000)
    rows = noise.stream_rows(buf, torch.tensor([5, 2 ** 32 - 1]))
    assert calls[-1] == (torch.float32, (62, 16), (2,))
    assert torch.equal(rows[1], buf[:992].view(62, 16)[(2 ** 32 - 1) % 62])
    assert torch.equal(noise.stream_rows(buf.double(), torch.tensor([5])),
                       rows[:1].double()) and len(calls) == 4


@pytest.mark.cuda
def test_row_gather_on_the_card_is_plain_indexing(monkeypatch):
    """K7 bit-equal to ``src[idx]`` on every case of `chip_smoke.py`
    phase 17 (every width of both dtypes, 1-D, 2-D and empty indices, an
    unaligned source view, the terrain step's shapes), one launch a call
    and none for an empty index."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    monkeypatch.setattr(chip_smoke, "DEVICE", "cuda")
    for name, (src, idx) in chip_smoke.gather_cases().items():
        assert src.is_cuda and idx.is_cuda
        before = gather.KERNEL.launches
        got = gather.row_gather(src, idx)
        torch.cuda.synchronize()
        assert gather.KERNEL.launches == before + (
            gather.LAUNCHES if idx.numel() else 0), name
        want = src[idx]
        assert got.shape == want.shape, name
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name


def _returns_with_and_without_k7(monkeypatch, workload, scene, faces,
                                  traverser):
    """`simulate_returns` on the card for a small bench workload, with K7
    and with every gather on ``src[idx]``: records, outliers and counts
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    built = bench.build_workload(workload, 512, 10, 2, scene, faces)
    ws = bench.cull(*built, traverser, "cuda")

    def run():
        return simulate_returns(ws.scene, ws.materials, ws.rays, ws.noise,
                                ws.scalars, ws.cfg, scene_has_water=False,
                                traverse_fn=ws.traverser,
                                traverse_data=ws.data)

    before = gather.KERNEL.launches
    with_k7 = run()
    torch.cuda.synchronize()
    assert gather.KERNEL.launches > before
    monkeypatch.setattr(gather, "row_gather", gather.row_gather_plain)
    before = gather.KERNEL.launches
    plain = run()
    assert gather.KERNEL.launches == before
    records, outliers, count, _ = with_k7
    p_records, p_outliers, p_count, _ = plain
    assert torch.equal(count, p_count)
    for a, b in ((records, p_records), (outliers, p_outliers)):
        for field in type(a).__dataclass_fields__:
            x, y = getattr(a, field), getattr(b, field)
            assert torch.equal(x, y) or (
                x.is_floating_point() and torch.equal(
                    x.view(torch.int32), y.view(torch.int32))), field


@pytest.mark.cuda
def test_unpacked_returns_on_the_card_are_those_of_plain_indexing(
        monkeypatch):
    """`simulate_returns` on a small unpacked terrain (2,000 faces, 512
    pulses, L = 2) gives bit-equal records, outliers and counts with K7
    and with every gather on ``src[idx]``."""
    _returns_with_and_without_k7(monkeypatch, "als", "terrain", 2000,
                                 "pulse")


@pytest.mark.cuda
def test_packed_returns_on_the_card_are_those_of_plain_indexing(
        monkeypatch):
    """The same on a small city (1,000 faces, 512 pulses, L = 2), whose
    faces are packed (`returns.packs_faces`)."""
    _returns_with_and_without_k7(monkeypatch, "alphaprime", "city", 1000,
                                 "tile")
