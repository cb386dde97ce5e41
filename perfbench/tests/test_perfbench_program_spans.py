"""The readers of the program's spans (`spans.py`, the ``program_span``
metrics that read `lidar_brdf_tpu_torch.runtime.metrics.recorded`) on a
synthetic record and trace summary, and their None where the program keeps
no record."""

import pytest

from perfbench import core, spans

BASE = 1_790_000_000_000_000_000          # ns: the profiler's Unix clock
MS = 1_000_000
SCAN = ("scan.rays_share", "scan.construct_host_share", "scan.upload_share",
        "scan.prep_wait_share", "scan.unspanned_share")
FIT = ("fit.forward_idle_ms", "fit.backward_idle_ms")


def _survey():
    """One survey in a 1 s window: rays 100 ms; construction 500 ms with
    130 ms of uploads; a run of 380 ms with a 30 ms wait, a 10 ms upload
    and the worker's hash on thread 2."""
    rows = [
        ("lbt.rays", 10, 110, 1, "lbt.simulate"),
        ("lbt.construct.scene", 110, 200, 1, "lbt.construct"),
        ("lbt.upload", 200, 300, 1, "lbt.construct"),
        ("lbt.construct.noise", 300, 320, 1, "lbt.construct"),
        ("lbt.upload", 320, 330, 1, "lbt.construct"),
        ("lbt.construct.wald", 330, 580, 1, "lbt.construct"),
        ("lbt.upload", 580, 600, 1, "lbt.construct"),
        ("lbt.construct", 110, 610, 1, "lbt.simulate"),
        ("lbt.order", 610, 620, 1, "lbt.run"),
        ("lbt.prep_wait", 620, 650, 1, "lbt.run"),
        ("lbt.upload", 650, 660, 1, "lbt.cull"),
        ("lbt.cull.k5", 660, 700, 1, "lbt.cull"),
        ("lbt.cull", 650, 700, 1, "lbt.run"),
        ("lbt.hash", 620, 900, 2, "lbt.run"),
        ("lbt.device", 700, 900, 1, "lbt.run"),
        ("lbt.readback", 900, 990, 1, "lbt.run"),
        ("lbt.run", 610, 990, 1, "lbt.simulate"),
        ("lbt.simulate", 0, 1000, 1, None),
    ]
    return _ordered(rows)


def _ordered(rows):
    """A record of (name, start ms, end ms, thread, parent name) rows,
    listed as they close (children first): a child's parent is the next
    row of its parent's name."""
    from lidar_brdf_tpu_torch.runtime.metrics import Span
    rec = []
    for i, (name, s, e, thread, parent) in enumerate(rows):
        pid = None
        if parent is not None:
            pid = next(j for j in range(i + 1, len(rows))
                       if rows[j][0] == parent) + 1
        rec.append(Span(name, BASE + s * MS, BASE + e * MS, thread, i + 1,
                        pid, len(rows), {}))
    return dict(spans=rec, counts={})


def _steps():
    """Two fit steps of 100 ms: forward 60 ms and backward 30 ms each."""
    rows = []
    for k in (0, 100):
        rows += [("lbt.forward", k, k + 60, 1, "lbt.step"),
                 ("lbt.backward", k + 60, k + 90, 1, "lbt.step"),
                 ("lbt.update", k + 90, k + 100, 1, "lbt.step"),
                 ("lbt.step", k, k + 100, 1, None)]
    return _ordered(rows)


# device intervals (seconds): the first forward busy 40 of its 60 ms, the
# first backward 10 of 30, the second forward all of it, the second
# backward none
KERNELS = [("k", (BASE + a * MS) * 1e-9, (BASE + b * MS) * 1e-9)
           for a, b in ((10, 30), (20, 50), (70, 80), (100, 160))]


def read(name, run):
    return core.metric_reader(name).read(run)


@pytest.mark.parametrize("name, want", [
    ("scan.rays_share", 0.10), ("scan.construct_host_share", 0.37),
    ("scan.upload_share", 0.14), ("scan.prep_wait_share", 0.03),
    ("scan.unspanned_share", 0.02)])
def test_a_survey_reader_reads_the_main_threads_spans(name, want,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "record", _survey)
    assert read(name, dict(window_s=1.0)) == pytest.approx(want)


@pytest.mark.parametrize("name, want", [("fit.forward_idle_ms", 10.0),
                                        ("fit.backward_idle_ms", 25.0)])
def test_a_fit_reader_puts_the_idle_time_in_its_layer(name, want,
                                                      monkeypatch):
    monkeypatch.setattr(spans, "record", _steps)
    run = dict(window_s=0.2, items=2, trace=dict(kernels=KERNELS))
    assert read(name, run) == pytest.approx(want, rel=1e-4)
    assert read(name, dict(run, trace=dict(kernels=[]))) is None


@pytest.mark.parametrize("name", SCAN + FIT)
def test_no_record_reads_none(name, monkeypatch):
    from lidar_brdf_tpu_torch.runtime import metrics
    run = dict(window_s=1.0, items=2, trace=dict(kernels=KERNELS))
    metrics.clear()
    assert read(name, run) is None                   # an empty record
    monkeypatch.delattr(metrics, "recorded")         # no recorder at all
    assert read(name, run) is None


def test_a_span_of_another_layer_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "record", _steps)
    for name in SCAN:
        assert read(name, dict(window_s=1.0)) is None
    monkeypatch.setattr(spans, "record", _survey)
    run = dict(window_s=1.0, items=1, trace=dict(kernels=KERNELS))
    for name in FIT:
        assert read(name, run) is None
