"""The port's spans and counters (`runtime/metrics.py`) on the CPU: nothing
is kept and no profiler range is made with recording off; the span tree of
`api.simulate`, `api.simulate_tls_path` and the fit step (parents and
request ids); spans handed to a worker thread under `torch.profiler`; the
spans on the profiler's clock; the cache counters of a repeat run, with
`run(stats=)`'s keys unchanged; the row scatters' and row gathers' rows
counted; `PipelineMetrics.stage` as a span.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_brdf_tpu_torch import api, bench
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.io import synthetic as tsyn
from lidar_brdf_tpu_torch.io.materials import MaterialLibrary
from lidar_brdf_tpu_torch.runtime import metrics
from lidar_brdf_tpu_torch.runtime.simulate import Simulator

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

STATS_KEYS = {"order_s", "cull_s", "device_s", "readback_s",
              "readback_bytes"}


@pytest.fixture(autouse=True)
def fresh_record():
    metrics.clear()
    yield
    metrics.clear()


def _scene():
    return tsyn.terrain_with_boxes(np.random.default_rng(1234), num_boxes=3)


def _cfg(**kw):
    """A TLS scan of 24 x 8 pulses whose 40 x 30 degree field of view
    culls (narrow beams), in chunks of 64 pulses."""
    return tcfg.SensorConfig(
        tls_position=(0.0, 9.0, 0.0), tls_fov_vertical=30.0,
        tls_middle_angle_vertical=-40.0, tls_fov_horizontal=40.0,
        tls_resolution_horizontal=24, tls_resolution_vertical=8,
        rays_per_pulse=2, max_returns=1, chunk_pulses=64, **kw)


def _tree(spans):
    """{parent name: set of child names} and {span id: span}."""
    by_id = {s.id: s for s in spans}
    tree = {}
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        tree.setdefault(parent, set()).add(s.name)
    return tree, by_id


def _simulate(tmp_path):
    scene = _scene()
    with metrics.recording():
        api.simulate(scene, _cfg(), device="cpu")


def _path(tmp_path):
    scene = _scene()
    with metrics.recording():
        api.simulate_tls_path(scene, _cfg(), np.array(
            [[0.0, 9.0, 0.0], [2.0, 9.0, 1.0]], np.float32),
            out_dir=str(tmp_path), device="cpu")


def _step(tmp_path):
    scene, bvh, cfg, rays, mats = bench.build_workload(
        "tls", 512, 10, 2, "city", 2000)
    ws = bench.cull(scene, bvh, cfg, rays, mats, "tile", "cpu")
    step, _ = bench.make_step(ws, "full")
    with metrics.recording():
        step()
        step()


RUN = {"lbt.order", "lbt.prep_wait", "lbt.cull", "lbt.device",
       "lbt.readback"}
SCAN = {"lbt.construct": {"lbt.construct.scene", "lbt.construct.noise",
                          "lbt.construct.wald"},
        "lbt.run": RUN, "lbt.cull": {"lbt.cull.k5"},
        "lbt.device": {"lbt.returns", "lbt.shade", "lbt.cloud"},
        "lbt.returns": {"lbt.traverse"}}
TREES = {
    _simulate: {**SCAN, None: {"lbt.simulate"},
                "lbt.simulate": {"lbt.rays", "lbt.construct", "lbt.run"}},
    _path: {**SCAN, None: {"lbt.path"},
            "lbt.path": {"lbt.rays", "lbt.construct", "lbt.run",
                         "lbt.ply_write"}},
    _step: {None: {"lbt.step"},
            "lbt.step": {"lbt.forward", "lbt.backward", "lbt.update"},
            "lbt.forward": {"lbt.returns", "lbt.shade", "lbt.cloud",
                            "lbt.loss"},
            "lbt.returns": {"lbt.traverse"}},
}
ROOTS = {_simulate: 1, _path: 1, _step: 2}


@pytest.mark.parametrize("entry", list(TREES), ids=lambda f: f.__name__)
def test_spans_nest_by_parent_and_share_the_request_id(entry, tmp_path):
    """Each entry's spans form the documented tree; every span carries its
    root's id as the request id (one per call, one per fit step); the
    PLY writer's spans run on their own thread under ``lbt.path``."""
    entry(tmp_path)
    spans = metrics.recorded()["spans"]
    tree, by_id = _tree(spans)
    want = TREES[entry]
    assert {k: tree.get(k, set()) for k in want} == want
    assert set(tree) <= set(want) | {"lbt.upload"}
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == ROOTS[entry]
    for s in spans:
        root = s
        while root.parent is not None:
            root = by_id[root.parent]
        assert s.request == root.id
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            if s.thread == p.thread:
                assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    main = threading.get_ident()
    for s in spans:
        assert (s.thread != main) == (s.name == "lbt.ply_write"), s.name


def test_recording_off_keeps_nothing_and_makes_no_range(monkeypatch):
    """Off, a span is one check: no range, no record, no counter; a timed
    span still gives its seconds."""
    made = []
    real = metrics.record_function
    monkeypatch.setattr(metrics, "record_function",
                        lambda name: made.append(name) or real(name))
    with metrics.span("lbt.x", bytes=4) as s:
        metrics.count("rays", 3)
    with metrics.span("lbt.y", timed=True) as t:
        pass
    assert t.seconds >= 0.0 and not hasattr(s, "seconds")
    assert metrics.upload(torch.ones(4), "meta").device.type == "meta"
    api.simulate(_scene(), _cfg(), device="cpu")
    assert made == []
    assert metrics.recorded() == dict(spans=[], counts={})
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("lbt.z"):
            pass
    assert made == ["lbt.z"]
    assert [s.name for s in metrics.recorded()["spans"]] == ["lbt.z"]


def test_an_upload_is_a_span_with_its_bytes():
    with metrics.recording():
        out = metrics.upload(dict(a=torch.ones(4), b=torch.ones(2, 3)),
                             "meta")
        metrics.upload(torch.ones(8), "cpu")        # no copy, no span
    assert {k: v.device.type for k, v in out.items()} == dict(a="meta",
                                                              b="meta")
    rec = metrics.recorded()
    (s,) = rec["spans"]
    assert s.name == "lbt.upload"
    assert s.attrs == dict(bytes=40, pinned=False)
    assert rec["counts"] == dict(upload_bytes_pageable=40)


def test_worker_spans_under_the_profiler_keep_their_parent():
    """Under `torch.profiler` a worker thread is not profiled; a span
    there, handed the state by `carried`, is kept with the main thread's
    open span as parent, and the pulse path's chunk hashes are kept under
    their run."""
    seen = []

    def work():
        seen.append(metrics._profiler_enabled())
        with metrics.span("lbt.hash"):
            pass
    scene = _scene()
    sim = Simulator(scene=scene, bvh=api.build_scene_bvh(scene),
                    materials=MaterialLibrary.default().table_at(1064),
                    cfg=_cfg(), device="cpu", use_pulse=True)
    rays = api.build_rays(_cfg(), scene, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("lbt.outer") as outer:
            with ThreadPoolExecutor(max_workers=1) as pool:
                pool.submit(metrics.carried(work)).result()
        sim.run(rays)
    assert seen == [False]
    spans = metrics.recorded()["spans"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (mine,) = [s for s in by_name["lbt.hash"] if s.parent == outer.id]
    assert mine.thread != threading.get_ident()
    assert mine.request == outer.id
    (run,) = by_name["lbt.run"]
    hashes = [s for s in by_name["lbt.hash"] if s.parent == run.id]
    assert len(hashes) == len(by_name["lbt.cull"]) == 3
    assert all(s.thread != run.thread for s in hashes)
    assert metrics.recorded()["counts"]["hashed_bytes"] > 0


def test_spans_lie_on_the_profilers_clock():
    """Each main-thread span starts and ends within 0.5 ms of its
    `record_function` event in the profiler's own events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        api.simulate(_scene(), _cfg(), device="cpu")
    main = threading.get_ident()
    spans = [s for s in metrics.recorded()["spans"] if s.thread == main]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("lbt."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert len(spans) > 20
    by_name = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        by_name.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert set(by_name) == set(events)
    for name, mine in by_name.items():
        theirs = sorted(events[name])
        assert len(theirs) == len(mine), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 500_000 and abs(e0 - e1) < 500_000, name


@pytest.mark.parametrize("use_pulse", [False, True])
def test_a_repeat_run_counts_ladder_cache_hits(use_pulse):
    """Through one `Simulator`, the first run misses the ladder cache on
    every chunk and the second hits it on every chunk (with the BSP order
    cached on the tile path); ``stats`` keeps its keys."""
    scene = _scene()
    sim = Simulator(scene=scene, bvh=api.build_scene_bvh(scene),
                    materials=MaterialLibrary.default().table_at(1064),
                    cfg=_cfg(), device="cpu", use_pulse=use_pulse)
    rays = api.build_rays(_cfg(), scene, device="cpu")
    counts, all_stats = [], []
    for _ in range(2):
        metrics.clear()
        stats = {}
        with metrics.recording():
            sim.run(rays, stats=stats)
        counts.append(metrics.recorded()["counts"])
        all_stats.append(stats)
    first, second = counts
    chunks = first["chunks"]
    assert chunks == 3 and first["rays"] == 24 * 8 * 2
    assert first["ladder_cache_misses"] == chunks
    assert "ladder_cache_hits" not in first
    assert second["ladder_cache_hits"] == chunks
    assert "ladder_cache_misses" not in second
    assert first["pairs"] > 0 and "pairs" not in second
    if use_pulse:
        assert first["hashed_bytes"] == second["hashed_bytes"] > 0
    else:
        assert first["bsp_cache_misses"] == second["bsp_cache_hits"] == 1
    for stats, c in zip(all_stats, counts):
        assert set(stats) == STATS_KEYS
        assert stats["readback_bytes"] == c["readback_bytes"] > 0
        assert all(stats[k] >= 0.0 for k in STATS_KEYS)


def test_row_scatters_are_counted_in_a_fit_step_and_not_in_a_scan(tmp_path):
    """Each backward of a row gather adds its gathered rows to
    ``row_scatter_rows``: two recorded fit steps (L = 2, 512 pulses, no
    face pack) scatter the winner rows and the corner vertices, 4 x 1,024
    rows a step; a recorded scan has no backward and counts none."""
    _step(tmp_path)
    assert metrics.recorded()["counts"]["row_scatter_rows"] == 2 * 4 * 1024
    metrics.clear()
    _simulate(tmp_path)
    counts = metrics.recorded()["counts"]
    assert counts["chunks"] > 0 and "row_scatter_rows" not in counts


def _gather_rows(pulses: int, rays: int, levels: int) -> int:
    """Rows the unpacked return extraction gathers through `row_gather`
    (`physics/returns.py::_returns_noretraverse`): at each level the
    winner rays (P), their face rows (P), corner vertices (3 P) and ks/ns
    (P), every ray's face rows (P R) and the winners' again for the merge
    (P), and the winners' noise rows (P); then over the K = L P record
    slots the winner rays (K), their face rows (K), corner vertices (3 K),
    uvs (3 K), ks/ns (K), noise rows (K) and outlier noise rows (K)."""
    K = levels * pulses
    return levels * pulses * (rays + 8) + 11 * K


def test_row_gathers_are_counted_in_a_fit_step_and_a_scan(tmp_path):
    """Each `row_gather` call adds its rows to ``row_gather_rows``: two
    recorded fit steps (L = 2, 512 pulses of 10 rays, no face pack) and a
    recorded scan (3 chunks of 64 pulses of 2 rays, L = 1) count the rows
    their call sites gather."""
    _step(tmp_path)
    assert metrics.recorded()["counts"]["row_gather_rows"] == \
        2 * _gather_rows(512, 10, 2)
    metrics.clear()
    _simulate(tmp_path)
    counts = metrics.recorded()["counts"]
    assert counts["chunks"] == 3
    assert counts["row_gather_rows"] == 3 * _gather_rows(64, 2, 1)


def test_a_pipeline_stage_is_a_span():
    m = metrics.PipelineMetrics()
    with metrics.recording():
        with m.stage("TRAVERSE", sync=torch.zeros(2)):
            with metrics.span("lbt.inner"):
                pass
    inner, stage = metrics.recorded()["spans"]
    assert (stage.name, inner.name) == ("TRAVERSE", "lbt.inner")
    assert inner.parent == stage.id
    assert m.samples["TRAVERSE"] == [pytest.approx(
        (stage.end_ns - stage.start_ns) * 1e-9)]
