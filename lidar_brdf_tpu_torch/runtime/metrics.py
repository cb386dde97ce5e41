"""Stage timing, and the program's spans and counters (counterpart of
`lidar_brdf_tpu/runtime/metrics.py`).

The reference brackets its pipeline stages with chrono timers and reports
mean +/- std over `numExecs` runs with optional first-run discard
(`Utilities/PipelineMetrics.{h,cpp}`, `LiDARSimulation.cpp:292-365`).  Here
a stage is a host-clock bracket that, given the stage's output tensors,
waits for the card to finish them before it stops the clock; plus the same
aggregation and text export, and a `torch.profiler` trace hook.

Spans and counters.  ``with span("lbt.cull"):`` brackets one layer's work
and ``count("rays", n)`` adds to a counter, at the layer boundaries of
`api.simulate`, `Simulator.run`, `api.simulate_tls_path` and the fit step
(`bench.make_step`).  A finished span holds its name, start and end in
`time.time_ns` (the clock of `torch.profiler`'s host events), its thread,
the id of its parent span and a request id, which every span of one
`api.simulate` call, `Simulator.run`, path or fit step shares.  Recording
is on while a `torch.profiler` profiles the thread that opens the
outermost span, or inside `recording()`; then each span on a profiled
thread is also a `record_function` range (the ``lbt.*`` ranges of a
profiler trace), and every span, on any thread, is kept in memory until
`clear()`: `recorded()` gives the spans and the counter totals.  Work
handed to another thread keeps the state through `carried`.  Off, a span
or a counter costs one check: no clock read, no range, nothing kept.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

# whether a profiler sees the calling thread (False on a worker thread of a
# profiled one)
_profiler_enabled = torch._C._autograd._profiler_enabled

# Stage names mirror the reference's PipelineMetrics enum
# (`PipelineMetrics.h:19-30`); TRAVERSE_PREP is the beam cull, which has no
# reference counterpart (the reference traverses per ray on the GPU).
STAGES = ["RAY_BUILDING", "TRAVERSE_PREP", "FIND_COLLISION", "REDUCE",
          "INTENSITY", "READ", "WRITE", "TOTAL"]


def _cuda_devices(value) -> set:
    """The CUDA devices of ``value``: a tensor or a sequence of tensors."""
    tensors = [value] if isinstance(value, torch.Tensor) else value or ()
    return {t.device for t in tensors if t.is_cuda}


@dataclass
class PipelineMetrics:
    """Accumulates per-stage wall times (seconds) across executions."""

    samples: dict = field(default_factory=lambda: defaultdict(list))
    discard_first: bool = False
    footer: str = ""          # free-form summary line (points/s, chunks)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Context manager timing one stage, a span of its name.  ``sync``
        (or ``result["sync"]`` set inside the block) names the stage's
        output tensor (or a sequence of them): the clock stops after
        `torch.cuda.synchronize` on each CUDA device they lie on.  CPU
        tensors need no wait."""
        result = {}
        timer = span(name, timed=True)
        try:
            with timer:
                try:
                    yield result
                finally:
                    for dev in _cuda_devices(result.get("sync", sync)):
                        torch.cuda.synchronize(dev)
        finally:
            self.samples[name].append(timer.seconds)

    def add(self, other: "PipelineMetrics") -> None:
        for k, v in other.samples.items():
            self.samples[k].extend(v)

    def _kept(self, name):
        s = self.samples.get(name, [])
        return s[1:] if (self.discard_first and len(s) > 1) else s

    def mean(self, name: str) -> float:
        s = self._kept(name)
        return sum(s) / len(s) if s else 0.0

    def std(self, name: str) -> float:
        s = self._kept(name)
        if len(s) < 2:
            return 0.0
        m = self.mean(name)
        return math.sqrt(sum((x - m) ** 2 for x in s) / (len(s) - 1))

    def report(self) -> str:
        lines = []
        for name in sorted(self.samples):
            lines.append(f"{name:14s} {self.mean(name)*1e3:10.3f} ms "
                         f"+- {self.std(name)*1e3:.3f} ms "
                         f"(n={len(self._kept(name))})")
        if self.footer:
            lines.append(self.footer)
        return "\n".join(lines)

    def export(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.report() + "\n")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` trace around a block (host and, with a card, CUDA
    activity); writes the Chrome trace ``<log_dir>/trace.json``, where the
    program's ``lbt.*`` spans are ranges beside the kernels."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span(NamedTuple):
    """A finished span; times in `time.time_ns` nanoseconds."""
    name: str
    start_ns: int
    end_ns: int
    thread: int          # `threading.get_ident` of the thread it ran on
    id: int
    parent: int | None   # the enclosing span's id (None: a root)
    request: int         # the root's id, shared by every span under it
    attrs: dict


class _Thread(threading.local):
    """A thread's recording state."""

    def __init__(self):
        self.stack = []      # open spans, innermost last
        self.base = None     # (parent id, request id) handed over by `carried`
        self.live = 0        # open spans, `recording()` blocks and handed
        #                      states: recording is on while it is not 0


_THREAD = _Thread()
_SPANS: list = []
_COUNTS: dict = {}
_LOCK = threading.Lock()
_IDS = itertools.count(1)


def _on() -> bool:
    return bool(_THREAD.live or _profiler_enabled())


class _Open:
    """A span being recorded; ``seconds`` once it has closed."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        t = _THREAD
        self.id = next(_IDS)
        if t.stack:
            self.parent, self.request = t.stack[-1].id, t.stack[-1].request
        elif t.base is not None:
            self.parent, self.request = t.base
            self.request = self.id if self.request is None else self.request
        else:
            self.parent, self.request = None, self.id
        self._range = None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        t.stack.append(self)
        t.live += 1
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        t = _THREAD
        t.stack.pop()
        t.live -= 1
        if self._range is not None:
            self._range.__exit__(*exc)
        _SPANS.append(Span(self.name, self.start_ns, self.end_ns,
                           threading.get_ident(), self.id, self.parent,
                           self.request, self.attrs))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Clock:
    """A span's clock with recording off, for a caller that reports its
    own seconds."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        return False

    seconds = _Open.seconds


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, *, timed: bool = False, **attrs):
    """A context manager bracketing one layer's work as the span ``name``
    with ``attrs``; recorded only while recording is on (module doc).
    ``timed``: the clock is read even with recording off, and the span
    gives ``seconds`` after it closes (for `Simulator.run`'s ``stats``)."""
    if _THREAD.live or _profiler_enabled():
        return _Open(name, attrs)
    return _Clock() if timed else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _THREAD.live or _profiler_enabled():
        with _LOCK:
            _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record on the calling thread (and what it hands over through
    `carried`) inside the block, with no profiler."""
    t = _THREAD
    t.live += 1
    try:
        yield
    finally:
        t.live -= 1


def recorded() -> dict:
    """The record so far, left in place: ``spans`` (`Span`s in the order
    they closed) and ``counts`` (counter totals)."""
    with _LOCK:
        return dict(spans=list(_SPANS), counts=dict(_COUNTS))


def clear() -> None:
    """Empty the record."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


def carried(fn):
    """``fn`` to run on another thread (an executor's) in the calling
    thread's recording state, its spans under the calling thread's open
    span; ``fn`` itself with recording off.  A profiler does not see
    such a thread, so its spans are kept but make no range."""
    t = _THREAD
    if t.stack:
        base = (t.stack[-1].id, t.stack[-1].request)
    elif _on():
        base = t.base or (None, None)
    else:
        return fn

    def call(*args, **kwargs):
        w = _THREAD
        saved, w.base = w.base, base
        w.live += 1
        try:
            return fn(*args, **kwargs)
        finally:
            w.live -= 1
            w.base = saved
    return call


def _host_tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        vals = [obj]
    else:
        vals = obj.values() if isinstance(obj, dict) else vars(obj).values()
    return [v for v in vals
            if isinstance(v, torch.Tensor) and v.device.type == "cpu"]


def _move(obj, device, non_blocking: bool):
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=non_blocking)
    if isinstance(obj, dict):
        return {k: v.to(device, non_blocking=non_blocking)
                for k, v in obj.items()}
    return obj.to(device)


def upload(obj, device, non_blocking: bool = False):
    """``obj`` on ``device``: a tensor, a dict of tensors, or a dataclass of
    tensors with a ``to(device)`` (no ``non_blocking`` there).  With
    recording on, a copy of host tensors to another device is one
    ``lbt.upload`` span with attributes ``bytes`` and ``pinned`` (every
    host tensor page-locked), its bytes counted in
    ``upload_bytes_pinned`` or ``upload_bytes_pageable``."""
    if not _on() or torch.device(device).type == "cpu":
        return _move(obj, device, non_blocking)
    host = _host_tensors(obj)
    nbytes = sum(t.numel() * t.element_size() for t in host)
    if not nbytes:
        return _move(obj, device, non_blocking)
    pinned = all(t.is_pinned() for t in host)
    count("upload_bytes_pinned" if pinned else "upload_bytes_pageable",
          nbytes)
    with span("lbt.upload", bytes=nbytes, pinned=pinned):
        return _move(obj, device, non_blocking)
