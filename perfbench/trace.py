"""The traced window: `torch.profiler` over the window, reduced to device
intervals by name, the host operators beside them, the device's busy time
(the union of its intervals, so overlapping kernels count once) and the
breakdown of the result line.  Spans of the benchmark's own (`span`) are
profiler ranges named ``perfbench.<name>``.
"""

from __future__ import annotations

import contextlib

WINDOW = "perfbench.window"
NAME_CHARS = 160        # an operation's name in the breakdown, cut to this


def _ns(e, what):
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return fn()
    return getattr(e, f"{what}_us")() * 1000


def _user_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def union_seconds(intervals, lo=None, hi=None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi],
    in the intervals' unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo, hi):
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [g for g in gaps if g[1] > g[0]]


def summarize(device_ops, host_ops, lo, hi) -> dict:
    """The traced window [lo, hi] (seconds) from device intervals and host
    intervals, each a list of (name, start_s, end_s)."""
    import numpy as np
    dev = [(s, e) for _, s, e in device_ops]
    by_name = {}
    for name, s, e in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(n[:NAME_CHARS], v) for n, v in top]
    gaps = sorted(idle_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])[:10]
    host = [h for h in host_ops if h[0] != WINDOW]
    starts = np.array([h[1] for h in host])
    ends = np.array([h[2] for h in host])
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        cover = np.nonzero((starts <= mid) & (mid <= ends))[0]
        # the innermost host operation running at the gap's middle
        name = (host[cover[np.argmin(ends[cover] - starts[cover])]][0]
                if cover.size else "host idle")
        named.append([name[:NAME_CHARS], e - s])
    return dict(window_s=hi - lo, busy_s=union_seconds(dev, lo, hi),
                device_ops=[[n, v] for n, v in top], idle_gaps=named,
                kernels=device_ops)


class Tracer:
    """``with tracer.window():`` profiles the window when ``enabled``;
    `summary()` then gives `summarize`'s dict, or None untraced."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield
        self.prof = prof

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        device_ops, host_ops, lo, hi = [], [], None, None
        for e in self.prof.profiler.kineto_results.events():
            s = _ns(e, "start") * 1e-9
            end = s + e.duration_ns() * 1e-9 if hasattr(e, "duration_ns") \
                else s + e.duration_us() * 1e-6
            if e.device_type() == DeviceType.CUDA:
                # a profiler range's device-side copy is no device work
                if not (e.name().startswith("perfbench.")
                        or _user_annotation(e)):
                    device_ops.append((e.name(), s, end))
            else:
                if e.name() == WINDOW:
                    lo, hi = s, end
                host_ops.append((e.name(), s, end))
        if lo is None:
            return None
        return summarize(device_ops, host_ops, lo, hi)
