"""What the program-span metric files share: the port's own record of its
spans and counters (`lidar_brdf_tpu_torch.runtime.metrics.recorded`),
which the program keeps while the profiler traces the window, read beside
the traced run (`run.py` hands each reader ``window_s`` and ``trace``).
Spans are in `time.time_ns` nanoseconds, the clock of the profiler's
events, so they lie on the device intervals of ``trace["kernels"]``.  A
program without the recorder (one older than it), or a record with no
span, gives None."""

import bisect

from perfbench.trace import union_seconds


def record():
    """The program's record (``spans``, ``counts``), or None."""
    try:
        from lidar_brdf_tpu_torch.runtime import metrics
        rec = metrics.recorded()
    except (ImportError, AttributeError):
        return None
    return rec if rec.get("spans") else None


def named(rec, name: str) -> list:
    return [s for s in rec["spans"] if s.name == name]


def below(rec, roots, name: str | None = None) -> list:
    """Spans below ``roots`` (any depth) on the roots' threads; those named
    ``name`` only, when given."""
    threads = {s.thread for s in roots}
    inside = {s.id for s in roots}
    out = []
    # the record holds spans as they closed, each after its children:
    # walking back, a parent comes before its children
    for s in reversed(rec["spans"]):
        if s.parent in inside and s.thread in threads:
            inside.add(s.id)
            out.append(s)
    out.reverse()
    return [s for s in out if name is None or s.name == name]


def share(run, ns) -> float | None:
    """``ns`` nanoseconds over the run's window."""
    if not run.get("window_s"):
        return None
    return ns * 1e-9 / run["window_s"]


def survey_share(run, name: str) -> float | None:
    """The main thread's ``name`` spans (None: all) below ``lbt.simulate``
    over the window: the union of their intervals."""
    rec = record()
    if rec is None:
        return None
    roots = named(rec, "lbt.simulate")
    if not roots:
        return None
    spans = below(rec, roots, name)
    return share(run, union_seconds((s.start_ns, s.end_ns) for s in spans))


def idle_ms(run, name: str) -> float | None:
    """Milliseconds a span ``name`` in which no device interval of the
    traced run ran: the host's time in that layer with the card idle."""
    rec = record()
    tr = run.get("trace")
    if rec is None or not tr or not tr.get("kernels"):
        return None
    spans = named(rec, name)
    if not spans:
        return None
    busy = []                   # the device's busy stretches, merged
    for s, e in sorted((int(s * 1e9), int(e * 1e9))
                       for _, s, e in tr["kernels"]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    starts = [b[0] for b in busy]
    idle = 0
    for sp in spans:
        lo, hi = sp.start_ns, sp.end_ns
        covered = 0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            covered += max(0, min(busy[i][1], hi) - max(busy[i][0], lo))
            i += 1
        idle += (hi - lo) - covered
    return idle * 1e-6 / len(spans)
