"""What the per-layer metric files share: kernel names, the traversal's
least time and the device's idle share, read from a traced run (`run.py`
hands each reader the run: ``items`` completed, ``rays``, ``window_s``,
``trace`` (`trace.summarize`), ``spans`` where the driver keeps them).
A reader that finds nothing to read returns None."""

import re

PEAK_BYTES_S = 3.35e12          # one H100's published HBM peak (SXM, 700 W)
BYTES_PER_RAY = 24 + 8          # origin and direction in, t and face out


def kernels(*names):
    """A matcher of the device operations named ``names``, demangled (with
    `void ` and the anonymous namespace) or mangled."""
    alt = "|".join(names)
    return re.compile(rf"^(?:void )?(?:\(anonymous namespace\)::)?"
                      rf"(?:{alt})(?![A-Za-z0-9_])|^_Z\d+(?:{alt})")


TRAVERSE = kernels("tile_traverse_kernel", "pulse_traverse_kernel")
CULL = kernels("walk_thread_kernel", "walk_group_kernel",
               "place_thread_kernel", "place_group_kernel", "sort_kernel")


def device_seconds(run, pattern, match=True):
    tr = run.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return sum(e - s for name, s, e in tr["kernels"]
               if bool(pattern.match(name)) == match)


def traverse_roofline(run):
    """% of the traversal kernels' time that moving 32 B a ray at the HBM
    peak needs."""
    busy = device_seconds(run, TRAVERSE)
    if not busy:
        return None
    return 100.0 * run["rays"] * BYTES_PER_RAY / PEAK_BYTES_S / busy


def device_idle(run):
    tr = run.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def span_share(run, key):
    spans = run.get("spans")
    if not spans or not run.get("window_s"):
        return None
    return spans[key] / run["window_s"]
