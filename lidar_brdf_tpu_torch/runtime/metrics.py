"""Stage timing harness — the `PipelineMetrics` equivalent (counterpart of
`lidar_brdf_tpu/runtime/metrics.py`).

The reference brackets its pipeline stages with chrono timers and reports
mean +/- std over `numExecs` runs with optional first-run discard
(`Utilities/PipelineMetrics.{h,cpp}`, `LiDARSimulation.cpp:292-365`).  Here
a stage is a host-clock bracket that, given the stage's output tensors,
waits for the card to finish them before it stops the clock; plus the same
aggregation and text export, and a `torch.profiler` trace hook.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

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
        """Context manager timing one stage.  ``sync`` (or ``result["sync"]``
        set inside the block) names the stage's output tensor (or a
        sequence of them): the clock stops after `torch.cuda.synchronize`
        on each CUDA device they lie on.  CPU tensors need no wait."""
        t0 = time.perf_counter()
        result = {}
        try:
            yield result
        finally:
            for dev in _cuda_devices(result.get("sync", sync)):
                torch.cuda.synchronize(dev)
            self.samples[name].append(time.perf_counter() - t0)

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
    activity); writes the Chrome trace ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
