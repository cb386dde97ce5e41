"""Binary PLY point-cloud export.

Field-for-field parity with `LiDARPointCloud::writePLY`
(LiDARPointCloud.cpp:76-184): element "LiDAR" with position, normal, uv,
intensity, scan rank, scan direction, return counts, return percent,
semantic + ASPRS labels and their colors — written binary little-endian.
Reading back is supported for tests and downstream tooling.

Copied from `lidar_brdf_tpu/io/ply.py`: the same header and record layout,
byte for byte.  `write_ply` takes the port's PointCloud of tensors, on any
device, and moves it to the host itself.
"""

from __future__ import annotations

import numpy as np

from ..core.types import PointCloud, as_numpy
from ..runtime.metrics import carried, span

_HEADER_FIELDS = [
    ("x", "float"), ("y", "float"), ("z", "float"),
    ("nx", "float"), ("ny", "float"), ("nz", "float"),
    ("u", "float"), ("v", "float"),
    ("intensity", "float"),
    ("scan_rank", "float"),
    ("scan_direction_x", "float"), ("scan_direction_y", "float"),
    ("scan_direction_z", "float"),
    ("returnNumber", "uchar"), ("numReturns", "uchar"),
    ("returnPercent", "float"),
    ("gpsTime", "float"),
    ("semanticGroup", "uchar"), ("asprsSemanticGroup", "uchar"),
    ("semanticGroup_red", "float"), ("semanticGroup_green", "float"),
    ("semanticGroup_blue", "float"),
    ("asprsSemanticGroup_red", "float"), ("asprsSemanticGroup_green", "float"),
    ("asprsSemanticGroup_blue", "float"),
]

# Deterministic label palette (the reference takes colors from the scene's
# per-group tables; we hash the label id into a stable palette).
_PALETTE = np.array([
    [0.894, 0.102, 0.110], [0.216, 0.494, 0.722], [0.302, 0.686, 0.290],
    [0.596, 0.306, 0.639], [1.000, 0.498, 0.000], [1.000, 1.000, 0.200],
    [0.651, 0.337, 0.157], [0.969, 0.506, 0.749], [0.600, 0.600, 0.600],
    [0.121, 0.471, 0.706], [0.682, 0.780, 0.910], [0.200, 0.627, 0.173],
], np.float32)


def _label_color(labels: np.ndarray) -> np.ndarray:
    safe = np.maximum(labels, 0) % len(_PALETTE)
    col = _PALETTE[safe]
    col[labels < 0] = 0.3
    return col


def write_ply(path: str, cloud: PointCloud, *, compact: bool = True) -> int:
    """Write the point cloud; returns the number of points written.
    ``compact=False`` writes every slot and needs a cloud whose mask is all
    True (one that is compacted already)."""
    if compact:
        cloud = cloud.compact_host()
    n = int(as_numpy(cloud.mask).sum()) if not compact \
        else len(as_numpy(cloud.intensity))

    a = lambda name: as_numpy(getattr(cloud, name))
    rn = a("return_number").astype(np.int32)
    nr = np.maximum(a("num_returns").astype(np.int32), 1)
    ret_pct = (rn + 1).astype(np.float32) / nr.astype(np.float32)
    sem_col = _label_color(a("semantic"))
    asprs_col = _label_color(a("asprs"))

    dtype = np.dtype([(name, "<f4" if kind == "float" else "u1")
                      for name, kind in _HEADER_FIELDS])
    rec = np.empty(n, dtype)
    pos, nrm, uv = a("position"), a("normal"), a("uv")
    sd = a("scan_direction")
    rec["x"], rec["y"], rec["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    rec["u"], rec["v"] = uv[:, 0], uv[:, 1]
    rec["intensity"] = a("intensity")
    rec["scan_rank"] = a("scan_angle_rank")
    rec["scan_direction_x"] = sd[:, 0]
    rec["scan_direction_y"] = sd[:, 1]
    rec["scan_direction_z"] = sd[:, 2]
    rec["returnNumber"] = np.clip(rn, 0, 255).astype(np.uint8)
    rec["numReturns"] = np.clip(nr, 0, 255).astype(np.uint8)
    rec["returnPercent"] = ret_pct
    rec["gpsTime"] = a("gps_time")
    rec["semanticGroup"] = np.clip(a("semantic"), 0, 255).astype(np.uint8)
    rec["asprsSemanticGroup"] = np.clip(a("asprs"), 0, 255).astype(np.uint8)
    rec["semanticGroup_red"] = sem_col[:, 0]
    rec["semanticGroup_green"] = sem_col[:, 1]
    rec["semanticGroup_blue"] = sem_col[:, 2]
    rec["asprsSemanticGroup_red"] = asprs_col[:, 0]
    rec["asprsSemanticGroup_green"] = asprs_col[:, 1]
    rec["asprsSemanticGroup_blue"] = asprs_col[:, 2]

    header = ["ply", "format binary_little_endian 1.0",
              f"element LiDAR {n}"]
    header += [f"property {kind} {name}" for name, kind in _HEADER_FIELDS]
    header += ["end_header", ""]
    with open(path, "wb") as fh:
        fh.write("\n".join(header).encode("ascii"))
        fh.write(rec.tobytes())
    return n


def _write_spanned(path: str, cloud: PointCloud, *, compact: bool) -> int:
    with span("lbt.ply_write"):
        return write_ply(path, cloud, compact=compact)


class AsyncPlyWriter:
    """Background PLY writer: compaction + file IO off the simulation thread.

    Equivalent of the reference's detached writer thread
    (`LiDARPointCloud::save`, LiDARPointCloud.cpp:56-61: `std::thread(...)
    .detach()`), but joinable so callers can propagate errors and counts.
    Used by the TLS multi-position path loop and the spectral sweep, where
    the next waypoint/wavelength simulates while the previous cloud writes.

        with AsyncPlyWriter() as w:
            for i, cloud in enumerate(clouds):
                w.submit(f"out_{i}.ply", cloud)
        counts = w.results()   # after the `with` block: all writes joined
    """

    def __init__(self, max_workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="ply-writer")
        self._futures: list = []

    def submit(self, path: str, cloud: PointCloud, *, compact: bool = True):
        """Queue one write; returns its Future (resolves to point count).
        The write is a span ``lbt.ply_write`` under the caller's open one."""
        fut = self._pool.submit(carried(_write_spanned), path, cloud,
                                compact=compact)
        self._futures.append(fut)
        return fut

    def join(self) -> list[int]:
        """Wait for all queued writes; returns counts, re-raises the first
        writer error."""
        counts = [f.result() for f in self._futures]
        self._futures = []
        return counts

    def results(self) -> list[int]:
        return self.join()

    def close(self) -> list[int]:
        counts = self.join()
        self._pool.shutdown(wait=True)
        return counts

    def __enter__(self) -> "AsyncPlyWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:                      # don't mask the in-flight exception
            self._pool.shutdown(wait=False, cancel_futures=True)


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY written by `write_ply` (tests / tooling)."""
    with open(path, "rb") as fh:
        data = fh.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    n = 0
    fields = []
    for line in header:
        parts = line.split()
        if parts[:2] == ["element", "LiDAR"]:
            n = int(parts[2])
        elif parts and parts[0] == "property":
            fields.append((parts[2], "<f4" if parts[1] == "float" else "u1"))
    rec = np.frombuffer(data[head_end:], dtype=np.dtype(fields), count=n)
    return {name: rec[name].copy() for name, _ in fields}
