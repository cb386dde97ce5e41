"""Checkpoint / resume (counterpart of `lidar_brdf_tpu/runtime/checkpoint.py`).

* ``ChunkCheckpointer`` — long chunked simulations: each finished chunk's
  compacted point cloud is persisted with a cursor; a resumed run skips the
  completed chunks (generalizes the reference's incremental TLS-path PLY
  dumps, `LiDARSimulation.cpp:269-271`).
* ``save_params`` / ``load_params`` — material-parameter optimization state
  (a MaterialTable + the optimizer step), plain .npz on the host.

The files, names and npz keys are the JAX package's: arrays are numpy on
disk, so a checkpoint directory or params file written by either package
loads in the other.  Writes go to a temporary file first and are renamed
into place.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..core.types import (MaterialTable, PointCloud, as_numpy,
                          concat_pointclouds)


class ChunkCheckpointer:
    """Directory-backed chunk log: `chunk_<i>.npz` + `state.json`."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.state_path = os.path.join(directory, "state.json")

    def completed_chunks(self) -> int:
        if not os.path.exists(self.state_path):
            return 0
        with open(self.state_path) as fh:
            return json.load(fh).get("completed_chunks", 0)

    def save_chunk(self, index: int, cloud: PointCloud) -> None:
        compact = cloud.compact_host()
        path = os.path.join(self.dir, f"chunk_{index}.npz")
        tmp = path + ".tmp.npz"   # np.savez appends .npz to odd suffixes
        np.savez_compressed(tmp, **{
            f.name: as_numpy(getattr(compact, f.name))
            for f in dataclasses.fields(PointCloud)})
        os.replace(tmp, path)
        with open(self.state_path + ".tmp", "w") as fh:
            json.dump({"completed_chunks": index + 1}, fh)
        os.replace(self.state_path + ".tmp", self.state_path)

    def load_chunk(self, index: int) -> PointCloud:
        """Chunk ``index`` as a host PointCloud (mask all True)."""
        with np.load(os.path.join(self.dir, f"chunk_{index}.npz")) as data:
            return PointCloud(**{k: torch.from_numpy(data[k])
                                 for k in data.files})

    def load_all(self) -> PointCloud | None:
        n = self.completed_chunks()
        if n == 0:
            return None
        return concat_pointclouds([self.load_chunk(i) for i in range(n)])


def save_params(path: str, materials: MaterialTable, step: int = 0,
                **extra) -> None:
    arrays = {f.name: as_numpy(getattr(materials, f.name))
              for f in dataclasses.fields(MaterialTable)}
    arrays["__step__"] = np.asarray(step)
    for k, v in extra.items():
        arrays[k] = as_numpy(v)
    tmp = path + ".tmp.npz"   # np.savez appends .npz to odd suffixes
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def load_params(path: str) -> tuple[MaterialTable, int, dict]:
    """(materials as CPU tensors, step, extra arrays as numpy)."""
    with np.load(path) as data:
        fields = {f.name for f in dataclasses.fields(MaterialTable)}
        mats = MaterialTable(**{k: torch.from_numpy(data[k])
                                for k in data.files if k in fields})
        step = int(data["__step__"]) if "__step__" in data.files else 0
        extra = {k: data[k] for k in data.files
                 if k not in fields and k != "__step__"}
    return mats, step, extra
