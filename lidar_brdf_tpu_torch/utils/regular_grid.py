"""2-D regular density grid for scene composition (counterpart of
`lidar_brdf_tpu/utils/regular_grid.py`; numpy, as there).

Equivalent of `DataStructures/RegularGrid.{h,cpp}` (h:16-87): a coarse XZ
occupancy/density grid used to place models on terrain without overlap (the
reference's procedural scene support).
"""

from __future__ import annotations

import numpy as np


class RegularGrid:
    def __init__(self, aabb_min, aabb_max, cells_x: int, cells_z: int):
        self.min = np.asarray(aabb_min, np.float64)[[0, 2]]
        self.max = np.asarray(aabb_max, np.float64)[[0, 2]]
        self.shape = (cells_x, cells_z)
        self.density = np.zeros(self.shape, np.float32)

    def cell_of(self, x: float, z: float) -> tuple[int, int]:
        rel = (np.array([x, z]) - self.min) / np.maximum(
            self.max - self.min, 1e-12)
        idx = np.clip((rel * self.shape).astype(int), 0,
                      np.array(self.shape) - 1)
        return int(idx[0]), int(idx[1])

    def add(self, x: float, z: float, weight: float = 1.0) -> None:
        i, j = self.cell_of(x, z)
        self.density[i, j] += weight

    def occupancy(self, x: float, z: float) -> float:
        i, j = self.cell_of(x, z)
        return float(self.density[i, j])

    def sample_free_positions(self, rng: np.random.Generator, count: int,
                              max_density: float = 0.0,
                              max_tries: int = 1000) -> np.ndarray:
        """Rejection-sample positions in cells below ``max_density``
        (model placement on terrain)."""
        out = []
        tries = 0
        while len(out) < count and tries < max_tries * count:
            tries += 1
            p = rng.uniform(self.min, self.max)
            if self.occupancy(p[0], p[1]) <= max_density:
                self.add(p[0], p[1])
                out.append(p)
        return np.asarray(out)
