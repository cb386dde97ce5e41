"""The port's `utils/analysis.py` and `utils/regular_grid.py` against the JAX
package's, on seeded inputs: the same counts, edges and grids, and the
exported files equal byte for byte.  The port's functions take its
`PointCloud` of tensors (or numpy arrays)."""

import numpy as np
import pytest
import torch

from lidar_brdf_tpu.core.types import PointCloud as JCloud
from lidar_brdf_tpu.io.materials import bundled_spectra as jspectra
from lidar_brdf_tpu.utils import analysis as janalysis
from lidar_brdf_tpu.utils.regular_grid import RegularGrid as JGrid
from lidar_brdf_tpu_torch.core.types import PointCloud
from lidar_brdf_tpu_torch.io.materials import bundled_spectra
from lidar_brdf_tpu_torch.utils import analysis
from lidar_brdf_tpu_torch.utils.regular_grid import RegularGrid


def _cloud(seed: int, n: int = 500) -> dict:
    """A seeded dense cloud as numpy fields: ASPRS labels over every class
    id and some unknown ones, a third of the slots masked out."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    i32 = lambda lo, hi: rng.integers(lo, hi, n).astype(np.int32)
    return dict(
        position=f32(n, 3), normal=f32(n, 3), uv=f32(n, 2),
        intensity=np.abs(f32(n)), distance=np.abs(f32(n)) * 40,
        return_number=i32(0, 2), num_returns=i32(1, 3),
        scan_angle_rank=f32(n), scan_direction=f32(n, 3), gps_time=f32(n),
        comp_id=i32(0, 9), semantic=i32(0, 5), asprs=i32(0, 24),
        mask=rng.random(n) > 0.33)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_and_pgfplots_match_jax(seed):
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 10.0, 1000).astype(np.float32)
    for kw in ({}, dict(num_bins=7), dict(num_bins=12, vmin=5.0, vmax=50.0)):
        cj, ej = janalysis.histogram(values, **kw)
        ct, et = analysis.histogram(torch.from_numpy(values), **kw)
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(et, ej)
        assert (analysis.histogram_to_pgfplots(ct, et, "ranges")
                == janalysis.histogram_to_pgfplots(cj, ej, "ranges"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_counts_and_export_match_jax(seed, tmp_path):
    arrays = _cloud(seed)
    jcloud = JCloud(**arrays)
    tcloud = PointCloud(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    want = janalysis.class_counts(jcloud)
    assert analysis.class_counts(tcloud) == want
    assert analysis.class_counts(PointCloud(**arrays)) == want
    assert sum(want.values()) < int(arrays["mask"].sum())  # unknown ids
    janalysis.export_class_counts(str(tmp_path / "j.txt"), jcloud)
    analysis.export_class_counts(str(tmp_path / "t.txt"), tcloud)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def test_spectra_exports_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    wl = np.sort(rng.uniform(400.0, 1600.0, 33))
    refl = rng.uniform(0.0, 1.0, 33).astype(np.float32)
    janalysis.export_helios_spectra(str(tmp_path / "j.txt"), wl, refl, "LEAF")
    analysis.export_helios_spectra(str(tmp_path / "t.txt"),
                                   torch.from_numpy(wl),
                                   torch.from_numpy(refl), "LEAF")
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    for name in ("WATER", "CRYSTAL_GLASS"):
        janalysis.export_refractive_spline_csv(
            str(tmp_path / "j.csv"), jspectra()[name], num_samples=57)
        analysis.export_refractive_spline_csv(
            str(tmp_path / "t.csv"), bundled_spectra()[name], num_samples=57)
        assert (tmp_path / "t.csv").read_bytes() == \
            (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_regular_grid_matches_jax(seed):
    args = ([-10, 0, -12], [14, 5, 10], 8, 6)
    jgrid, tgrid = JGrid(*args), RegularGrid(*args)
    pj = jgrid.sample_free_positions(np.random.default_rng(seed), 30,
                                     max_density=1.0)
    pt = tgrid.sample_free_positions(np.random.default_rng(seed), 30,
                                     max_density=1.0)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(tgrid.density, jgrid.density)
    assert tgrid.density.sum() == 30
    for x, z in np.random.default_rng(seed).uniform(-20, 20, (50, 2)):
        assert tgrid.cell_of(x, z) == jgrid.cell_of(x, z)
        assert tgrid.occupancy(x, z) == jgrid.occupancy(x, z)
