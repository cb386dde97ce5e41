"""Analysis / export utilities (counterpart of
`lidar_brdf_tpu/utils/analysis.py`: a numpy copy that takes the port's
`PointCloud`, of tensors or arrays).

Equivalents of the reference's paper-figure and interchange exporters:
* histogram + LaTeX/pgfplots export (`Utilities/Histogram.h:13-34`)
* HELIOS++ spectra-format hemispherical reflectance export
  (`BRDFDatabase.cpp:176-208`)
* refractive-index spline CSV export (`MaterialDatabase.cpp:191-210`)
* per-class point counts (`PipelineMetrics` ClassCount export)
"""

from __future__ import annotations

import numpy as np

from ..core.config import ASPRSClass
from ..core.types import PointCloud, as_numpy


def histogram(values: np.ndarray, num_bins: int = 20,
              vmin: float | None = None, vmax: float | None = None):
    values = np.asarray(as_numpy(values), np.float64)
    vmin = values.min() if vmin is None else vmin
    vmax = values.max() if vmax is None else vmax
    counts, edges = np.histogram(values, bins=num_bins, range=(vmin, vmax))
    return counts, edges


def histogram_to_pgfplots(counts: np.ndarray, edges: np.ndarray,
                          caption: str = "") -> str:
    """LaTeX pgfplots bar chart (the reference's Overleaf figure export)."""
    coords = "\n".join(
        f"        ({0.5 * (edges[i] + edges[i + 1]):.6g}, {int(c)})"
        for i, c in enumerate(counts))
    return (
        "\\begin{tikzpicture}\n"
        "  \\begin{axis}[ybar interval, ymin=0]\n"
        "    \\addplot coordinates {\n" + coords + "\n    };\n"
        "  \\end{axis}\n"
        f"% {caption}\n"
        "\\end{tikzpicture}\n")


def class_counts(cloud: PointCloud) -> dict[str, int]:
    """Per-ASPRS-class point counts (reference `Results/ClassCount.txt`)."""
    mask = as_numpy(cloud.mask)
    asprs = as_numpy(cloud.asprs)[mask]
    out = {}
    for cls in ASPRSClass:
        n = int((asprs == int(cls)).sum())
        if n:
            out[cls.name] = n
    return out


def export_class_counts(path: str, cloud: PointCloud) -> None:
    with open(path, "w") as fh:
        for name, count in class_counts(cloud).items():
            fh.write(f"{name}\t{count}\n")


def export_helios_spectra(path: str, wavelengths_nm: np.ndarray,
                          reflectance: np.ndarray,
                          material_name: str = "") -> None:
    """Hemispherical reflectance in the HELIOS++ spectra file format
    (parity with the header written by `BRDFDatabase::sampleBSDF`)."""
    wavelengths_nm = np.asarray(as_numpy(wavelengths_nm), np.float64)
    with open(path, "w") as fh:
        fh.write("Measurement:  Directional (10 Degree) Hemispherical "
                 "Reflectance\n")
        fh.write("First Column:  X\n")
        fh.write("Second Column:  Y\n")
        fh.write("X Units:  Wavelength (micrometers)\n")
        fh.write("Y Units:  Reflectance (percent)\n")
        fh.write(f"First X Value: {wavelengths_nm[0] / 1000.0}\n")
        fh.write(f"Last X Value: {wavelengths_nm[-1] / 1000.0}\n")
        fh.write(f"Number of X Values: {len(wavelengths_nm)}\n")
        fh.write("Additional Information:  None\n\n")
        for wl, r in zip(wavelengths_nm, as_numpy(reflectance)):
            fh.write(f"{wl / 1000.0}\t{r}\n")


def export_refractive_spline_csv(path: str, spectrum, num_samples: int = 200,
                                 wl_range=(400.0, 1600.0)) -> None:
    """CSV of n(lambda) samples (reference export for Python plotting)."""
    from ..io.materials import refractive_index_at
    wls = np.linspace(wl_range[0], wl_range[1], num_samples)
    with open(path, "w") as fh:
        fh.write("wavelength_nm,n\n")
        for wl in wls:
            fh.write(f"{wl},{refractive_index_at(spectrum, float(wl))}\n")
