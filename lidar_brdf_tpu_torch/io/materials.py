"""Material database: LiDAR material registry + per-wavelength tables.

PyTorch-port copy of `lidar_brdf_tpu/io/materials.py` (host numpy; the
table comes back as CPU tensors): equivalent of `MaterialDatabase` (MaterialDatabase.cpp:21-243) and
`BRDFDatabase` (BRDFDatabase.cpp:15-293):

* 15 named LiDAR materials (`MaterialDatabase.h:28-44`), each with a
  roughness scalar (`Assets/LiDAR/Roughness/Roughness.txt`), a refractive
  index spectrum n(lambda) (`Assets/LiDAR/RefractiveIndex/*.txt`, spline-
  interpolated at the active wavelength), an analytic BRDF model id
  (`Assets/LiDAR/BRDFModel/BRDFModel.txt`) and a 360x91 measured
  retro-reflectance table.

* The RGL/EPFL measured data (`Assets/BRDF/brdfs_rgl_18`) is not shipped in
  the reference repo either (`BRDFDatabase.cpp:7`); like the reference falls
  back to a binary cache, we fall back to *synthetic* tables generated from
  the analytic models so the measured-table code path is fully exercised.
  Real tables can be supplied via `with_measured` (a folder of RGL
  `*.bsdf` files, `io/rgl_bsdf.py`) or `load_brdf_tables_npz`.

Wavelength handling mirrors the reference: n(lambda) interpolated from the
spectrum; tables sliced at the nearest sampled wavelength
(`BRDFDatabase.cpp:80-97`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import BRDFModel
from ..core.types import MaterialTable
from ..physics.brdf import PHI_BUCKETS, THETA_BUCKETS

# Registry order = material ids (parity with `MaterialDatabase.h:28-44`).
MATERIAL_NAMES = [
    "ALUMINIUM", "COPPER", "GOLD", "IRON", "SILVER",
    "AIR", "WATER", "STONE", "WOOD", "LEAF",
    "FABRIC", "CRYSTAL_GLASS", "PLASTIC",
    "DIAMOND", "GEMS",
]
MATERIAL_ID = {n: i for i, n in enumerate(MATERIAL_NAMES)}
NUM_MATERIALS = len(MATERIAL_NAMES)

# Roughness per material (values from Assets/LiDAR/Roughness/Roughness.txt).
ROUGHNESS = {
    "AIR": 0.0, "ALUMINIUM": 0.2, "COPPER": 0.6, "CRYSTAL_GLASS": 0.1,
    "DIAMOND": 0.4, "FABRIC": 0.9, "GEMS": 0.35, "GOLD": 0.5, "IRON": 0.4,
    "LEAF": 0.25, "STONE": 0.8, "PLASTIC": 0.45, "SILVER": 0.5,
    "WATER": 0.05, "WOOD": 0.5,
}

# Analytic model per material (Assets/LiDAR/BRDFModel/BRDFModel.txt).
ANALYTIC_MODEL = {
    "AIR": BRDFModel.IDEAL_DIFFUSE, "ALUMINIUM": BRDFModel.COOK_TORRANCE,
    "COPPER": BRDFModel.COOK_TORRANCE, "CRYSTAL_GLASS": BRDFModel.BLINN_PHONG,
    "DIAMOND": BRDFModel.COOK_TORRANCE, "FABRIC": BRDFModel.MINNAERT,
    "GEMS": BRDFModel.COOK_TORRANCE, "GOLD": BRDFModel.COOK_TORRANCE,
    "IRON": BRDFModel.COOK_TORRANCE, "LEAF": BRDFModel.OREN_NAYAR,
    "PLASTIC": BRDFModel.COOK_TORRANCE, "SILVER": BRDFModel.COOK_TORRANCE,
    "STONE": BRDFModel.MINNAERT, "WATER": BRDFModel.IDEAL_DIFFUSE,
    "WOOD": BRDFModel.WARD_ANISOTROPIC,
}

# Default measured-BRDF pairing: LiDAR material -> RGL/EPFL measured
# material, the reference's `Assets/LiDAR/Reflectivity/Reflectivity.txt`
# mapping applied by `MaterialDatabase::loadReflectivityMap`
# (MaterialDatabase.cpp:69-99).  The reference appends "_spec" at lookup
# (`_brdfDatabase.lookUpMaterial(materialName + "_spec")`); `with_measured`
# tries the suffixed name first, then the bare one.
REFLECTIVITY_MEASURED_MAP: dict[str, str] = {
    "AIR": "colodur_azure_4e",
    "ALUMINIUM": "aniso_brushed_aluminium_1",
    "COPPER": "aniso_metallic_paper_copper",
    "CRYSTAL_GLASS": "acrylic_felt_white",
    "DIAMOND": "vch_ultra_pink",
    "FABRIC": "aniso_morpho_melenaus",
    "GEMS": "vch_ultra_pink",
    "GOLD": "vch_golden_yellow",
    "IRON": "weta_brushed_steel_satin_pink",
    "LEAF": "leaf_maple",
    "MATTE": "colodur_napoli_4f",
    "PAINT": "acrylic_felt_white",
    "PLASTIC": "aniso_green_pvc",
    "SILVER": "cc_ibiza_sunset",
    "STONE": "cm_white",
    "WATER": "irid_flake_paint1",
    "DARK_STONE": "colodur_napoli_4f",
    "WOOD": "cardboard",
    "DARK_WOOD": "leaf_maple",
    "DARK_IRON": "chm_light_blue",
    "DARK_PLASTIC": "ilm_aniso_darth_vader_pants",
}

# Bundled full-resolution refractive-index dataset (public optical-constant
# tables — refractiveindex.info et al. — which the reference redistributes
# as Assets/LiDAR/RefractiveIndex/*.txt).  Built from the reference file
# format by scripts/build_refractive_npz.py; loaded lazily.
_BUNDLED_SPECTRA_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "refractive_index.npz")
_bundled_spectra_cache: dict[str, list[tuple[float, float]]] | None = None


def bundled_spectra() -> dict[str, list[tuple[float, float]]]:
    """The packaged n(lambda) dataset as {material: [(wl_nm, n), ...]}.

    Empty dict if the data file is absent (source checkouts always ship it;
    the compact `REFRACTIVE_SPECTRA` sketches then apply)."""
    global _bundled_spectra_cache
    if _bundled_spectra_cache is None:
        spectra: dict[str, list[tuple[float, float]]] = {}
        if os.path.exists(_BUNDLED_SPECTRA_PATH):
            blob = np.load(_BUNDLED_SPECTRA_PATH, allow_pickle=False)
            names, offsets = blob["names"], blob["offsets"]
            wl, n = blob["wl_nm"], blob["n"]
            for i, name in enumerate(names):
                lo, hi = offsets[i], offsets[i + 1]
                spectra[str(name)] = list(zip(wl[lo:hi].tolist(),
                                              n[lo:hi].tolist()))
        _bundled_spectra_cache = spectra
    return _bundled_spectra_cache


# Compact refractive-index spectra n(lambda[nm]) — fallback control points
# from the same public optical-constant tables, used only when the bundled
# full-resolution dataset (data/refractive_index.npz) is missing.
REFRACTIVE_SPECTRA: dict[str, list[tuple[float, float]]] = {
    "AIR": [(400, 1.0003), (1600, 1.0003)],
    "ALUMINIUM": [(400, 0.49), (600, 1.2), (900, 2.06), (1100, 1.26), (1600, 1.6)],
    "COPPER": [(400, 1.18), (600, 0.47), (900, 0.33), (1100, 0.43), (1600, 0.7)],
    "GOLD": [(400, 1.47), (600, 0.25), (900, 0.27), (1100, 0.35), (1600, 0.56)],
    "IRON": [(400, 2.42), (600, 2.9), (900, 3.05), (1100, 3.05), (1600, 3.3)],
    "SILVER": [(400, 0.05), (600, 0.06), (900, 0.04), (1100, 0.04), (1600, 0.4)],
    "WATER": [(400, 1.339), (600, 1.332), (900, 1.327), (1100, 1.324), (1600, 1.317)],
    "STONE": [(400, 1.55), (1600, 1.54)],
    "WOOD": [(400, 1.55), (1600, 1.53)],
    "LEAF": [(400, 1.485), (700, 1.415), (1000, 1.40), (1600, 1.39)],
    "FABRIC": [(400, 1.53), (1600, 1.52)],
    "CRYSTAL_GLASS": [(400, 1.53), (700, 1.515), (1100, 1.507), (1600, 1.50)],
    "PLASTIC": [(400, 1.50), (1600, 1.48)],
    "DIAMOND": [(400, 2.46), (700, 2.41), (1100, 2.39), (1600, 2.39)],
    "GEMS": [(400, 1.78), (1600, 1.74)],
}

# Fresnel F0 used by Cook-Torrance (`MaterialGPUData.reflectivity`).
REFLECTIVITY_F0 = {
    "ALUMINIUM": (0.91, 0.92, 0.92), "COPPER": (0.95, 0.64, 0.54),
    "GOLD": (1.00, 0.71, 0.29), "IRON": (0.56, 0.57, 0.58),
    "SILVER": (0.95, 0.93, 0.88), "AIR": (0.02, 0.02, 0.02),
    "WATER": (0.02, 0.02, 0.02), "STONE": (0.04, 0.04, 0.04),
    "WOOD": (0.05, 0.05, 0.05), "LEAF": (0.04, 0.05, 0.04),
    "FABRIC": (0.04, 0.04, 0.04), "CRYSTAL_GLASS": (0.05, 0.05, 0.05),
    "PLASTIC": (0.05, 0.05, 0.05), "DIAMOND": (0.17, 0.17, 0.17),
    "GEMS": (0.08, 0.08, 0.08),
}


def parse_refractive_index_file(path: str) -> list[tuple[float, float]]:
    """Parse the reference's RefractiveIndex file format
    (`MaterialDatabase::readRefractiveIndexFile`, cpp:129-176): tab-separated
    (wavelength, n[, k]) rows; wavelengths auto-detected as micrometers
    (x1000) unless a header mentions 'nm'; rows after a 'k' header ignored."""
    unit = 1000.0
    rows: list[tuple[float, float]] = []
    with open(path, "r", encoding="utf-8-sig") as fh:
        for line in fh:
            tokens = line.split()
            if not tokens:
                continue
            non_numeric = []
            numeric = []
            for tok in tokens:
                try:
                    numeric.append(float(tok.rstrip("f")))
                except ValueError:
                    non_numeric.append(tok)
            if non_numeric and any("nm" in t for t in non_numeric):
                unit = 1.0
            if len(non_numeric) >= 2 and non_numeric[1] == "k":
                break
            if len(numeric) >= 2:
                wl = numeric[0] * unit
                if not rows and wl > 2000.0 * unit / 1000.0 and unit == 1000.0:
                    unit = 100.0
                    wl = numeric[0] * unit
                rows.append((wl, numeric[1]))
    return rows


def refractive_index_at(spectrum: list[tuple[float, float]],
                        wavelength_nm: float) -> float:
    pts = sorted(spectrum)
    wl = np.array([p[0] for p in pts])
    n = np.array([p[1] for p in pts])
    return float(np.interp(wavelength_nm, wl, n))


def synthetic_brdf_table(material: str, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic 360x91 retro-reflectance table.

    Shaped like the real data: a diffuse floor falling off with incidence,
    plus a retro-reflective lobe near theta=90 (normal incidence in the
    reference's convention, where y=|cos|*90) whose sharpness tracks the
    material's (1 - roughness), plus a small azimuthal anisotropy so the phi
    axis is exercised.
    """
    rough = ROUGHNESS[material]
    mat_id = MATERIAL_ID[material]
    phi = np.arange(PHI_BUCKETS)[:, None] / PHI_BUCKETS * 2 * np.pi
    theta = np.arange(THETA_BUCKETS)[None, :] / (THETA_BUCKETS - 1.0)
    cos_inc = theta          # y axis is |cos| * 90 -> theta/90 == |cos|
    diffuse = 0.25 + 0.5 * rough
    lobe = (1.0 - rough) * np.power(cos_inc, 1.0 + 24.0 * (1.0 - rough))
    aniso = 0.05 * np.sin(phi * (2 + mat_id % 3) + mat_id)
    table = diffuse * cos_inc + lobe + aniso * cos_inc
    return np.clip(table, 0.0, 1.0).astype(np.float32)


@dataclass
class MaterialLibrary:
    """Host-side registry; emits per-wavelength MaterialTable pytrees
    (equivalent of `MaterialDatabase::getMaterialGPUArray`)."""

    names: list[str]
    roughness: np.ndarray                 # (M,)
    spectra: list[list[tuple[float, float]]]
    brdf_model: np.ndarray                # (M,) int32
    reflectivity_f0: np.ndarray           # (M, 3)
    tables: np.ndarray                    # (M, 360, 91) float32
    table_wavelengths: np.ndarray | None = None   # (W,) when spectral tables
    spectral_tables: np.ndarray | None = None     # (W, M, 360, 91)

    @staticmethod
    def default(refractive_index_dir: str | None = None) -> "MaterialLibrary":
        spectra = []
        bundled = bundled_spectra()
        for name in MATERIAL_NAMES:
            spec = bundled.get(name) or REFRACTIVE_SPECTRA[name]
            if refractive_index_dir:
                path = os.path.join(refractive_index_dir, f"{name}.txt")
                if os.path.exists(path):
                    parsed = parse_refractive_index_file(path)
                    if parsed:
                        spec = parsed
            spectra.append(spec)
        return MaterialLibrary(
            names=list(MATERIAL_NAMES),
            roughness=np.array([ROUGHNESS[n] for n in MATERIAL_NAMES],
                               np.float32),
            spectra=spectra,
            brdf_model=np.array([int(ANALYTIC_MODEL[n])
                                 for n in MATERIAL_NAMES], np.int32),
            reflectivity_f0=np.array([REFLECTIVITY_F0[n]
                                      for n in MATERIAL_NAMES], np.float32),
            tables=np.stack([synthetic_brdf_table(n) for n in MATERIAL_NAMES]),
        )

    def with_measured(self, folder: str,
                      reflectivity_map: dict[str, str] | None = None
                      ) -> "MaterialLibrary":
        """Replace synthetic tables with real RGL/EPFL measured BRDFs.

        ``folder`` holds `*.bsdf` tensor files (or a prebuilt
        `database.npz` cache); ``reflectivity_map`` maps our material names
        to measured-material names and defaults to the reference's
        `Reflectivity.txt` pairing (REFLECTIVITY_MEASURED_MAP, e.g.
        LEAF -> leaf_maple, `MaterialDatabase.cpp:69-99`).  Like the
        reference's `lookUpMaterial(name + "_spec")`, the "_spec"-suffixed
        database entry is preferred.  Unmapped materials keep their
        synthetic tables.
        """
        from .rgl_bsdf import BRDFDatabase
        db = BRDFDatabase(folder)
        if reflectivity_map is None:
            reflectivity_map = REFLECTIVITY_MEASURED_MAP
        W = len(db.wavelengths)
        spectral = np.empty((W, len(self.names), 360, 91), np.float32)
        spectral[:] = self.tables[None]
        for i, name in enumerate(self.names):
            measured = reflectivity_map.get(name, name)
            for candidate in (measured + "_spec", measured):
                if candidate in db.names:
                    spectral[:, i] = db.tables[db.material_id(candidate)]
                    break
        return dataclasses.replace(
            self, table_wavelengths=np.asarray(db.wavelengths),
            spectral_tables=spectral)

    def table_at(self, wavelength_nm: float) -> MaterialTable:
        """Materialize the table for one wavelength, as CPU tensors:
        n(lambda) interpolation + nearest-wavelength table slice."""
        n = np.array([refractive_index_at(s, wavelength_nm)
                      for s in self.spectra], np.float32)
        tables = self.tables
        if self.spectral_tables is not None:
            idx = int(np.argmin(np.abs(self.table_wavelengths
                                       - wavelength_nm)))
            tables = self.spectral_tables[idx]
        t = lambda a: torch.from_numpy(np.array(a))
        return MaterialTable(
            refractive_index=t(n),
            roughness=t(self.roughness),
            brdf_table=t(tables),
            brdf_model=t(self.brdf_model),
            reflectivity_f0=t(self.reflectivity_f0),
        )


def load_brdf_tables_npz(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load real measured tables from an .npz with arrays
    ``wavelengths`` (W,) and ``tables`` (W, M, 360, 91) — our binary-cache
    equivalent of the reference's `database.bin`."""
    data = np.load(path)
    return data["wavelengths"], data["tables"]


# Keyword -> material mapping used by sidecar files
# (`CADModel::readClassFile` longest-substring matching, cpp:466-540).
def match_keyword(name: str, keyword_map: dict[str, str]) -> str | None:
    """Longest-substring match of mesh/component name against keywords."""
    best, best_len = None, 0
    lname = name.lower()
    for keyword, value in keyword_map.items():
        if keyword.lower() in lname and len(keyword) > best_len:
            best, best_len = value, len(keyword)
    return best
