"""RGL/EPFL measured-BRDF ingestion (the reference's powitacq path).

The reference links the vendored ``powitacq`` library to evaluate
Dupuy-Jakob adaptively-parameterized measured BRDFs (`*.bsdf` tensor files)
and densely samples retro-reflectance f_r(wi == wo) onto a 360x91 grid per
wavelength (`BRDFDatabase::sampleBSDF`, BRDFDatabase.cpp:137-215;
`Libraries/bsdf/powitacq.inl`).  This module re-derives that pipeline in
vectorized numpy (host-side, once per database build):

  * `read_tensor_file` / `write_tensor_file` — the "tensor_file" v1.0
    binary container (powitacq.inl `Tensor::Tensor`)
  * `Marginal2D` — bilinear marginal-conditional 2D warp with parameter
    axes: `eval` and CDF `invert` (powitacq.inl `Marginal2D::eval/invert`),
    vectorized over sample batches
  * `RGLBrdf.eval(wi, wo)` — the measured-BRDF evaluation
    (powitacq.inl `BRDF::eval`): half-vector -> unit square, VNDF warp
    inversion, spectral interpolation, ndf / (4 sigma) normalization
  * `RGLBrdf.retro_table()` — the reference's 360x91 retro-reflectance
    sampling convention, including its quirks (unnormalized probe vector
    (cos phi, -sin phi, sin theta); theta row 0 = grazing)
  * `BRDFDatabase` — directory scan of `*.bsdf`, per-material tables,
    `.npz` binary cache (= reference `database.bin`), nearest-wavelength
    slicing (`lookUpMaterial`, BRDFDatabase.cpp:49-97)

The RGL data files themselves are not shipped (the reference repo does not
ship them either); `synthetic_tensor_file` writes structurally-valid files
for tests and demos.

Host numpy, copied from `lidar_brdf_tpu/io/rgl_bsdf.py` so that the
PyTorch port does not import the JAX package; the tables it builds reach
the card through `MaterialLibrary.with_measured` / `table_at`.
"""

from __future__ import annotations

import os
import struct

import numpy as np

PI = float(np.pi)

_DTYPE_CODE = {np.dtype("uint8"): 1, np.dtype("int8"): 2,
               np.dtype("uint16"): 3, np.dtype("int16"): 4,
               np.dtype("uint32"): 5, np.dtype("int32"): 6,
               np.dtype("uint64"): 7, np.dtype("int64"): 8,
               np.dtype("float16"): 9, np.dtype("float32"): 10,
               np.dtype("float64"): 11}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}


# ---------------------------------------------------------------------------
# tensor_file container
# ---------------------------------------------------------------------------

def read_tensor_file(path: str) -> dict[str, np.ndarray]:
    """Parse a "tensor_file" v1.0 container into name -> array."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file (bad magic)")
    if raw[12:14] != b"\x01\x00":
        raise ValueError(f"{path}: unsupported tensor_file version")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    fields: dict[str, np.ndarray] = {}
    cur = 18
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, cur); cur += 2
        name = raw[cur:cur + name_len].decode(); cur += name_len
        ndim, dtype = struct.unpack_from("<HB", raw, cur); cur += 3
        (offset,) = struct.unpack_from("<Q", raw, cur); cur += 8
        shape = struct.unpack_from(f"<{ndim}Q", raw, cur); cur += 8 * ndim
        dt = _CODE_DTYPE[dtype]
        count = int(np.prod(shape)) if ndim else 1
        arr = np.frombuffer(raw, dt, count=count, offset=offset)
        fields[name] = arr.reshape(shape).copy()
    return fields


def write_tensor_file(path: str, fields: dict[str, np.ndarray]) -> None:
    """Write a "tensor_file" v1.0 container (field order preserved)."""
    header_parts = []
    cur = 18
    for name, arr in fields.items():
        cur += 2 + len(name.encode()) + 3 + 8 + 8 * arr.ndim
    data_offset = cur
    blobs = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        header_parts.append(struct.pack("<H", len(nb)) + nb)
        header_parts.append(struct.pack(
            "<HBQ", arr.ndim, _DTYPE_CODE[arr.dtype], data_offset))
        header_parts.append(struct.pack(f"<{arr.ndim}Q", *arr.shape))
        blobs.append(arr.tobytes())
        data_offset += len(blobs[-1])
    with open(path, "wb") as fh:
        fh.write(b"tensor_file\x00\x01\x00")
        fh.write(struct.pack("<I", len(fields)))
        for part in header_parts:
            fh.write(part)
        for blob in blobs:
            fh.write(blob)


# ---------------------------------------------------------------------------
# Marginal-conditional 2D warp (vectorized powitacq `Marginal2D`)
# ---------------------------------------------------------------------------

class Marginal2D:
    """Bilinear 2D distribution with optional parameter axes.

    data shape: params + (ny, nx).  `eval`/`invert` take positions shaped
    (N, 2) in [0,1]^2 (x = last axis) and per-sample parameter values
    (N, n_params); both are vectorized over N.
    """

    def __init__(self, data: np.ndarray, param_values=(), *,
                 normalize: bool = True, build_cdf: bool = True):
        data = np.asarray(data, np.float64)
        self.param_values = [np.asarray(p, np.float64) for p in param_values]
        n_par = len(self.param_values)
        self.ny, self.nx = data.shape[-2:]
        slices = int(np.prod(data.shape[:-2])) if n_par else 1
        d = data.reshape(slices, self.ny, self.nx).copy()

        if build_cdf:
            # conditional CDF along x (trapezoid), marginal along y
            cond = np.zeros_like(d)
            cond[:, :, 1:] = np.cumsum(
                0.5 * (d[:, :, :-1] + d[:, :, 1:]), axis=2)
            marg = np.zeros((slices, self.ny))
            marg[:, 1:] = np.cumsum(
                0.5 * (cond[:, :-1, -1] + cond[:, 1:, -1]), axis=1)
            norm = 1.0 / marg[:, -1]
            self.cond_cdf = cond * norm[:, None, None]
            self.marg_cdf = marg * norm[:, None]
            self.data = d * norm[:, None, None]
        else:
            self.cond_cdf = None
            self.marg_cdf = None
            if normalize:
                cell = 0.25 * (d[:, :-1, :-1] + d[:, :-1, 1:]
                               + d[:, 1:, :-1] + d[:, 1:, 1:])
                norm = 1.0 / cell.sum(axis=(1, 2))
                # reference folds 1/hprod(inv_patch) in here and multiplies
                # it back in eval(); net effect: eval is unnormalized
                # bilinear times the normalization
                self.data = d * norm[:, None, None] \
                    * ((self.nx - 1) * (self.ny - 1))
            else:
                self.data = d
        # layout of slices: last param dim contiguous (powitacq strides)
        self.param_shape = tuple(len(p) for p in self.param_values)

    # -- parameter interpolation helpers -----------------------------------
    def _param_corners(self, params):
        """Per-sample (slice indices, weights) for 2^n_par corners."""
        n = params.shape[0] if params is not None else 1
        idx = []
        wts = []
        for dim, pv in enumerate(self.param_values):
            if len(pv) == 1:
                idx.append((np.zeros(n, np.int64), np.zeros(n, np.int64)))
                wts.append((np.ones(n), np.zeros(n)))
                continue
            p = params[:, dim]
            i0 = np.clip(np.searchsorted(pv, p, "right") - 1, 0, len(pv) - 2)
            w1 = np.clip((p - pv[i0]) / (pv[i0 + 1] - pv[i0]), 0.0, 1.0)
            idx.append((i0, i0 + 1))
            wts.append((1.0 - w1, w1))
        # corner expansion
        corners = [(np.zeros(params.shape[0] if params is not None else 1,
                             np.int64), 1.0)]
        strides = []
        s = 1
        for size in reversed(self.param_shape):
            strides.append(s if size > 1 else 0)
            s *= size
        strides = list(reversed(strides))
        out = []
        def rec(dim, slice_idx, weight):
            if dim == len(self.param_values):
                out.append((slice_idx, weight))
                return
            for k in (0, 1):
                rec(dim + 1, slice_idx + strides[dim] * idx[dim][k],
                    weight * wts[dim][k])
        rec(0, np.zeros(n, np.int64), np.ones(n))
        return out

    def _fetch(self, table, slice_corners, yi, xi):
        acc = 0.0
        for sl, w in slice_corners:
            acc = acc + w * table[sl, yi, xi]
        return acc

    def _fetch_marg(self, slice_corners, yi):
        acc = 0.0
        for sl, w in slice_corners:
            acc = acc + w * self.marg_cdf[sl, yi]
        return acc

    def eval(self, pos: np.ndarray, params: np.ndarray | None = None):
        """Bilinear lookup, powitacq `Marginal2D::eval` (N,) values."""
        pos = np.asarray(pos, np.float64)
        sx = pos[:, 0] * (self.nx - 1)
        sy = pos[:, 1] * (self.ny - 1)
        xi = np.clip(sx.astype(np.int64), 0, self.nx - 2)
        yi = np.clip(sy.astype(np.int64), 0, self.ny - 2)
        fx = sx - xi
        fy = sy - yi
        corners = self._param_corners(params)
        v00 = self._fetch(self.data, corners, yi, xi)
        v10 = self._fetch(self.data, corners, yi, xi + 1)
        v01 = self._fetch(self.data, corners, yi + 1, xi)
        v11 = self._fetch(self.data, corners, yi + 1, xi + 1)
        bil = ((1 - fy) * ((1 - fx) * v00 + fx * v10)
               + fy * ((1 - fx) * v01 + fx * v11))
        if self.cond_cdf is not None:
            return bil * (self.nx - 1) * (self.ny - 1)
        return bil

    def invert(self, pos: np.ndarray, params: np.ndarray | None = None):
        """CDF inversion, powitacq `Marginal2D::invert`: position ->
        (uniform sample, pdf)."""
        assert self.cond_cdf is not None, "invert requires build_cdf"
        pos = np.asarray(pos, np.float64)
        sx = pos[:, 0] * (self.nx - 1)
        sy = pos[:, 1] * (self.ny - 1)
        xi = np.clip(sx.astype(np.int64), 0, self.nx - 2)
        yi = np.clip(sy.astype(np.int64), 0, self.ny - 2)
        fx = sx - xi
        fy = sy - yi
        corners = self._param_corners(params)
        v00 = self._fetch(self.data, corners, yi, xi)
        v10 = self._fetch(self.data, corners, yi, xi + 1)
        v01 = self._fetch(self.data, corners, yi + 1, xi)
        v11 = self._fetch(self.data, corners, yi + 1, xi + 1)
        c0 = (1 - fy) * v00 + fy * v01
        c1 = (1 - fy) * v10 + fy * v11
        pdf = (1 - fx) * c0 + fx * c1
        x_out = fx * (c0 + 0.5 * fx * (c1 - c0))
        v0 = self._fetch(self.cond_cdf, corners, yi, xi)
        v1 = self._fetch(self.cond_cdf, corners, yi + 1, xi)
        x_out = x_out + (1 - fy) * v0 + fy * v1
        r0 = self._fetch(self.cond_cdf, corners, yi, np.full_like(xi, self.nx - 1))
        r1 = self._fetch(self.cond_cdf, corners, yi + 1, np.full_like(xi, self.nx - 1))
        x_out = x_out / ((1 - fy) * r0 + fy * r1)
        y_out = fy * (r0 + 0.5 * fy * (r1 - r0))
        y_out = y_out + self._fetch_marg(corners, yi)
        return (np.stack([x_out, y_out], axis=1),
                pdf * (self.nx - 1) * (self.ny - 1))


# ---------------------------------------------------------------------------
# Measured BRDF
# ---------------------------------------------------------------------------

def _elevation(d):
    """Robust acos(z) for *unit* d (powitacq.inl:1024); the reference feeds
    it unnormalized probe vectors — reproduced verbatim for parity."""
    return 2.0 * np.arcsin(0.5 * np.sqrt(
        d[:, 0] ** 2 + d[:, 1] ** 2 + (d[:, 2] - 1.0) ** 2))


def theta2u(theta):
    return np.sqrt(np.maximum(theta, 0.0) * (2.0 / PI))


def phi2u(phi):
    return (phi + PI) / (2.0 * PI)


class RGLBrdf:
    """One measured material (powitacq `BRDF`)."""

    def __init__(self, path_or_fields):
        tf = (read_tensor_file(path_or_fields)
              if isinstance(path_or_fields, str) else path_or_fields)
        phi_i = tf["phi_i"].astype(np.float64)
        theta_i = tf["theta_i"].astype(np.float64)
        self.isotropic = phi_i.shape[0] <= 2
        self.jacobian = bool(tf["jacobian"][0])
        self.wavelengths = tf["wavelengths"].astype(np.float64)
        self.ndf = Marginal2D(tf["ndf"], normalize=False, build_cdf=False)
        self.sigma = Marginal2D(tf["sigma"], normalize=False, build_cdf=False)
        self.vndf = Marginal2D(tf["vndf"], (phi_i, theta_i), build_cdf=True)
        self.luminance = Marginal2D(tf["luminance"], (phi_i, theta_i),
                                    build_cdf=True)
        self.spectra = Marginal2D(
            tf["spectra"], (phi_i, theta_i, self.wavelengths),
            normalize=False, build_cdf=False)

    def eval(self, wi: np.ndarray, wo: np.ndarray) -> np.ndarray:
        """f_r per wavelength: (N, n_wl) (powitacq `BRDF::eval`)."""
        wi = np.asarray(wi, np.float64).reshape(-1, 3)
        wo = np.asarray(wo, np.float64).reshape(-1, 3)
        n = wi.shape[0]
        valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
        wm = wi + wo
        wm = wm / np.maximum(np.linalg.norm(wm, axis=1, keepdims=True), 1e-30)
        theta_i = _elevation(wi)
        phi_i = np.arctan2(wi[:, 1], wi[:, 0])
        theta_m = _elevation(wm)
        phi_m = np.arctan2(wm[:, 1], wm[:, 0])
        u_wi = np.stack([theta2u(theta_i), phi2u(phi_i)], axis=1)
        phi_rel = phi_m - phi_i if self.isotropic else phi_m
        u_wm = np.stack([theta2u(theta_m), phi2u(phi_rel)], axis=1)
        u_wm[:, 1] -= np.floor(u_wm[:, 1])
        params = np.stack([phi_i, theta_i], axis=1)
        # NOTE the (x, y) convention: powitacq Vector2f(x=theta2u, y=phi2u)
        # indexes x along the LAST data axis — our Marginal2D matches.
        sample, _ = self.vndf.invert(u_wm, params)
        n_wl = len(self.wavelengths)
        fr = np.zeros((n, n_wl))
        for i, wl in enumerate(self.wavelengths):
            p3 = np.concatenate(
                [params, np.full((n, 1), wl)], axis=1)
            fr[:, i] = self.spectra.eval(sample, p3)
        scale = self.ndf.eval(u_wm) / (4.0 * np.maximum(
            self.sigma.eval(u_wi), 1e-30))
        fr *= scale[:, None]
        fr[~valid] = 0.0
        return np.maximum(fr, 0.0)

    def retro_table(self) -> np.ndarray:
        """(n_wl, 360, 91) retro-reflectance f_r(wi == wo).

        Exact reference convention (`BRDFDatabase::sampleBSDF` /
        `lookUpMaterial`, BRDFDatabase.cpp:58-66): phi row k probes
        azimuth 2*pi*k/360, theta column j probes elevation
        (1 - j/90) * pi/2, with the (unnormalized) probe vector
        (cos phi, -sin phi, sin theta) used for both wi and wo.
        """
        phi = np.arange(360) / 360.0 * 2.0 * PI
        theta = (1.0 - np.arange(91) / 90.0) * PI / 2.0
        pp, tt = np.meshgrid(phi, theta, indexing="ij")
        w = np.stack([np.cos(pp), -np.sin(pp), np.sin(tt)],
                     axis=-1).reshape(-1, 3)
        fr = self.eval(w, w)                        # (360*91, n_wl)
        return np.transpose(fr.reshape(360, 91, -1), (2, 0, 1))


# ---------------------------------------------------------------------------
# Database (reference BRDFDatabase)
# ---------------------------------------------------------------------------

class BRDFDatabase:
    """Directory of `*.bsdf` files -> per-material retro tables + cache.

    Mirrors `BRDFDatabase` (BRDFDatabase.cpp:15-135): scan the folder, sample
    each material, persist everything to one binary cache, and slice the
    nearest wavelength on lookup.
    """

    CACHE = "database.npz"

    def __init__(self, folder: str):
        self.folder = folder
        cache = os.path.join(folder, self.CACHE)
        files = sorted(f for f in os.listdir(folder) if f.endswith(".bsdf")) \
            if os.path.isdir(folder) else []
        if os.path.exists(cache):
            blob = np.load(cache, allow_pickle=False)
            self.names = list(blob["names"])
            self.wavelengths = blob["wavelengths"]
            self.tables = blob["tables"]            # (M, n_wl, 360, 91)
            return
        self.names = []
        self.wavelengths = None
        tables = []
        for fname in files:
            brdf = RGLBrdf(os.path.join(folder, fname))
            if self.wavelengths is None:
                self.wavelengths = brdf.wavelengths
            self.names.append(os.path.splitext(fname)[0])
            tables.append(brdf.retro_table())
        if not tables:
            raise FileNotFoundError(
                f"no *.bsdf files or {self.CACHE} in {folder!r}")
        self.tables = np.stack(tables).astype(np.float32)
        np.savez_compressed(
            cache, names=np.asarray(self.names),
            wavelengths=self.wavelengths, tables=self.tables)

    def material_id(self, name: str) -> int:
        return self.names.index(name)

    def find_wavelength_index(self, wl_nm: float) -> int:
        """Nearest wavelength (`findWavelengthIndex`, BRDFDatabase.cpp:80)."""
        return int(np.argmin(np.abs(self.wavelengths - wl_nm)))

    def lookup(self, material_id: int, wl_nm: float) -> np.ndarray:
        """(360, 91) table at the nearest measured wavelength."""
        return self.tables[material_id, self.find_wavelength_index(wl_nm)]


# ---------------------------------------------------------------------------
# Synthetic data (tests / demos; RGL data is not redistributable here)
# ---------------------------------------------------------------------------

def synthetic_tensor_file(path: str, *, n_theta_i=4, n_wl=3, res=16,
                          diffuse=0.5, seed=0) -> None:
    """Write a structurally-valid isotropic `.bsdf` with a flat VNDF.

    With constant ndf/sigma and a uniform vndf, `BRDF::eval` reduces to
    spectra(u_wm) * ndf / (4 sigma) — an analytically checkable case.
    """
    rng = np.random.default_rng(seed)
    theta_i = np.linspace(0.0, PI / 2 * 0.95, n_theta_i).astype(np.float32)
    phi_i = np.asarray([-PI, PI], np.float32)[:1]
    wavelengths = np.linspace(400.0, 1100.0, n_wl).astype(np.float32)
    ndf = np.full((res, res), 1.0, np.float32)
    sigma = np.full((res, res), 0.25, np.float32)
    vndf = np.full((1, n_theta_i, res, res), 1.0, np.float32)
    lum = np.full((1, n_theta_i, res, res), 1.0, np.float32)
    base = diffuse + 0.3 * rng.random(n_wl)
    spectra = np.broadcast_to(
        base[None, None, :, None, None].astype(np.float32),
        (1, n_theta_i, n_wl, res, res)).copy()
    write_tensor_file(path, {
        "description": np.frombuffer(b"synthetic", np.uint8).copy(),
        "phi_i": phi_i, "theta_i": theta_i,
        "ndf": ndf, "sigma": sigma, "vndf": vndf,
        "luminance": lum, "spectra": spectra,
        "wavelengths": wavelengths,
        "jacobian": np.zeros(1, np.uint8),
    })
