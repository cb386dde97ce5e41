"""The measured-BRDF table reads' backward: the port vs `jax.grad` of the
JAX package, in all three interpolation modes.

The port reads the table through `physics/brdf.py::TableRead` (one gather
of the (..., W) flat cells; its backward is `kernels/scatter.py::
table_scatter_add`, the plain `index_add_` here on the CPU), the JAX
package through its custom VJPs `_hermite_windows` / `_bilinear_windows`
(and a plain gather for RAW).  Identical numpy inputs (a random table, L,
N, material ids and loss weights from a seed) go through
`measured_brdf_factor` of both; loss = sum(w * factor).  Gradients w.r.t.
the table, L and N agree within atol 2e-4 * max|g_jax| and rtol 2e-3
(`tests/test_torch_grad.py`'s tolerance: the two frameworks sum
scatter-added cotangents in other orders and XLA's CPU backend contracts
multiply-adds into FMAs).  Cases: random reads, a hot cell (every read in
one cell), x wrapping at 359 -> 0, and y at its clamps (0, [89, 90), 90).

Also: the index helpers equal JAX's element for element; the forward
values equal bit for bit those of the plain-indexing reads the port used
before `TableRead` (kept below as `_indexed_*`); and the plain scatter-add
holds against a float64 `np.add.at` within n_c * 2^-23 * sum_c |g| a cell
(n_c contributions to cell c: two summation orders of n_c f32 values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.core.config import BRDFInterpolation
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.physics import brdf as jbrdf
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.kernels import scatter
from lidar_brdf_tpu_torch.physics import brdf as tbrdf

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

N_READS = 1500
CASES = ("random", "hot_cell", "x_wrap", "y_clamps")


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _materials(seed=0):
    """(JAX, port) material tables: the default library at 1064 nm with a
    random table in [0.1, 0.4] (a Hermite read, the sum of two splines,
    stays inside the [0, 1] clamp, so the factor's gradient reaches the
    table)."""
    m = MaterialLibrary.default().table_at(1064)
    table = np.random.default_rng(seed).uniform(
        0.1, 0.4, np.shape(m.brdf_table)).astype(np.float32)
    m = dataclasses.replace(m, brdf_table=jnp.asarray(table))
    arrays = {f.name: np.asarray(getattr(m, f.name))
              for f in dataclasses.fields(m)}
    return m, convert.materials_from_numpy(arrays)


def _perpendicular(L, rng):
    p = np.cross(L, rng.normal(0, 1, L.shape))
    return _unit(p)


def _reads(case, seed):
    """(L, N, mat, w) numpy inputs of ``N_READS`` reads."""
    rng = np.random.default_rng(seed)
    n = N_READS
    mat = rng.integers(0, 15, n).astype(np.int32)
    w = rng.normal(0, 1, n).astype(np.float32)
    if case == "random":
        L = _unit(rng.normal(0, 1, (n, 3)))
        N = _unit(rng.normal(0, 1, (n, 3)))
    elif case == "hot_cell":
        L = np.broadcast_to(_unit(np.array([0.3, 0.8, -0.5])), (n, 3)).copy()
        N = np.broadcast_to(_unit(np.array([0.1, 0.9, 0.2])), (n, 3)).copy()
        mat[:] = 7
    elif case == "x_wrap":
        # azimuths around 90 and -90 degrees: x = (atan2 + 90 deg) * 2 in
        # [358, 360) and [0, 2), so the neighbourhoods wrap 359 -> 0
        az = np.deg2rad(np.where(rng.random(n) < 0.5, 90.0, -90.0)
                        + rng.uniform(-1.0, 1.0, n))
        el = rng.uniform(-1.2, 1.2, n)
        L = _unit(np.stack([np.cos(el) * np.cos(az), np.sin(el),
                            np.cos(el) * np.sin(az)], -1))
        N = _unit(rng.normal(0, 1, (n, 3)))
    else:  # y_clamps: y = 0 (L _|_ N), y in [89, 90), y = 90 (L = N)
        L = _unit(rng.normal(0, 1, (n, 3)))
        P = _perpendicular(L, rng)
        third = n // 3
        N = np.empty_like(L)
        N[:third] = P[:third]
        cos = rng.uniform(0.9986, 0.99999, n - 2 * third)
        sin = np.sqrt(1.0 - cos ** 2)
        N[third:n - third] = _unit(L[third:n - third] * cos[:, None]
                                   + P[third:n - third] * sin[:, None])
        N[n - third:] = L[n - third:]
        # exact axes too: |dot| is exactly 1 there
        L[-8:] = N[-8:] = [[0.0, 1.0, 0.0]] * 4 + [[0.0, 0.0, -1.0]] * 4
    return L, N, mat, w


def _jax_grads(mj, L, N, mat, w, mode):
    def loss(table, L_, N_):
        m = dataclasses.replace(mj, brdf_table=table)
        f = jbrdf.measured_brdf_factor(m, jnp.asarray(mat), L_, N_, mode=mode)
        return jnp.sum(jnp.asarray(w) * f)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        mj.brdf_table, jnp.asarray(L), jnp.asarray(N))
    return float(val), [np.asarray(g) for g in grads]


def _torch_grads(mt, L, N, mat, w, mode):
    table = mt.brdf_table.detach().clone().requires_grad_(True)
    Lt = torch.from_numpy(L).requires_grad_(True)
    Nt = torch.from_numpy(N).requires_grad_(True)
    m = dataclasses.replace(mt, brdf_table=table)
    f = tbrdf.measured_brdf_factor(m, torch.from_numpy(mat), Lt, Nt,
                                   mode=mode)
    loss = (torch.from_numpy(w) * f).sum()
    loss.backward()
    # RAW reads are piecewise constant in L and N: no gradient reaches them
    return float(loss.detach()), [
        np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        for p in (table, Lt, Nt)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", list(BRDFInterpolation))
def test_table_read_grads_match_jax(mode, case):
    mj, mt = _materials()
    L, N, mat, w = _reads(case, seed=10 * int(mode) + CASES.index(case))
    lj, gj = _jax_grads(mj, L, N, mat, w, mode)
    lt, gt = _torch_grads(mt, L, N, mat, w, mode)
    # the loss sums signed terms: its error is relative to sum |w| (the
    # factor is at most 1), the forward's rtol 1e-5
    np.testing.assert_allclose(lt, lj, rtol=0,
                               atol=1e-5 * float(np.abs(w).sum()))
    for name, a, b in zip(("table", "L", "N"), gt, gj):
        assert np.isfinite(a).all(), name
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=name)
    # every read lands in the table gradient: as many non-zero cells
    assert np.count_nonzero(gt[0]) == np.count_nonzero(gj[0]) > 0
    if case == "hot_cell":
        assert np.count_nonzero(gt[0]) <= {BRDFInterpolation.RAW: 1,
                                           BRDFInterpolation.BILINEAR: 4,
                                           BRDFInterpolation.HERMITE: 7}[mode]


def _cells(case, seed=0):
    L, N, mat, _ = _reads(case, seed)
    x, y = jbrdf.table_angles(jnp.asarray(L), jnp.asarray(N))
    return np.asarray(x), np.asarray(y), mat


@pytest.mark.parametrize("case", CASES)
def test_elem_indices_match_jax(case):
    x, y, mat = _cells(case)
    xi = np.mod(np.floor(x).astype(np.int32), 360)
    yi = np.clip(np.floor(y).astype(np.int32), 0, 90)
    base = tbrdf._mat_base(torch.from_numpy(mat), torch.from_numpy(xi))
    assert base.dtype is torch.int32
    for jfn, tfn in ((jbrdf._hermite_elem_indices,
                      tbrdf._hermite_elem_indices),
                     (jbrdf._bilinear_elem_indices,
                      tbrdf._bilinear_elem_indices)):
        want = np.asarray(jfn(jnp.asarray(mat), jnp.asarray(xi),
                              jnp.asarray(yi)))
        got = tfn(base, torch.from_numpy(xi), torch.from_numpy(yi))
        assert got.dtype is torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if case == "x_wrap":
        assert (xi == 359).any() and (xi == 0).any()
    if case == "y_clamps":
        assert {0, 89, 90} <= set(yi.tolist())


# the port's reads before `TableRead`: one plain gather a cell, as PyTorch
# differentiates them (index_put_ with accumulate)
def _flat_index(mat, xi, yi):
    return (mat.long() * (360 * 91) + xi.long() * 91 + yi.long())


def _indexed_raw(tables, mat, x, y):
    xi = torch.remainder(x.to(torch.int32), 360)
    yi = torch.clamp(y.to(torch.int32), 0, 90)
    return tables.reshape(-1)[_flat_index(mat, xi, yi)]


def _indexed_bilinear(tables, mat, x, y):
    x0, y0 = torch.floor(x), torch.floor(y)
    xf, yf = x - x0, y - y0
    x0i = torch.remainder(x0.to(torch.int32), 360)
    y0i = torch.clamp(y0.to(torch.int32), 0, 90)
    x1i = torch.remainder(x0i + 1, 360)
    y1i = torch.clamp(y0i + 1, 0, 89)
    flat = tables.reshape(-1)
    v00 = flat[_flat_index(mat, x0i, y0i)]
    v10 = flat[_flat_index(mat, x1i, y0i)]
    v01 = flat[_flat_index(mat, x0i, y1i)]
    v11 = flat[_flat_index(mat, x1i, y1i)]
    return (v00 * (1 - xf) * (1 - yf) + v10 * xf * (1 - yf)
            + v01 * (1 - xf) * yf + v11 * xf * yf)


def _indexed_hermite(tables, mat, x, y, hermite):
    x0f, y0f = torch.floor(x), torch.floor(y)
    xf, yf = x - x0f, y - y0f
    xi = torch.remainder(x0f.to(torch.int32), 360)
    yi = torch.clamp(y0f.to(torch.int32), 0, 90)
    flat = tables.reshape(-1)
    y_row = torch.clamp(yi - 1, 0, 90)
    x_col = torch.remainder(xi - 1, 360)
    rx = [flat[_flat_index(mat, torch.remainder(xi + k - 1, 360), y_row)]
          for k in range(4)]
    ry = [flat[_flat_index(mat, x_col, torch.clamp(yi + k - 1, 0, 90))]
          for k in range(4)]

    def spline(r, f):
        c = [hermite[j][0] * r[0] + hermite[j][1] * r[1]
             + hermite[j][2] * r[2] + hermite[j][3] * r[3]
             for j in range(4)]
        return ((c[0] * f + c[1]) * f + c[2]) * f + c[3]

    return spline(rx, xf) + spline(ry, yf)


@pytest.mark.parametrize("case", CASES)
def test_reads_equal_the_plain_indexing_bit_for_bit(case):
    """Forward values of `lookup_*` equal those of the plain-indexing reads
    bit for bit; their table gradients agree within the scatter bound."""
    _, mt = _materials()
    L, N, mat, w = _reads(case, seed=3)
    x, y = tbrdf.table_angles(torch.from_numpy(L), torch.from_numpy(N))
    m = torch.from_numpy(mat)
    herm = tbrdf.hermite_matrix(0.5).tolist()
    for new, old in ((lambda t: tbrdf.lookup_raw(t, m, x, y),
                      lambda t: _indexed_raw(t, m, x, y)),
                     (lambda t: tbrdf.lookup_bilinear(t, m, x, y),
                      lambda t: _indexed_bilinear(t, m, x, y)),
                     (lambda t: tbrdf.lookup_hermite(t, m, x, y, herm),
                      lambda t: _indexed_hermite(t, m, x, y, herm))):
        grads = []
        for fn in (new, old):
            t = mt.brdf_table.detach().clone().requires_grad_(True)
            v = fn(t)
            (torch.from_numpy(w) * v).sum().backward()
            grads.append((v.detach(), t.grad))
        assert torch.equal(grads[0][0], grads[1][0])
        scale = float(grads[1][1].abs().max())
        torch.testing.assert_close(grads[0][1], grads[1][1],
                                   atol=2e-6 * scale, rtol=0)


def _scatter_case(n, w, n_cells, rng, hot=None):
    idx = rng.integers(0, n_cells, (n, w)).astype(np.int32)
    if hot is not None:
        idx[rng.random((n, w)) < 0.5] = hot
    g = rng.normal(0, 1, (n, w)).astype(np.float32)
    g[rng.random((n, w)) < 0.1] = 0.0
    return idx, g


def _assert_within_scatter_bound(got, idx, g, n_cells):
    """|got - sum| <= n_c * 2^-23 * sum_c |g| at each cell, the sum and
    its bound in float64."""
    want = np.zeros(n_cells)
    np.add.at(want, idx.reshape(-1), g.reshape(-1).astype(np.float64))
    mag = np.zeros(n_cells)
    np.add.at(mag, idx.reshape(-1), np.abs(g.reshape(-1)).astype(np.float64))
    count = np.bincount(idx.reshape(-1), minlength=n_cells)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= count * 2.0 ** -23 * mag).all(), float(err.max())


@pytest.mark.parametrize("shape", [(4099, 8), (1001, 4), (777, 1), (0, 8)])
def test_plain_scatter_matches_float64_add_at(shape):
    rng = np.random.default_rng(shape[0])
    n_cells = 15 * 360 * 91
    idx, g = _scatter_case(*shape, n_cells, rng, hot=12345)
    got = scatter.table_scatter_add_plain(torch.from_numpy(idx),
                                          torch.from_numpy(g), n_cells)
    assert got.dtype is torch.float32 and got.shape == (n_cells,)
    _assert_within_scatter_bound(got.numpy(), idx, g, n_cells)
    # on a CPU tensor the wrapper is the plain version, and launches nothing
    before = scatter.KERNEL.launches
    same = scatter.table_scatter_add(torch.from_numpy(idx),
                                     torch.from_numpy(g), n_cells)
    assert torch.equal(same, got) and scatter.KERNEL.launches == before


def test_plain_scatter_propagates_nan_and_skips_nothing():
    idx = np.array([[3, 3], [3, 5], [5, 9]], np.int32)
    g = np.array([[1.0, np.nan], [2.0, 0.0], [-0.0, 4.0]], np.float32)
    got = scatter.table_scatter_add_plain(torch.from_numpy(idx),
                                          torch.from_numpy(g), 10).numpy()
    assert np.isnan(got[3]) and got[9] == 4.0 and got[5] == 0.0
    assert np.signbit(got[5]) == np.False_
    assert np.count_nonzero(got[[0, 1, 2, 4, 6, 7, 8]]) == 0
