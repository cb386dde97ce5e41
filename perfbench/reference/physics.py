"""Plain reference of one fit step's loss: returns and measured-BRDF
shading of water-free, non-bathymetric scans, in plain PyTorch.

It follows the published model as the program states it
(`reduceCollisions-comp.glsl`, `computeColor-comp.glsl`,
`computeIntensity-comp.glsl`): per pulse the nearest hit among its rays
wins, rays inside the winner's footprint, on its face or on a face that
shares a vertex with it in the same component merge into it; a return is
kept within the noisy range and when the shininess loss model does not
drop it; the kept point is moved by the shiny-surface error; its intensity
is the radar equation with the cubic-Hermite read of the material's
360 x 91 table; the next return level takes the rays that
did not merge.  The loss is the sum of the kept returns' intensities.
Noise comes from the shared U[0, 1) buffer that `sim_noise` draws from the
seed, indexed by each ray's slot.

Nothing here comes from the program: hits from `traverse.py`, the noise
buffer and every scalar from the configuration.  Gradients are autograd's
through plain indexing.  Every float is computed in ``dtype`` (float32,
the configuration's precision; bfloat16 for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from .traverse import tree_for

SIM_NOISE_SIZE = 5_000_000
NUM_STREAMS = 16
DISTANCE_STREAM, LOSS_STREAM, POINT_STREAM, MODEL_COMP_STREAM = 0, 1, 2, 9
SHINY_DISTANCE_WEIGHT = 1.0 / 200.0
SHINY_MODEL_WEIGHT = 1.0 / 80.0
SHINY_INDIVIDUAL_ERROR = 1.0 / 100.0
PHI, THETA = 360, 91
_PI = np.float32(3.1415926535)
_HALF_PI = float(_PI / np.float32(2.0))
_DEG = float(np.float32(180.0) / _PI)
_U32 = 0xFFFFFFFF


def sim_noise(seed: int, device) -> torch.Tensor:
    """The U[0, 1) buffer of ``SIM_NOISE_SIZE`` values from a CPU
    generator seeded ``seed``, as (rows, 16) interleaved streams."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    buf = torch.rand(SIM_NOISE_SIZE, generator=g, dtype=torch.float32)
    rows = SIM_NOISE_SIZE // NUM_STREAMS
    return buf[:rows * NUM_STREAMS].view(rows, NUM_STREAMS).to(device)


def _big(x):
    """The largest finite value of ``x``'s dtype, shaped as ``x``."""
    return torch.full_like(x, torch.finfo(x.dtype).max)


def _rows(noise, index):
    return noise[(index & _U32) % noise.shape[0]]


def atmospheric_attenuation(sensor: dict, scene_min_y: float) -> float:
    if sensor["lidar_type"] == 0:
        return sensor["tls_atmospheric_clearness"] * (3.9 - 0.2) + 0.2
    new = 0.22 * (sensor["als_position"][1] - scene_min_y) / 1000.0
    return 0.22 + abs(0.22 - new)


# -- value-preserving helpers with bounded derivatives ---------------------

def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(v):
    return torch.sqrt(_dot(v, v) + 1e-24)


def _unit(v):
    return v / torch.sqrt(torch.clamp(_dot(v, v), min=1e-24))[..., None]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _atan2(y, x):
    ok = (y * y + x * x) > 1e-12
    ag = torch.atan2(torch.where(ok, y, torch.zeros_like(y)),
                     torch.where(ok, x, torch.ones_like(x)))
    return ag + (torch.atan2(y, x) - ag).detach()


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _hit(o, d, v0, v1, v2):
    """Moller-Trumbore t of each ray on its given triangle (the dtype's
    largest value where the test fails) and the facet normal."""
    e1, e2 = v1 - v0, v2 - v0
    h = _cross(d, e2)
    a = _dot(e1, h)
    f = torch.where(torch.abs(a) < 1e-8, torch.zeros_like(a),
                    1.0 / torch.where(a == 0, torch.ones_like(a), a))
    s = o - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(d, q)
    t = f * _dot(e2, q)
    ok = ((torch.abs(a) >= 1e-8) & (u >= 0) & (u <= 1) & (v >= 0)
          & (u + v <= 1) & (t >= -1e-8))
    n = _cross(e1, e2)
    normal = n / torch.sqrt(torch.clamp(_dot(n, n), min=1e-24))[..., None]
    return torch.where(ok, t, _big(t)), normal


# -- measured BRDF ----------------------------------------------------------

def _table_read(table, idx):
    return table.reshape(-1)[idx.long()]


def measured_brdf(table, mat, Lv, Nv, hermite_t: float):
    """The material's table read by cubic Hermite splines at the
    direction's (azimuth, |cos|) cell: one spline along x on row y - 1, one
    along y on column x - 1, summed, clipped to [0, 1]."""
    cos_ln = _Abs.apply(_dot(Lv, Nv))
    y = _clip(cos_ln, 0.0, 1.0) * _HALF_PI * _DEG
    x = torch.remainder((_atan2(Lv[..., 2], Lv[..., 0]) + _HALF_PI)
                        * 2.0 * _DEG, 360.0)
    base = mat.long() * (PHI * THETA)
    x0, y0 = torch.floor(x), torch.floor(y)
    xf, yf = x - x0, y - y0
    xi = torch.remainder(x0.long(), PHI)
    yi = torch.clamp(y0.long(), 0, THETA - 1)
    t = hermite_t
    H = [[-t, 2.0 - t, t - 2.0, t], [2.0 * t, t - 3.0, 3.0 - 2.0 * t, -t],
         [-t, 0.0, t, 0.0], [0.0, 1.0, 0.0, 0.0]]
    k = torch.arange(4, device=x.device)
    row = torch.clamp(yi - 1, 0, THETA - 1)
    col = torch.remainder(xi - 1, PHI)
    rx = _table_read(table, base[:, None] + row[:, None]
                     + torch.remainder(xi[:, None] + k - 1, PHI) * THETA)
    ry = _table_read(table, base[:, None] + col[:, None] * THETA
                     + torch.clamp(yi[:, None] + k - 1, 0, THETA - 1))

    def spline(r, f):
        c = [H[j][0] * r[:, 0] + H[j][1] * r[:, 1] + H[j][2] * r[:, 2]
             + H[j][3] * r[:, 3] for j in range(4)]
        return ((c[0] * f + c[1]) * f + c[2]) * f + c[3]

    return _clip(spline(rx, xf) + spline(ry, yf), 0.0, 1.0)


# -- one block of pulses ----------------------------------------------------

def block_loss(scene: dict, table, origin, direction, t_hit, face_hit,
               base: int, noise, sensor: dict, scene_min_y: float,
               records: dict | None = None):
    """Sum of the kept returns' intensities of pulses ``origin``,
    ``direction`` (P, R, 3), whose rays hit ``face_hit`` at ``t_hit`` (N,),
    and whose first ray has slot ``base``.  ``scene['vertices']``,
    ``table`` and ``origin`` may require grad.  Returns (loss, kept
    returns).  ``records``, when given, gets the kept returns' pulse
    (within the block), return number, point and intensity, and each
    pulse's number of returns."""
    if (sensor["include_terrain_induced_error"] or sensor["bathymetric"]
            or sensor["shading_mode"] != 0
            or sensor["brdf_interpolation"] != 2):
        raise ValueError("the reference covers water-free scans, measured "
                         "Hermite shading, no terrain-induced error")
    P, R = origin.shape[:2]
    N, L = P * R, sensor["max_returns"]
    dev, dt = origin.device, origin.dtype
    verts, faces = scene["vertices"], scene["faces"].long()
    comp_of = scene["face_comp"].long()
    comp_mat = scene["comp_material"].long()
    ks, ns = scene["vertex_ks"], scene["vertex_ns"]
    rough = scene["roughness"]
    o2, d2 = origin.reshape(N, 3), direction.reshape(N, 3)
    o_sg, d_sg, v_sg = o2.detach(), d2.detach(), verts.detach()
    faces_pr = face_hit.reshape(P, R)
    t_pr = t_hit.reshape(P, R).to(dt)
    hit_t = torch.where(face_hit >= 0, t_hit.to(dt), torch.zeros_like(t_pr)
                        .reshape(N))
    point_i = (o_sg + d_sg * hit_t[:, None]).reshape(P, R, 3)
    safe_pr = torch.clamp(faces_pr, min=0)
    pr_verts, pr_comp = faces[safe_pr], comp_of[safe_pr]
    b0, b1 = sensor["max_range_soft_boundary"]
    p_ar = torch.arange(P, device=dev)

    def shininess(face):
        s = (torch.pow(torch.clamp(ks[faces[face, 0]], min=0.0),
                       ns[faces[face, 0]]) * rough[comp_mat[comp_of[face]]])
        return _clip(s, 0.0, 1.0)

    active = torch.ones((P, R), dtype=torch.bool, device=dev)
    count = torch.zeros(P, dtype=torch.int64, device=dev)
    levels = []
    for _ in range(L):                                # decisions only
        valid = (faces_pr >= 0) & active
        w = torch.argmin(torch.where(valid, t_pr, _big(t_pr)),
                         dim=1)
        face_w = faces_pr[p_ar, w]
        has = valid[p_ar, w]
        fw = torch.clamp(face_w, min=0)
        o_w, d_w = o_sg[p_ar * R + w], d_sg[p_ar * R + w]
        tri = v_sg[faces[fw]]
        t_w, n_w = _hit(o_w, d_w, tri[:, 0], tri[:, 1], tri[:, 2])
        point_w = torch.where(has[:, None], o_w + d_w * t_w[:, None], o_w)
        dist_w = _norm(point_w - o_w)
        nd = -_unit(d_w)
        allowed = (2.0 * dist_w * sensor["pulse_radius"]
                   * (2.0 - torch.abs(_dot(n_w, nd))))
        near = _norm(point_i - point_w[:, None, :]) < allowed[:, None]
        shared = (pr_verts[:, :, :, None]
                  == faces[fw][:, None, None, :]).any(-1).any(-1)
        contiguous = shared & (pr_comp == comp_of[fw][:, None])
        same = (valid & has[:, None]
                & (near | (faces_pr == face_w[:, None]) | contiguous))
        cont = valid & ~same
        nz = _rows(noise, base + p_ar * R + w)
        noisy_max = (sensor["max_range"] + nz[:, DISTANCE_STREAM] * (b1 - b0)
                     + b0)
        sh = shininess(fw)
        loss_thr = torch.where(
            sh < sensor["loss_threshold"], torch.zeros_like(sh),
            sensor["loss_mult_coefficient"] * torch.pow(
                torch.clamp(sh + sensor["loss_add_coefficient"], min=0.0),
                sensor["loss_power"]))
        kept = (has & (dist_w < noisy_max)
                & ~(nz[:, LOSS_STREAM].to(dt) <= loss_thr))
        last = (count + 1) >= L
        active = torch.where(kept[:, None], cont & ~last[:, None], cont)
        levels.append((w, fw, kept, same.sum(1), count))
        count = count + kept.long()

    # record pass, with gradients, over the kept returns
    w = torch.cat([lv[0] for lv in levels])
    fw = torch.cat([lv[1] for lv in levels])
    kept = torch.cat([lv[2] for lv in levels])
    n_int = torch.cat([lv[3] for lv in levels])
    slot = p_ar.repeat(L) * R + w
    slot, fw, n_int = slot[kept], fw[kept], n_int[kept]
    o_w, d_w = o2[slot], d2[slot]
    tri = verts[faces[fw]]
    t_w, n_w = _hit(o_w, d_w, tri[:, 0], tri[:, 1], tri[:, 2])
    point = o_w + d_w * t_w[:, None]
    dist = _norm(point - o_w)
    nz = _rows(noise, base + slot)
    factor = 1.0 - shininess(fw)
    comp_rand = (_rows(noise, comp_of[fw])[:, MODEL_COMP_STREAM]
                 * SHINY_MODEL_WEIGHT)
    if sensor["include_shiny_surface_error"]:
        point = (point + d_w * (factor * factor * dist
                                * SHINY_DISTANCE_WEIGHT)[:, None]
                 + d_w * ((comp_rand + nz[:, POINT_STREAM]
                           * SHINY_INDIVIDUAL_ERROR) * factor)[:, None])
    brdf = measured_brdf(table, comp_mat[comp_of[fw]], _unit(o_w - point),
                         _unit(n_w), sensor["hermite_t"])
    ray_power = sensor["peak_power"] / float(R)
    atm = torch.pow(10.0, -2.0 * dist
                    * atmospheric_attenuation(sensor, scene_min_y) / 1.0e4)
    intensity = (ray_power * n_int.to(dt) * sensor["sensor_diameter"] ** 2
                 * brdf * sensor["reflectance_weight"] * atm
                 * sensor["system_attenuation"]
                 / (4.0 * torch.clamp(dist * dist, min=1e-12)))
    if records is not None:
        pulse = p_ar.repeat(L)[kept]
        records.update(
            pulse=pulse, point=point.detach(), intensity=intensity.detach(),
            return_number=torch.cat([lv[4] for lv in levels])[kept],
            num_returns=count[pulse])
    return intensity.sum(), int(kept.sum())


def fit_step(scene: dict, table, origin, direction, sensor: dict, *,
             noise_seed: int, scene_min_y: float, t_max: float,
             pulse_block: int, dtype=torch.float32) -> dict:
    """Loss and the gradients w.r.t. ``table``, ``origin`` and the scene's
    vertices of one fit step over all pulses of ``origin``, ``direction``
    (P, R, 3), in slot order; computed in blocks of ``pulse_block`` pulses.
    Returns float64 host numbers: ``loss``, ``returns`` and each leaf's
    gradient norm under ``grad_norm``."""
    dev = origin.device
    cast = lambda a: a.to(device=dev, dtype=dtype) \
        if torch.is_floating_point(a) else a.to(dev)
    sc = {k: cast(v) for k, v in scene.items()}
    leaf = lambda a: cast(a).detach().clone().requires_grad_()
    leaves = {"brdf_table": leaf(table), "origin": leaf(origin),
              "vertices": leaf(scene["vertices"])}
    sc["vertices"] = leaves["vertices"]
    direction = cast(direction)
    noise = sim_noise(noise_seed, dev).to(dtype)
    tree = tree_for(sc["vertices"].detach(), sc["faces"])
    P, R = origin.shape[:2]
    loss, kept = 0.0, 0
    for p0 in range(0, P, pulse_block):
        p1 = min(P, p0 + pulse_block)
        o, d = leaves["origin"][p0:p1], direction[p0:p1]
        t, face = tree.nearest_hits(o.detach().reshape(-1, 3),
                                    d.reshape(-1, 3), t_max)
        part, n = block_loss(sc, leaves["brdf_table"], o, d, t, face,
                             p0 * R, noise, sensor, scene_min_y)
        part.backward()
        loss += float(part.detach().double())
        kept += n
    return dict(loss=loss, returns=kept, grad_norm={
        k: float(v.grad.double().norm()) if v.grad is not None else 0.0
        for k, v in leaves.items()})


def scan_returns(scene: dict, table, origin, direction, sensor: dict, *,
                 noise_seed: int, scene_min_y: float, t_max: float,
                 pulse_block: int, dtype=torch.float32) -> dict:
    """Every kept return of a scan of the pulses ``origin``, ``direction``
    (P, R, 3), taking each pulse's noise slot as its index: host numpy
    ``pulse``, ``return_number``, ``num_returns``, ``position`` (K, 3) and
    ``intensity``, in float64."""
    dev = origin.device
    cast = lambda a: a.to(device=dev, dtype=dtype) \
        if torch.is_floating_point(a) else a.to(dev)
    sc = {k: cast(v) for k, v in scene.items()}
    table, origin, direction = cast(table), cast(origin), cast(direction)
    noise = sim_noise(noise_seed, dev).to(dtype)
    tree = tree_for(sc["vertices"], sc["faces"])
    P, R = origin.shape[:2]
    out = []
    with torch.no_grad():
        for p0 in range(0, P, pulse_block):
            o, d = origin[p0:p0 + pulse_block], direction[p0:p0 + pulse_block]
            t, face = tree.nearest_hits(o.reshape(-1, 3), d.reshape(-1, 3),
                                        t_max)
            rec = {}
            block_loss(sc, table, o, d, t, face, p0 * R, noise, sensor,
                       scene_min_y, records=rec)
            rec["pulse"] = rec["pulse"] + p0
            out.append({k: v.double().cpu().numpy() for k, v in rec.items()})
    cat = lambda k: np.concatenate([b[k] for b in out])
    return dict(pulse=cat("pulse").astype(np.int64),
                return_number=cat("return_number").astype(np.int64),
                num_returns=cat("num_returns").astype(np.int64),
                position=cat("point"), intensity=cat("intensity"))
