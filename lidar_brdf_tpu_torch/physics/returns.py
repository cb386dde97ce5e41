"""Pulse reduction and multi-return extraction, water-free path
(counterpart of `lidar_brdf_tpu/physics/returns.py`).

Semantics from `reduceCollisions-comp.glsl`:
  * per-pulse nearest-hit winner among the pulse's beam samples  (:186-199)
  * footprint merge radius 2*d*pulseRadius*(2-|cos|), same-face and
    contiguous-triangle merging                                  (:201-223)
  * scan angle, corrected distance, gps time += 2d/c             (:225-233)
  * validation: noisy max-range cut, per-return loss probability (:132-151)
  * shiny-surface and terrain-induced displacement errors        (:98-130)
plus the `addOutlier-comp.glsl` atmospheric outliers.

Only the water-free, non-bathymetric branch is ported (the main path);
water scenes, bathymetric mode and the packet walk raise
`NotImplementedError` until they are ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import SensorConfig
from ..core.types import (MaterialTable, RayBundle, SURFACE_TERRAIN,
                          TriangleScene, _TensorFields)
from ..geom.intersect import BIG, face_normal_from_verts, refine_hit_verts
from ..utils import noise as noise_mod
from ..utils.safemath import (clip, maximum, safe_arccos, safe_norm,
                              safe_unit)
from .types import OutlierRecord, ReturnRecord

LIGHT_SPEED = 299792458.0
PI = float(np.float32(3.1415926535))
_HALF_PI = float(np.float32(PI) / np.float32(2.0))

# Error-model weights (`reduceCollisions-comp.glsl:11-19`)
HORIZONTAL_TERRAIN_ERROR_W = 1.0 / 1000.0
VERTICAL_TERRAIN_ERROR_HEIGHT_W = 1e-4
VERTICAL_TERRAIN_ERROR_ANGLE_W = 0.5
SHINY_DISTANCE_WEIGHT = 1.0 / 200.0
SHINY_MODEL_WEIGHT = 1.0 / 80.0
SHINY_INDIVIDUAL_ERROR = 1.0 / 100.0

# Decorrelates outlier noise draws across return levels (see the JAX
# package): the level is mixed into the stream row.
OUTLIER_LEVEL_STRIDE = 1_299_721

_U32 = 0xFFFFFFFF


@dataclass
class SimScalars(_TensorFields):
    """Scalar parameters, as f32 tensors on the compute device."""

    peak_power: torch.Tensor
    pulse_radius: torch.Tensor
    max_range: torch.Tensor
    max_range_boundary: torch.Tensor      # (2,)
    loss_mult: torch.Tensor
    loss_add: torch.Tensor
    loss_power: torch.Tensor
    loss_threshold: torch.Tensor
    reflectance_weight: torch.Tensor
    sensor_diameter: torch.Tensor
    system_attenuation: torch.Tensor
    atmospheric_attenuation: torch.Tensor
    water_height: torch.Tensor
    outlier_threshold: torch.Tensor
    outlier_range: torch.Tensor           # (2,)

    @staticmethod
    def from_config(cfg: SensorConfig, scene_min_y: float = 0.0,
                    device="cpu") -> "SimScalars":
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return SimScalars(
            peak_power=f(cfg.peak_power),
            pulse_radius=f(cfg.pulse_radius),
            max_range=f(cfg.max_range),
            max_range_boundary=f(cfg.max_range_soft_boundary),
            loss_mult=f(cfg.loss_mult_coefficient),
            loss_add=f(cfg.loss_add_coefficient),
            loss_power=f(cfg.loss_power),
            loss_threshold=f(cfg.loss_threshold),
            reflectance_weight=f(cfg.reflectance_weight),
            sensor_diameter=f(cfg.sensor_diameter),
            system_attenuation=f(cfg.system_attenuation),
            atmospheric_attenuation=f(cfg.atmospheric_attenuation(scene_min_y)),
            water_height=f(cfg.water_height),
            outlier_threshold=f(cfg.outlier_threshold),
            outlier_range=f(cfg.outlier_range),
        )


# Packed per-face row layout (`build_face_pack`), float32 columns:
#   0:3 v0   3:6 v1   6:9 v2   9:11 uv0  11:13 uv1  13:15 uv2
#   15 ks  16 ns  17 refractive index  18 roughness  19 comp noise draw
#   20 comp id  21 material id  22 surface flags   (ints, exact in f32)
FACE_PACK_WIDTH = 23


def build_face_pack(scene: TriangleScene, materials: MaterialTable,
                    noise_buf: torch.Tensor) -> torch.Tensor:
    """(F, 23) f32: every per-winner face lookup in one row gather."""
    f = scene.faces.long()
    fc = scene.face_comp.long()
    vert_ksns = torch.stack([scene.vertex_ks, scene.vertex_ns], dim=1)
    comp_aug = torch.stack([scene.comp_material, scene.comp_surface], dim=1)
    crow = comp_aug[fc]                                           # (F, 2)
    mat_aug = torch.stack([materials.refractive_index, materials.roughness],
                          dim=1)
    mrow = mat_aug[crow[:, 0].long()]                             # (F, 2)
    comp_rand = noise_mod.stream_sample(noise_buf, fc,
                                        noise_mod.MODEL_COMP_STREAM)
    fl = torch.float32
    return torch.cat([
        scene.vertices[f[:, 0]], scene.vertices[f[:, 1]],
        scene.vertices[f[:, 2]],
        scene.vertex_uv[f[:, 0]], scene.vertex_uv[f[:, 1]],
        scene.vertex_uv[f[:, 2]],
        vert_ksns[f[:, 0]], mrow, comp_rand[:, None].to(fl),
        fc[:, None].to(fl), crow.to(fl),
    ], dim=1)


def _faces_contiguous(va, vb, comp_a, comp_b):
    """Same component and sharing >= 1 vertex (`areTriangleContiguous`)."""
    shared = (va[..., :, None] == vb[..., None, :]).any(dim=-1).any(dim=-1)
    return (comp_a == comp_b) & shared


def simulate_returns(scene: TriangleScene, materials: MaterialTable,
                     rays: RayBundle, noise_buf: torch.Tensor,
                     scalars: SimScalars, cfg: SensorConfig, *,
                     base_ray_index: int = 0, traverse_fn=None,
                     traverse_data=None, scene_has_water: bool = True,
                     face_pack=None):
    """Per-return extraction for one chunk of pulses.

    ``traverse_fn(origin, direction[, traverse_data]) -> Hit`` gives the
    level-0 hits.  ``face_pack``: None builds the (F, 23) pack when the
    scene has at most P * L faces (the JAX package's gate: the F-row build
    pays only when it replaces as many per-winner gathers), False never
    builds it (every winner gathers its own vertex, uv and material rows),
    a tensor is used as given.  Returns (records (L, P), outliers (L, P),
    num_returns (P,), final ray origins).
    """
    if scene_has_water or cfg.bathymetric:
        raise NotImplementedError(
            "water scenes and bathymetric mode need the refraction scan and "
            "the packet walk, which are not ported yet")
    if traverse_fn is None:
        raise NotImplementedError(
            "the packet walk (geom/packet.py) is not ported yet; pass the "
            "tile traverser")
    if traverse_data is not None:
        hits0 = traverse_fn(rays.origin, rays.direction, traverse_data)
    else:
        hits0 = traverse_fn(rays.origin, rays.direction)
    sensor_normal = (1.0, 0.0, 1.0) if cfg.is_terrestrial else (1.0, 1.0, 0.0)
    if face_pack is None:
        if scene.num_faces <= rays.num_pulses * max(cfg.max_returns, 1):
            face_pack = build_face_pack(scene, materials, noise_buf)
    elif face_pack is False:
        face_pack = None
    return _returns_noretraverse(
        scene, materials, rays, noise_buf, scalars, cfg, hits0, face_pack,
        base_ray_index, sensor_normal)


def _returns_noretraverse(scene: TriangleScene, materials: MaterialTable,
                          rays: RayBundle, noise_buf: torch.Tensor,
                          scalars: SimScalars, cfg: SensorConfig, hits0,
                          face_pack: torch.Tensor | None,
                          base_ray_index: int, sensor_normal: tuple):
    """Return extraction for water-free, non-bathymetric scenes.

    Continuing rays never change origin or direction, so across return
    levels only the active mask and per-pulse counters evolve: the level
    loop runs on detached values (decisions only), then every record field
    is computed once, vectorized over K = L * P slots.  With a face pack
    (F, 23) each winner reads one packed row; without (``face_pack`` None)
    it gathers its corner vertices, uvs, ks/ns and material rows from the
    scene arrays, as the JAX package's unpacked branch does.

    Gathers are plain indexing: their backward is autograd's accumulating
    `index_put_`.  The JAX package's custom VJPs around the same gathers
    (`_winner_rows`, `_winner_rows_pr`, `_winner_verts_union`) exist only
    to avoid serialized scatter on a TPU and give the same sums.
    """
    P, R = rays.num_pulses, rays.rays_per_pulse
    N = P * R
    L = cfg.max_returns
    dev = rays.origin.device
    base = int(base_ray_index) & _U32

    origin2 = rays.origin.reshape(N, 3)
    dir2 = rays.direction.reshape(N, 3)
    cat6 = torch.cat([origin2, dir2], dim=1)                   # (N, 6)

    # ---- detached world for the discrete loop ----------------------------
    o2_sg, d2_sg = origin2.detach(), dir2.detach()
    t2_sg = hits0.t.reshape(N).detach()
    face2 = hits0.face.reshape(N)
    t_pr_sg = t2_sg.reshape(P, R)
    faces_pr = face2.reshape(P, R)
    scal = scalars
    hit_t = torch.where(face2 >= 0, t2_sg, torch.zeros_like(t2_sg))
    point_i2_sg = o2_sg + d2_sg * hit_t[:, None]
    faces_aug = None
    if face_pack is None or scene.face_neighbors is None:
        #   faces_aug (F, 4): [v0, v1, v2, comp]
        faces_aug = torch.cat([scene.faces, scene.face_comp[:, None]], dim=1)
    if face_pack is None:
        #   comp_aug (C, 2): [material, surface]; vert_ksns (V, 2): [ks, ns];
        #   mat_aug (M, 2): [refractive_index, roughness]
        comp_aug = torch.stack([scene.comp_material, scene.comp_surface],
                               dim=1)
        vert_ksns = torch.stack([scene.vertex_ks, scene.vertex_ns], dim=1)
        mat_aug = torch.stack([materials.refractive_index,
                               materials.roughness], dim=1)
        verts_sg = scene.vertices.detach()
        vksns_sg, mat_aug_sg = vert_ksns.detach(), mat_aug.detach()
    else:
        fp_sg = face_pack.detach()

    def winner_static(flat_w, face_w, has_winner):
        o_w, d_w = o2_sg[flat_w], d2_sg[flat_w]
        safe_w = torch.clamp(face_w, min=0).long()
        if face_pack is not None:
            frow = fp_sg[safe_w]
            v0, v1, v2 = frow[:, 0:3], frow[:, 3:6], frow[:, 6:9]
            ksns, mrow = frow[:, 15:17], frow[:, 17:19]
        else:
            rows_w = faces_aug[safe_w].long()                  # (P, 4)
            v0 = verts_sg[rows_w[:, 0]]
            v1 = verts_sg[rows_w[:, 1]]
            v2 = verts_sg[rows_w[:, 2]]
            ksns = vksns_sg[rows_w[:, 0]]
            mrow = mat_aug_sg[comp_aug[rows_w[:, 3]][:, 0].long()]
        _, point_w, _, _ = refine_hit_verts(o_w, d_w, v0, v1, v2, face_w)
        point_w = torch.where(has_winner[:, None], point_w, o_w)
        normal_w = face_normal_from_verts(v0, v1, v2)
        return o_w, d_w, point_w, normal_w, ksns, mrow

    # ---- discrete level loop (L <= 5) -----------------------------------
    active = torch.ones(N, dtype=torch.bool, device=dev)
    count = torch.zeros(P, dtype=torch.int32, device=dev)
    p_arange = torch.arange(P, dtype=torch.int64, device=dev)
    levels = []
    for _ in range(L):
        valid2 = (face2 >= 0) & active
        valid_hit = valid2.reshape(P, R)
        dist = torch.where(valid_hit, t_pr_sg, torch.full_like(t_pr_sg, BIG))
        w = torch.argmin(dist, dim=1)                          # (P,)
        flat_w = p_arange * R + w
        face_w = face2[flat_w]
        has_winner = valid2[flat_w]
        (o_w, d_w, point_w, normal_w, ksns,
         mrow) = winner_static(flat_w, face_w, has_winner)

        # footprint merge (`reduceCollisions` :201-223), decisions only
        footprint = safe_norm(point_w - o_w) * scal.pulse_radius
        nd_w = -safe_unit(d_w)
        cos_inc = torch.abs(normal_w[:, 0] * nd_w[:, 0]
                            + normal_w[:, 1] * nd_w[:, 1]
                            + normal_w[:, 2] * nd_w[:, 2])
        allowed = 2.0 * footprint * (2.0 - cos_inc)
        d_to_winner = safe_norm(point_i2_sg.reshape(P, R, 3)
                                - point_w[:, None, :])
        safe_fw = torch.clamp(face_w, min=0).long()
        if faces_aug is None:
            cont_w = scene.face_neighbors[safe_fw]
            contiguous = (faces_pr[:, :, None]
                          == cont_w[:, None, :]).any(dim=-1)
        else:
            rows_i = faces_aug[torch.clamp(faces_pr, min=0).long()]
            rows_wf = faces_aug[safe_fw]
            contiguous = _faces_contiguous(
                rows_i[..., 0:3], rows_wf[:, None, 0:3],
                rows_i[..., 3], rows_wf[:, 3][:, None])
        same = (valid_hit
                & ((d_to_winner < allowed[:, None])
                   | (faces_pr == face_w[:, None])
                   | contiguous))
        same = same & has_winner[:, None]
        num_intersected = same.sum(dim=1).to(torch.int32)
        continue_ray = valid_hit & ~same

        # validation (`validateCollision` :132-151), decisions only
        corrected = safe_norm(point_w - o_w)
        nz = noise_mod.stream_rows(noise_buf, (base + flat_w) & _U32)
        dnoise = nz[:, noise_mod.DISTANCE_STREAM]
        b0 = scal.max_range_boundary[0]
        b1 = scal.max_range_boundary[1]
        noisy_max = scal.max_range + dnoise * (b1 - b0) + b0
        shininess = clip(torch.pow(maximum(ksns[:, 0], 0.0), ksns[:, 1])
                         * mrow[:, 1], 0.0, 1.0)
        loss_thr = torch.where(
            shininess < scal.loss_threshold, torch.zeros_like(shininess),
            scal.loss_mult * torch.pow(
                torch.clamp(shininess + scal.loss_add, min=0.0),
                scal.loss_power))
        lost = nz[:, noise_mod.LOSS_STREAM] <= loss_thr
        valid_col = has_winner & (corrected < noisy_max) & ~lost

        exceed = (count + 1) >= L
        new_active_valid = (~exceed[:, None]) & continue_ray
        active = torch.where(valid_col[:, None], new_active_valid,
                             continue_ray).reshape(N)
        levels.append(dict(flat_w=flat_w, w=w, face_w=face_w,
                           has_winner=has_winner, valid_col=valid_col,
                           num_intersected=num_intersected,
                           count_entry=count))
        count = count + valid_col.to(torch.int32)
    num_returns = count

    # ---- record pass, vectorized over K = L * P -------------------------
    st = lambda k: torch.stack([lv[k] for lv in levels])       # (L, P)
    K = L * P
    flat_w_K = st("flat_w").reshape(K)
    face_w_K = st("face_w").reshape(K)
    has_winner = st("has_winner").reshape(K)
    valid_col_L = st("valid_col")
    valid_col = valid_col_L.reshape(K)

    pack = cat6[flat_w_K]                                       # (K, 6)
    origin_w = pack[:, 0:3]         # == start point (origins never move)
    dir_w = pack[:, 3:6]            # == previousDirection

    safe_face = torch.clamp(face_w_K, min=0).long()
    if face_pack is not None:
        frow = face_pack[safe_face]                             # (K, 23)
        v0, v1, v2 = frow[:, 0:3], frow[:, 3:6], frow[:, 6:9]
        uv0, uv1, uv2 = frow[:, 9:11], frow[:, 11:13], frow[:, 13:15]
        ksns, mrow = frow[:, 15:17], frow[:, 17:19]
        comp_rand_sh = frow[:, 19]
        comp_w = frow[:, 20].to(torch.int32)
        mat_w = frow[:, 21].to(torch.int32)
        surface_w = frow[:, 22].to(torch.int32)
    else:
        rows_w = faces_aug[safe_face]                           # (K, 4)
        vidx = rows_w[:, 0:3].long()
        verts3 = scene.vertices[vidx]                           # (K, 3, 3)
        v0, v1, v2 = verts3[:, 0], verts3[:, 1], verts3[:, 2]
        uvs = scene.vertex_uv[vidx]                             # (K, 3, 2)
        uv0, uv1, uv2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        ksns = vert_ksns[vidx[:, 0]]
        comp_w = rows_w[:, 3]
        crow_w = comp_aug[comp_w.long()]
        mat_w, surface_w = crow_w[:, 0], crow_w[:, 1]
        mrow = mat_aug[mat_w.long()]
        comp_rand_sh = noise_mod.stream_sample(noise_buf, comp_w,
                                               noise_mod.MODEL_COMP_STREAM)

    _, point_w, (u_w, v_w), _ = refine_hit_verts(origin_w, dir_w, v0, v1, v2,
                                                 face_w_K)
    normal_w = face_normal_from_verts(v0, v1, v2)
    point_w = torch.where(has_winner[:, None], point_w, origin_w)
    is_terrain = (surface_w & SURFACE_TERRAIN) != 0

    corrected = safe_norm(point_w - origin_w)
    nd = safe_unit(-dir_w)
    # (nd * sensor_normal * nd) summed, with the normal as host floats: a
    # small device constant would cost a host-to-device copy (a host sync)
    # on every call
    ang = [nd[:, k] * sensor_normal[k] * nd[:, k] for k in range(3)]
    angle = (clip(safe_arccos(ang[0] + ang[1] + ang[2]),
                  -_HALF_PI, _HALF_PI) / _HALF_PI * 90.0)
    gps = rays.gps_time.repeat(L) + corrected * 2.0 / LIGHT_SPEED

    nz = noise_mod.stream_rows(noise_buf, (base + flat_w_K) & _U32)
    shininess = clip(torch.pow(maximum(ksns[:, 0], 0.0), ksns[:, 1])
                     * mrow[:, 1], 0.0, 1.0)

    point_rec = point_w
    if cfg.include_shiny_surface_error:
        factor = 1.0 - shininess
        comp_rand = comp_rand_sh * SHINY_MODEL_WEIGHT
        pt_rand = nz[:, noise_mod.POINT_STREAM] * SHINY_INDIVIDUAL_ERROR
        shift = (dir_w * (factor * factor * corrected
                          * SHINY_DISTANCE_WEIGHT)[:, None]
                 + dir_w * ((comp_rand + pt_rand) * factor)[:, None])
        point_rec = point_rec + shift
    if cfg.include_terrain_induced_error:
        height = origin_w[:, 1] - point_rec[:, 1]
        vn = nz[:, noise_mod.TERRAIN_V_STREAM]
        hn = nz[:, noise_mod.TERRAIN_H_STREAM]
        v_err = vn * (VERTICAL_TERRAIN_ERROR_HEIGHT_W * height
                      + VERTICAL_TERRAIN_ERROR_ANGLE_W * angle)
        h_err = hn * HORIZONTAL_TERRAIN_ERROR_W * height
        h_axis = torch.stack([nz[:, noise_mod.AXIS_X_STREAM],
                              torch.zeros_like(v_err),
                              nz[:, noise_mod.AXIS_Z_STREAM]], -1)
        up = torch.stack([0.0 * v_err, 1.0 * v_err, 0.0 * v_err], -1)
        shift = up + h_axis * h_err[:, None]
        point_rec = torch.where((is_terrain & valid_col)[:, None],
                                point_rec + shift, point_rec)

    uv_rec = (uv0 * (1.0 - u_w - v_w)[:, None]
              + uv1 * u_w[:, None]
              + uv2 * v_w[:, None])

    # previous recorded point per pulse (record field only)
    point_rec_L = point_rec.reshape(L, P, 3)
    prev_points = []
    prev = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    for lvl in range(L):
        prev_points.append(prev)
        prev = torch.where(valid_col_L[lvl][:, None], point_rec_L[lvl], prev)

    unfl = lambda a: a.reshape((L, P) + tuple(a.shape[1:]))
    z = lambda v: unfl(torch.where(valid_col, v, torch.zeros_like(v)))
    zv = lambda v: unfl(torch.where(valid_col[:, None], v,
                                    torch.zeros_like(v)))
    records = ReturnRecord(
        mask=valid_col_L,
        point=zv(point_rec),
        normal=zv(normal_w),
        uv=zv(uv_rec),
        distance=z(corrected),
        angle=z(angle),
        gps_time=z(gps),
        comp=unfl(torch.where(valid_col, comp_w, torch.full_like(comp_w, -1))),
        material=unfl(torch.where(valid_col, mat_w, torch.zeros_like(mat_w))),
        face=unfl(torch.where(valid_col, face_w_K.to(torch.int32),
                              torch.full_like(comp_w, -1))),
        num_intersected=st("num_intersected"),
        return_number=st("count_entry"),
        winner_ray=st("w").to(torch.int32),
        start=unfl(origin_w),
        direction=unfl(dir_w),
        prev_was_water=torch.zeros((L, P), dtype=torch.bool, device=dev),
        prev_point=torch.stack(prev_points),
    )

    # outliers (`addOutlier-comp.glsl:29-64`)
    pulse_gidx = base // max(R, 1) + torch.arange(P, device=dev)
    lvl_idx = torch.arange(L, device=dev).repeat_interleave(P)
    onz = noise_mod.stream_rows(
        noise_buf, (pulse_gidx.repeat(L) + lvl_idx * OUTLIER_LEVEL_STRIDE)
        & _U32)
    o_prob = onz[:, noise_mod.OUTLIER_STREAM]
    if cfg.include_outliers:
        o_mask = valid_col & ((o_prob * 2.0 - 1.0) > scalars.outlier_threshold)
    else:
        o_mask = torch.zeros_like(valid_col)
    o_dn = onz[:, noise_mod.OUTLIER_DISTANCE_STREAM] * 1.5
    o_r0, o_r1 = scalars.outlier_range[0], scalars.outlier_range[1]
    o_dist = (o_dn * (o_r1 - o_r0) + o_r0) * corrected
    outliers = OutlierRecord(
        mask=unfl(o_mask),
        point=unfl(origin_w + safe_unit(dir_w) * o_dist[:, None]),
        distance=unfl(o_dist),
    )
    return records, outliers, num_returns, rays.origin
