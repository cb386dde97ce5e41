"""Pulse reduction and multi-return extraction (counterpart of
`lidar_brdf_tpu/physics/returns.py`).

Semantics from `reduceCollisions-comp.glsl`:
  * per-pulse nearest-hit winner among the pulse's beam samples  (:186-199)
  * footprint merge radius 2*d*pulseRadius*(2-|cos|), same-face and
    contiguous-triangle merging                                  (:201-223)
  * scan angle, corrected distance, gps time += 2d/c             (:225-233)
  * validation: noisy max-range cut, per-return loss probability, water
    single-bounce rule                                           (:132-151)
  * shiny-surface and terrain-induced displacement errors        (:98-130)
  * next-bounce state: refraction through water, returnNumber++  (:152-170)
plus the `addOutlier-comp.glsl` atmospheric outliers.

Two paths, as in the JAX package.  Water-free, non-bathymetric scenes never
move a ray, so their level loop is discrete and every record field is
computed once afterwards (`_returns_noretraverse`).  Water scenes and
bathymetric mode refract rays at water hits and walk the whole tree again
for every bounce level (`_returns_retraverse`: the JAX package's
`lax.scan`, here a Python loop over the few return levels).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import SensorConfig
from ..core.types import (MaterialTable, RayBundle, SURFACE_TERRAIN,
                          SURFACE_WATER, TriangleScene, _TensorFields)
from ..geom.intersect import BIG, face_normal_from_verts, refine_hit_verts
from ..runtime.metrics import span
from ..utils import noise as noise_mod
from ..utils.safemath import (clip, dot3, maximum, safe_arccos, safe_norm,
                              safe_sqrt, safe_unit)
from .rows import gather_rows
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
        gather_rows(scene.vertices, f).reshape(-1, 9),
        gather_rows(scene.vertex_uv, f).reshape(-1, 6),
        gather_rows(vert_ksns, f[:, 0]), mrow, comp_rand[:, None].to(fl),
        fc[:, None].to(fl), crow.to(fl),
    ], dim=1)


def packs_faces(num_faces: int, num_pulses: int, max_returns: int) -> bool:
    """Whether `simulate_returns` builds the face pack itself: the scene has
    at most P * L faces (the JAX package's gate: the F-row build pays only
    when it replaces as many per-winner gathers)."""
    return num_faces <= num_pulses * max(max_returns, 1)


def _faces_contiguous(va, vb, comp_a, comp_b):
    """Same component and sharing >= 1 vertex (`areTriangleContiguous`)."""
    shared = (va[..., :, None] == vb[..., None, :]).any(dim=-1).any(dim=-1)
    return (comp_a == comp_b) & shared


def _scan_angle(nd, sensor_normal: tuple):
    """Scan angle in degrees, acos(sum(nd * sensor_normal * nd)) of the
    unit reverse direction nd, clipped to [-90, 90] (`reduceCollisions`
    :225-233).  The normal is host floats (a small device constant would
    cost a host-to-device copy, a host sync, on every call).  The sum is
    taken in nd's dtype and rounded once to float32."""
    ang = [nd[:, k] * sensor_normal[k] * nd[:, k] for k in range(3)]
    arg = (ang[0] + ang[1] + ang[2]).to(torch.float32)
    return (clip(safe_arccos(arg), -_HALF_PI, _HALF_PI) / _HALF_PI * 90.0)


def _displace(point_w, dir_w, start_w, corrected, angle, shininess,
              comp_rand, nz, terrain, cfg):
    """The recorded point: the winner's hit moved by the shiny-surface
    error along the ray and, on ``terrain`` slots, the terrain-induced
    error (`reduceCollisions-comp.glsl:98-130`).  ``comp_rand`` is the
    component's noise draw, ``nz`` the winner ray's noise row."""
    point_rec = point_w
    if cfg.include_shiny_surface_error:
        factor = 1.0 - shininess
        comp_rand = comp_rand * SHINY_MODEL_WEIGHT
        pt_rand = nz[:, noise_mod.POINT_STREAM] * SHINY_INDIVIDUAL_ERROR
        shift = (dir_w * (factor * factor * corrected
                          * SHINY_DISTANCE_WEIGHT)[:, None]
                 + dir_w * ((comp_rand + pt_rand) * factor)[:, None])
        point_rec = point_rec + shift
    if cfg.include_terrain_induced_error:
        height = start_w[:, 1] - point_rec[:, 1]
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
        point_rec = torch.where(terrain[:, None], point_rec + shift,
                                point_rec)
    return point_rec


def _refract(I, N, eta):
    """GLSL refract(I, N, eta) (used by `computeRayDirection`, :64-73)."""
    cosi = dot3(N, I)[..., None]
    k = 1.0 - eta[..., None] ** 2 * (1.0 - cosi ** 2)
    refr = eta[..., None] * I - (eta[..., None] * cosi + safe_sqrt(k)) * N
    return torch.where(k < 0.0, torch.zeros_like(refr), refr)


def simulate_returns(scene: TriangleScene, materials: MaterialTable,
                     rays: RayBundle, noise_buf: torch.Tensor,
                     scalars: SimScalars, cfg: SensorConfig, *,
                     base_ray_index: int = 0, traverse_fn=None,
                     traverse_data=None, scene_has_water: bool = True,
                     face_pack=None, packet_fn=None):
    """Per-return extraction for one chunk of pulses.

    ``traverse_fn(origin, direction[, traverse_data]) -> Hit`` gives the
    level-0 hits.  ``packet_fn(origin, direction, active=None) -> Hit`` is
    the packet walk over the whole scene (`geom/packet.py::
    make_packet_traverser`, packed once by the caller); it stands in for a
    missing ``traverse_fn``.  On water scenes (``scene_has_water``) and in
    bathymetric mode the refracted bounce levels traverse again: on
    ``packet_fn`` when level 0 was culled (``traverse_data``: candidates
    cover only the rays the host saw; the hybrid), else on level 0's
    traverser, as in the JAX package.  When a bounce level walks on
    ``packet_fn`` it hands it the level's active mask (``active``, the
    rays' leading shape), and only those rays walk; a caller's
    ``traverse_fn`` is called with the rays alone.  ``face_pack``: None
    builds the (F, 23) pack where `packs_faces`, False never builds it
    (every winner gathers its own vertex, uv and material rows), a tensor
    is used as given.  Returns (records (L, P), outliers (L, P),
    num_returns (P,), final ray origins (P, R, 3)).
    """
    retraverse = bool(cfg.bathymetric) or scene_has_water
    hybrid = retraverse and traverse_data is not None
    if packet_fn is None and (traverse_fn is None or hybrid):
        raise ValueError("this chunk needs the packet walk: pass packet_fn "
                         "(geom/packet.py::make_packet_traverser)")
    if traverse_fn is None:
        traverse_fn = packet_fn
    with span("lbt.traverse"):
        if traverse_data is not None:
            hits0 = traverse_fn(rays.origin, rays.direction, traverse_data)
        else:
            hits0 = traverse_fn(rays.origin, rays.direction)
    bounce_fn = packet_fn if hybrid else traverse_fn
    sensor_normal = (1.0, 0.0, 1.0) if cfg.is_terrestrial else (1.0, 1.0, 0.0)
    if face_pack is None:
        if packs_faces(scene.num_faces, rays.num_pulses, cfg.max_returns):
            face_pack = build_face_pack(scene, materials, noise_buf)
    elif face_pack is False:
        face_pack = None
    if not retraverse:
        return _returns_noretraverse(
            scene, materials, rays, noise_buf, scalars, cfg, hits0,
            face_pack, base_ray_index, sensor_normal)
    return _returns_retraverse(
        scene, materials, rays, noise_buf, scalars, cfg, hits0, face_pack,
        base_ray_index, sensor_normal, bounce_fn, bounce_fn is packet_fn)


def _stack(records) -> object:
    """Records of the levels, one per level, stacked into one (L, ...)."""
    cls = type(records[0])
    return cls(**{f: torch.stack([getattr(r, f) for r in records])
                  for f in cls.__dataclass_fields__})


def _returns_retraverse(scene: TriangleScene, materials: MaterialTable,
                        rays: RayBundle, noise_buf: torch.Tensor,
                        scalars: SimScalars, cfg: SensorConfig, hits0,
                        face_pack: torch.Tensor | None, base_ray_index: int,
                        sensor_normal: tuple, bounce_fn,
                        bounce_masked: bool):
    """Return extraction for water scenes and bathymetric mode.

    A water hit refracts the rays that go on (`computeRayDirection`), so
    every bounce level traverses again (``bounce_fn``) from the rays' new
    origins and directions.  Per-ray state is flat (N = P * R
    rows), as in the JAX package's scan; level 0 takes ``hits0``.  Every
    record field stays differentiable where the JAX package's is: through
    the ray state (origins move to refracted water hits), the winner rows
    and the face rows; the traversals are forward-only.  The row gathers
    are `gather_rows`, on K7 on the card, but for the component and
    material tables' (see `_returns_noretraverse`).
    With ``bounce_masked`` (the bounce traverser is the packet walk) each
    bounce level hands ``bounce_fn`` the rays still active and only those
    walk: the records read a ray's hit only where it is active
    (``valid2``), and an inactive ray gets the miss.  Else every ray walks,
    as in the JAX package.
    """
    P, R = rays.num_pulses, rays.rays_per_pulse
    N = P * R
    max_returns = cfg.max_returns
    bathymetric = bool(cfg.bathymetric)
    dev = rays.origin.device
    base = int(base_ray_index) & _U32
    start2 = rays.origin.reshape(N, 3)
    p_arange = torch.arange(P, dtype=torch.int64, device=dev)
    pulse_gidx = base // max(R, 1) + p_arange
    rep = lambda x: x[:, None].expand(P, R).reshape(N)
    repv = lambda x: x[:, None, :].expand(P, R, x.shape[-1]).reshape(N, -1)

    faces_aug = None
    if face_pack is None or scene.face_neighbors is None:
        #   faces_aug (F, 4): [v0, v1, v2, comp]
        faces_aug = torch.cat([scene.faces, scene.face_comp[:, None]], dim=1)
    if face_pack is None:
        comp_aug = torch.stack([scene.comp_material, scene.comp_surface],
                               dim=1)
        vert_ksns = torch.stack([scene.vertex_ks, scene.vertex_ns], dim=1)
        mat_aug = torch.stack([materials.refractive_index,
                               materials.roughness], dim=1)

    def step(state, hits, level):
        (origin2, dir2, prev2, active2, return_count, prev_water,
         prev_point) = state
        t2 = hits.t.reshape(N)
        face2 = hits.face.reshape(N)
        faces_pr = face2.reshape(P, R)
        valid2 = (face2 >= 0) & active2
        valid_hit = valid2.reshape(P, R)
        t_pr = t2.reshape(P, R)
        w = torch.argmin(torch.where(valid_hit, t_pr,
                                     torch.full_like(t_pr, BIG)), dim=1)
        flat_w = p_arange * R + w
        origin_w = gather_rows(origin2, flat_w)
        dir_w = gather_rows(dir2, flat_w)
        start_w = gather_rows(start2, flat_w)
        prev_dir_w_raw = gather_rows(prev2, flat_w)
        face_w = face2[flat_w]
        has_winner = valid2[flat_w]
        safe_fw = torch.clamp(face_w, min=0).long()
        if face_pack is not None:
            frow = gather_rows(face_pack, safe_fw)              # (P, 23)
            v0, v1, v2 = frow[:, 0:3], frow[:, 3:6], frow[:, 6:9]
            verts_w = None
            comp_w = frow[:, 20].to(torch.int32)
            mat_w = frow[:, 21].to(torch.int32)
            surface_w = frow[:, 22].to(torch.int32)
        else:
            rows_w = gather_rows(faces_aug, safe_fw)            # (P, 4)
            verts_w = rows_w[:, 0:3].long()
            v0, v1, v2 = gather_rows(scene.vertices, verts_w).unbind(1)
            comp_w = rows_w[:, 3]
            crow_w = comp_aug[comp_w.long()]
            mat_w, surface_w = crow_w[:, 0], crow_w[:, 1]
        _, point_w, (u_w, v_w), _ = refine_hit_verts(origin_w, dir_w, v0, v1,
                                                     v2, face_w)
        normal_w = face_normal_from_verts(v0, v1, v2)
        # a pulse without a winner refines against face 0 at t = BIG: pin
        # it to the ray origin (finite, gradient-neutral, never read)
        point_w = torch.where(has_winner[:, None], point_w, origin_w)
        is_water = (surface_w & SURFACE_WATER) != 0
        is_terrain = (surface_w & SURFACE_TERRAIN) != 0

        # per-ray hit points (they move water-hit origins and drive the
        # discrete merge decisions)
        hit_t = torch.where(valid2, t2, torch.zeros_like(t2))
        point_i2 = origin2 + dir2 * hit_t[:, None]

        # footprint merge (`reduceCollisions` :201-223)
        footprint = safe_norm(point_w - start_w) * scalars.pulse_radius
        cos_inc = torch.abs(dot3(normal_w, -safe_unit(dir_w)))
        allowed = 2.0 * footprint * (2.0 - cos_inc)
        d_to_winner = safe_norm(point_i2.reshape(P, R, 3)
                                - point_w[:, None, :])
        if scene.face_neighbors is not None:
            cont_w = gather_rows(scene.face_neighbors, safe_fw)
            contiguous = (faces_pr[:, :, None]
                          == cont_w[:, None, :]).any(dim=-1)
        else:
            rows_i = gather_rows(faces_aug,
                                 torch.clamp(faces_pr, min=0).long())
            if verts_w is None:
                verts_w = gather_rows(faces_aug, safe_fw)[:, 0:3]
            contiguous = _faces_contiguous(
                rows_i[..., 0:3], verts_w[:, None, :],
                rows_i[..., 3], comp_w[:, None])
        same = (valid_hit
                & ((d_to_winner < allowed[:, None])
                   | (faces_pr == face_w[:, None])
                   | contiguous))
        same = same & has_winner[:, None]
        num_intersected = same.sum(dim=1).to(torch.int32)
        continue_ray = valid_hit & ~same

        # winner record fields (:225-233)
        corrected = safe_norm(point_w - start_w)
        # in float64 here: a refracted near-vertical aerial ray's sum sits
        # within 1e-5 of 1, where arccos turns each f32 ulp of it into a
        # sizable share of the angle (and the terrain-induced error scales
        # the angle by half a metre a degree)
        angle = _scan_angle(safe_unit(-dir_w.double()), sensor_normal)
        gps = rays.gps_time + corrected * 2.0 / LIGHT_SPEED

        # validation (`validateCollision` :132-151)
        nz = noise_mod.stream_rows(noise_buf, (base + flat_w) & _U32)
        dnoise = nz[:, noise_mod.DISTANCE_STREAM]
        b0, b1 = scalars.max_range_boundary[0], scalars.max_range_boundary[1]
        noisy_max = scalars.max_range + dnoise * (b1 - b0) + b0
        if face_pack is not None:
            ksns, mrow = frow[:, 15:17], frow[:, 17:19]
        else:
            ksns = gather_rows(vert_ksns, verts_w[:, 0])
            mrow = mat_aug[mat_w.long()]
        shininess = clip(torch.pow(maximum(ksns[:, 0], 0.0), ksns[:, 1])
                         * mrow[:, 1], 0.0, 1.0)
        loss_thr = torch.where(
            shininess < scalars.loss_threshold, torch.zeros_like(shininess),
            scalars.loss_mult * torch.pow(
                maximum(shininess + scalars.loss_add, 0.0),
                scalars.loss_power))
        lost = (nz[:, noise_mod.LOSS_STREAM] <= loss_thr) & (not bathymetric)
        first_return = return_count == 0
        valid_col = (has_winner & (corrected < noisy_max)
                     & (~is_water | first_return) & ~lost)

        # error displacements (:98-130)
        comp_rand = (frow[:, 19] if face_pack is not None
                     else noise_mod.stream_sample(
                         noise_buf, comp_w, noise_mod.MODEL_COMP_STREAM))
        point_rec = _displace(point_w, dir_w, start_w, corrected, angle,
                              shininess, comp_rand, nz,
                              is_terrain & valid_col, cfg)

        if face_pack is not None:
            uv0, uv1, uv2 = frow[:, 9:11], frow[:, 11:13], frow[:, 13:15]
        else:
            uvs = gather_rows(scene.vertex_uv, verts_w)         # (P, 3, 2)
            uv0, uv1, uv2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        uv_rec = (uv0 * (1.0 - u_w - v_w)[:, None]
                  + uv1 * u_w[:, None]
                  + uv2 * v_w[:, None])

        z = lambda v: torch.where(valid_col, v, torch.zeros_like(v))
        zv = lambda v: torch.where(valid_col[:, None], v, torch.zeros_like(v))
        record = ReturnRecord(
            mask=valid_col,
            point=zv(point_rec),
            normal=zv(normal_w),
            uv=zv(uv_rec),
            distance=z(corrected),
            angle=z(angle),
            gps_time=z(gps),
            comp=torch.where(valid_col, comp_w, torch.full_like(comp_w, -1)),
            material=torch.where(valid_col, mat_w, torch.zeros_like(mat_w)),
            face=torch.where(valid_col, face_w.to(torch.int32),
                             torch.full_like(comp_w, -1)),
            num_intersected=num_intersected,
            return_number=return_count,
            winner_ray=w.to(torch.int32),
            start=start_w,
            direction=dir_w,
            prev_was_water=prev_water,
            prev_point=prev_point,
        )

        # outliers (`addOutlier-comp.glsl:29-64`): the draw depends on the
        # pulse and the level
        onz = noise_mod.stream_rows(
            noise_buf, (pulse_gidx + level * OUTLIER_LEVEL_STRIDE) & _U32)
        o_prob = onz[:, noise_mod.OUTLIER_STREAM]
        if cfg.include_outliers:
            o_mask = valid_col & ((o_prob * 2.0 - 1.0)
                                  > scalars.outlier_threshold)
        else:
            o_mask = torch.zeros_like(valid_col)
        o_dn = onz[:, noise_mod.OUTLIER_DISTANCE_STREAM] * 1.5
        o_r0, o_r1 = scalars.outlier_range[0], scalars.outlier_range[1]
        o_dist = (o_dn * (o_r1 - o_r0) + o_r0) * corrected
        # addOutlier reads previousDirection after reduceCollisions updated
        # it: the winner goes on (previousDirection := direction) only on a
        # bathymetric water revive (`reduceCollisions-comp.glsl:156-161`)
        exceed = (return_count + 1) >= max_returns
        winner_continues = (~exceed) & is_water & bathymetric
        prev_dir_w = safe_unit(torch.where(winner_continues[:, None], dir_w,
                                           prev_dir_w_raw))
        outlier = OutlierRecord(
            mask=o_mask,
            point=start_w + prev_dir_w * o_dist[:, None],
            distance=o_dist,
        )

        # state update (`validateCollision` :152-170)
        revive = valid_hit & is_water[:, None] & bathymetric
        new_active_valid = (~exceed[:, None]) & (continue_ray | revive)
        active_next = torch.where(valid_col[:, None], new_active_valid,
                                  continue_ray).reshape(N)
        eta = mrow[:, 0]
        # the interface normal against the incident ray (GLSL refract
        # assumes dot(N, I) < 0)
        n2 = repv(normal_w)                                     # (N, 3)
        flip = torch.sign(dot3(n2, dir2))[:, None]
        n_or = -torch.where(flip == 0, torch.ones_like(flip), flip) * n2
        refr2 = safe_unit(_refract(dir2, n_or, rep(eta)))
        water_upd2 = rep(valid_col & is_water)[:, None]         # (N, 1)
        origin_next = torch.where(water_upd2, point_i2 + dir2 * 1e-4,
                                  origin2)
        dir_next = torch.where(water_upd2, refr2, dir2)
        # previousDirection := direction only for rays that go on
        prev_dir_next = torch.where(
            (valid_col[:, None] & new_active_valid).reshape(N)[:, None],
            dir2, prev2)
        count_next = return_count + valid_col.to(torch.int32)
        prev_water_next = torch.where(valid_col, is_water, prev_water)
        # the error-shifted point, as the reference stores it
        # (`computeIntensity-comp.glsl:27` reads it back)
        prev_point_next = torch.where(valid_col[:, None], point_rec,
                                      prev_point)
        new_state = (origin_next, dir_next, prev_dir_next, active_next,
                     count_next, prev_water_next, prev_point_next)
        return new_state, record, outlier

    state = (start2, rays.direction.reshape(N, 3),
             rays.direction.reshape(N, 3),               # previousDirection
             torch.ones(N, dtype=torch.bool, device=dev),  # continueRay
             torch.zeros(P, dtype=torch.int32, device=dev),  # returnNumber
             torch.zeros(P, dtype=torch.bool, device=dev),  # prev was water
             torch.zeros((P, 3), dtype=torch.float32, device=dev))
    records, outliers = [], []
    for level in range(max_returns):
        # level 0 on the primary hits; refracted bounce levels traverse
        # again
        if level == 0:
            hits = hits0
        elif bounce_masked:
            hits = bounce_fn(state[0].reshape(P, R, 3),
                             state[1].reshape(P, R, 3),
                             active=state[3].reshape(P, R))
        else:
            hits = bounce_fn(state[0].reshape(P, R, 3),
                             state[1].reshape(P, R, 3))
        state, rec, out = step(state, hits, level)
        records.append(rec)
        outliers.append(out)
    return (_stack(records), _stack(outliers), state[4],
            state[0].reshape(P, R, 3))


def final_winner_origins(records: ReturnRecord, final_origin) -> torch.Tensor:
    """Each recorded return's winner-ray origin from the final ray state
    (`computeColor` reads `rayData[collision.rayIndex].origin` after the
    bounce loop, `computeColor-comp.glsl:77`): (L, P, 3)."""
    L, P = records.winner_ray.shape
    R = final_origin.shape[1]
    w = torch.clamp(records.winner_ray, min=0).long()
    idx = torch.arange(P, device=w.device)[None, :] * R + w
    return gather_rows(final_origin.reshape(P * R, 3),
                       idx.reshape(-1)).reshape(L, P, 3)


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

    The row gathers are `physics/rows.py::gather_rows`, whose forward is
    K7 on the card (`kernels/gather.py::row_gather`): the face rows
    ``faces_aug`` [v0, v1, v2, comp] of the winners and of every ray's
    hit, the face neighbour lists, the winner rays' origin and direction,
    the face pack's rows, the corner vertices, uvs and ks/ns, in the level
    loop and in the record pass; the noise streams' rows
    (`utils/noise.py::stream_rows`) are K7 too.  The component and material
    tables' rows (a few rows, read by id) stay plain indexing.  Of these,
    the gathers of rows that carry a gradient (the winner rays' origin and
    direction, the face pack's rows, the unpacked corner vertices) have a
    backward that adds each gathered row's cotangent into its source row in
    one pass with no sort (K6 over the flat cells ``row * C + col`` on the
    card, `index_add_` on the CPU), summing the levels where a ray wins at
    several.  Autograd's own backward of plain indexing sorts the indices
    and adds each run of equal rows serially.  The JAX package's custom
    VJPs around the same gathers (`_winner_rows`, `_winner_rows_pr`,
    `_winner_verts_union`) give the same sums; the others have no autograd
    node.
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
    cat6_sg = cat6.detach()
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
        od_w = gather_rows(cat6_sg, flat_w)                    # (P, 6)
        o_w, d_w = od_w[:, 0:3], od_w[:, 3:6]
        safe_w = torch.clamp(face_w, min=0).long()
        if face_pack is not None:
            frow = gather_rows(fp_sg, safe_w)                  # (P, 23)
            v0, v1, v2 = frow[:, 0:3], frow[:, 3:6], frow[:, 6:9]
            ksns, mrow = frow[:, 15:17], frow[:, 17:19]
        else:
            rows_w = gather_rows(faces_aug, safe_w).long()     # (P, 4)
            v0, v1, v2 = gather_rows(verts_sg, rows_w[:, 0:3]).unbind(1)
            ksns = gather_rows(vksns_sg, rows_w[:, 0])
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
            cont_w = gather_rows(scene.face_neighbors, safe_fw)
            contiguous = (faces_pr[:, :, None]
                          == cont_w[:, None, :]).any(dim=-1)
        else:
            rows_i = gather_rows(faces_aug,
                                 torch.clamp(faces_pr, min=0).long())
            rows_wf = gather_rows(faces_aug, safe_fw)
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

    pack = gather_rows(cat6, flat_w_K)                          # (K, 6)
    origin_w = pack[:, 0:3]         # == start point (origins never move)
    dir_w = pack[:, 3:6]            # == previousDirection

    safe_face = torch.clamp(face_w_K, min=0).long()
    if face_pack is not None:
        frow = gather_rows(face_pack, safe_face)                # (K, 23)
        v0, v1, v2 = frow[:, 0:3], frow[:, 3:6], frow[:, 6:9]
        uv0, uv1, uv2 = frow[:, 9:11], frow[:, 11:13], frow[:, 13:15]
        ksns, mrow = frow[:, 15:17], frow[:, 17:19]
        comp_rand_sh = frow[:, 19]
        comp_w = frow[:, 20].to(torch.int32)
        mat_w = frow[:, 21].to(torch.int32)
        surface_w = frow[:, 22].to(torch.int32)
    else:
        rows_w = gather_rows(faces_aug, safe_face)              # (K, 4)
        vidx = rows_w[:, 0:3].long()
        verts3 = gather_rows(scene.vertices, vidx)              # (K, 3, 3)
        v0, v1, v2 = verts3[:, 0], verts3[:, 1], verts3[:, 2]
        uvs = gather_rows(scene.vertex_uv, vidx)                # (K, 3, 2)
        uv0, uv1, uv2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        ksns = gather_rows(vert_ksns, vidx[:, 0])
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
    angle = _scan_angle(safe_unit(-dir_w), sensor_normal)
    gps = rays.gps_time.repeat(L) + corrected * 2.0 / LIGHT_SPEED

    nz = noise_mod.stream_rows(noise_buf, (base + flat_w_K) & _U32)
    shininess = clip(torch.pow(maximum(ksns[:, 0], 0.0), ksns[:, 1])
                     * mrow[:, 1], 0.0, 1.0)

    point_rec = _displace(point_w, dir_w, origin_w, corrected, angle,
                          shininess, comp_rand_sh, nz,
                          is_terrain & valid_col, cfg)

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
