"""Example: scene-geometry refinement — recover per-building placement.

Counterpart of `examples/fit_geometry.py`: every building (and the ground)
is placed with a small rigid offset error (a misregistered reconstruction);
gradient descent through the simulator recovers each component's offset
from the captured ranges.  Gradients reach the vertices through the
differentiable hit re-evaluation (fixed hit topology) and chain into the
per-component offsets.  Free-form per-vertex fitting from one scan is
underdetermined (range residuals along fixed rays cannot see in-facet
slides); rigid per-component offsets are the well-posed formulation.

Every forward pass walks the displaced triangles: their rows are built
again from the moved vertices over the original BVH's node boxes, as the
JAX package packs the scene inside each traced call.  Same workload, seed,
step count and learning rate; `torch.optim.Adam` in place of `optax.adam`;
the packet walk (K4 on the card).

Run: python -m lidar_brdf_tpu_torch.examples.fit_geometry [--steps N]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .. import api
from ..core.config import SensorConfig, ShadingMode
from ..core.types import as_numpy, resolve_device
from ..geom.packet import intersect_packed_scene, pack_scene, triangle_rows
from ..io import synthetic
from ..io.materials import MaterialLibrary
from ..physics.returns import SimScalars
from ..runtime.simulate import simulate_chunk
from ..utils import noise as noise_mod
from . import adam_fit

STEPS = 150
LR = 5e-3


def build_problem(device="cuda"):
    """(loss_fn(offsets (C, 3)) -> scalar tensor, the misregistered
    start)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    scene = synthetic.city_scene(rng, num_buildings=16)
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig(
        tls_position=(0.0, 10.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=90.0, tls_middle_angle_vertical=-40.0,
        tls_resolution_horizontal=96, tls_resolution_vertical=48,
        rays_per_pulse=2, max_returns=1, chunk_pulses=96 * 48,
        shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=False)
    # the rays are made on the host: the same rays on every device
    rays = api.build_rays(cfg, scene, device="cpu").to(dev)
    noise = noise_mod.make_sim_noise(0, device=dev)
    scalars = SimScalars.from_config(cfg, 0.0, dev)
    materials = MaterialLibrary.default().table_at(1064).to(dev)

    # vertex -> component map (host, once): a vertex belongs to the
    # component of any face using it
    faces_np = as_numpy(scene.faces)
    fcomp_np = as_numpy(scene.face_comp)
    vcomp = np.zeros(scene.num_vertices, np.int64)
    vcomp[faces_np.reshape(-1)] = np.repeat(fcomp_np, 3)
    C = int(fcomp_np.max()) + 1
    scene = scene.to(dev)
    vcomp = torch.from_numpy(vcomp).to(dev)
    packed = pack_scene(scene, bvh)      # node arrays once, rows per pass

    def forward(offsets):
        verts = scene.vertices + offsets[vcomp]
        moved = packed._replace(tri_rows=triangle_rows(verts, scene.faces))
        cloud = simulate_chunk(
            dataclasses.replace(scene, vertices=verts), materials, rays,
            noise, scalars, cfg, scene_has_water=False,
            packet_fn=lambda o, d: intersect_packed_scene(moved, o, d))
        return (torch.where(cloud.mask, cloud.distance,
                            torch.zeros_like(cloud.distance)), cloud.mask)

    with torch.no_grad():
        target, target_mask = forward(torch.zeros((C, 3), device=dev))

    def loss_fn(offsets):
        pred, mask = forward(offsets)
        both = mask & target_mask
        sq = torch.where(both, (pred - target) ** 2, torch.zeros_like(pred))
        return sq.sum() / both.sum().clamp(min=1)

    # misregistration: every component displaced by ~2 cm (ground included;
    # well below triangle scale so the fixed hit topology holds)
    offsets0 = torch.from_numpy(
        rng.normal(0.0, 0.02, size=(C, 3)).astype(np.float32)).to(dev)
    return loss_fn, offsets0


def fit(steps: int = STEPS, device="cuda") -> dict:
    loss_fn, offsets0 = build_problem(device)
    print(f"components: {offsets0.shape[0]}")

    def report(i, loss, offsets):
        if i % 25 == 0 or i == steps - 1:
            err = float(offsets.norm(dim=1).mean())
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"mean offset {err * 100:.2f} cm")

    out = adam_fit(loss_fn, offsets0, LR, steps, report)
    err0 = float(offsets0.norm(dim=1).mean())
    err = float(out["params"].norm(dim=1).mean())
    print(f"mean placement error {err0 * 100:.2f} cm -> {err * 100:.2f} cm "
          f"({err0 / max(err, 1e-9):.1f}x), {out['s_per_step']:.4f} s/step; "
          f"the residual is the single-scan observability null space "
          f"(offset components along occluded or edge-on faces produce no "
          f"range change - the loss itself converges to ~0)")
    out["result"] = err / max(err0, 1e-12)
    return out


def main(steps: int = STEPS, device="cuda") -> float:
    """Final mean offset over the first (the JAX example's return
    value)."""
    return fit(steps, device)["result"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(0 if main(args.steps, args.device) < 0.5 else 1)
