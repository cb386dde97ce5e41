"""Example: inverse rendering — fit BRDF tables to observed intensities.

Counterpart of `examples/fit_brdf.py`: given a point cloud captured with
unknown material reflectance, recover the measured-BRDF tables by gradient
descent through the full simulator (the traversal is forward-only;
gradients flow through the Hermite table lookup and the radar equation).
Same workload, seed, step count and learning rate; `torch.optim.Adam` in
place of `optax.adam`; the packet walk (K4 on the card) as the JAX example
takes its packet traversal.

Run: python -m lidar_brdf_tpu_torch.examples.fit_brdf [--steps N]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .. import api
from ..core.config import SensorConfig, ShadingMode
from ..core.types import resolve_device
from ..geom.packet import make_packet_traverser
from ..io import synthetic
from ..io.materials import MaterialLibrary
from ..physics.returns import SimScalars
from ..runtime.simulate import simulate_chunk
from ..utils import noise as noise_mod
from . import adam_fit

STEPS = 60
LR = 3e-2


def build_problem(device="cuda"):
    """(loss_fn(table) -> scalar tensor, the flat starting table)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    scene = synthetic.city_scene(rng, num_buildings=16)
    bvh = api.build_scene_bvh(scene)
    cfg = SensorConfig(
        tls_position=(0.0, 10.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=90.0, tls_middle_angle_vertical=-40.0,
        tls_resolution_horizontal=64, tls_resolution_vertical=32,
        rays_per_pulse=2, max_returns=1, chunk_pulses=64 * 32,
        shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=False)
    # the rays are made on the host: the same rays on every device
    rays = api.build_rays(cfg, scene, device="cpu").to(dev)
    noise = noise_mod.make_sim_noise(0, device=dev)
    scalars = SimScalars.from_config(cfg, 0.0, dev)
    true_materials = MaterialLibrary.default().table_at(1064).to(dev)
    scene = scene.to(dev)
    walk = make_packet_traverser(scene, bvh)

    def forward(table):
        mats = dataclasses.replace(true_materials, brdf_table=table)
        cloud = simulate_chunk(scene, mats, rays, noise, scalars, cfg,
                               scene_has_water=False, packet_fn=walk)
        return torch.where(cloud.mask, cloud.intensity,
                           torch.zeros_like(cloud.intensity))

    with torch.no_grad():
        target = forward(true_materials.brdf_table)

    def loss_fn(table):
        return ((forward(table) - target) ** 2).mean() * 1e6

    # start from a flat wrong guess
    return loss_fn, torch.full_like(true_materials.brdf_table, 0.5)


def fit(steps: int = STEPS, device="cuda") -> dict:
    loss_fn, table0 = build_problem(device)

    def report(i, loss, table):
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")

    out = adam_fit(loss_fn, table0, LR, steps, report)
    loss0, final = out["losses"][0], out["losses"][-1]
    print(f"loss reduced {loss0:.4f} -> {final:.4f} "
          f"({loss0 / max(final, 1e-12):.1f}x), "
          f"{out['s_per_step']:.4f} s/step")
    out["result"] = final / max(loss0, 1e-12)
    return out


def main(steps: int = STEPS, device="cuda") -> float:
    """Final loss over the first (the JAX example's return value)."""
    return fit(steps, device)["result"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.device)
