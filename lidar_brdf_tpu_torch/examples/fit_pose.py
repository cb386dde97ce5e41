"""Example: sensor-pose refinement — recover a TLS position offset.

Counterpart of `examples/fit_pose.py`: a scan is captured from an unknown,
slightly mis-calibrated sensor position; gradient descent through the full
simulator recovers the offset by matching per-pulse ranges.  Gradients flow
through the differentiable hit re-evaluation (fixed hit topology).  Range
residuals drive the fit: the corrected distance is linear in the origin
along each ray, so the loss is smooth while the winner faces do not change,
which a small calibration offset guarantees.  Same workload, seed, step
count and learning rate; `torch.optim.Adam` in place of `optax.adam`; the
packet walk (K4 on the card).

Run: python -m lidar_brdf_tpu_torch.examples.fit_pose [--steps N]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import api
from ..core.config import SensorConfig, ShadingMode
from ..core.types import RayBundle, resolve_device
from ..geom.packet import make_packet_traverser
from ..io import synthetic
from ..io.materials import MaterialLibrary
from ..physics.returns import SimScalars
from ..runtime.simulate import simulate_chunk
from ..utils import noise as noise_mod
from . import adam_fit

STEPS = 80
LR = 1e-2


def build_problem(device="cuda"):
    """(loss_fn(offset (3,)) -> scalar tensor, the mis-calibrated start)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
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
    materials = MaterialLibrary.default().table_at(1064).to(dev)
    scene = scene.to(dev)
    walk = make_packet_traverser(scene, bvh)

    def forward(origin_offset):
        shifted = RayBundle(origin=rays.origin + origin_offset[None, None, :],
                            direction=rays.direction, gps_time=rays.gps_time)
        cloud = simulate_chunk(scene, materials, shifted, noise, scalars,
                               cfg, scene_has_water=False, packet_fn=walk)
        return (torch.where(cloud.mask, cloud.distance,
                            torch.zeros_like(cloud.distance)), cloud.mask)

    with torch.no_grad():
        target, target_mask = forward(torch.zeros(3, device=dev))

    def loss_fn(offset):
        pred, mask = forward(offset)
        both = mask & target_mask
        sq = torch.where(both, (pred - target) ** 2, torch.zeros_like(pred))
        return sq.sum() / both.sum().clamp(min=1)

    # the "mis-calibrated" start: 18 cm off in x/y/z
    return loss_fn, torch.tensor([0.12, -0.08, 0.09], device=dev)


def fit(steps: int = STEPS, device="cuda") -> dict:
    loss_fn, offset0 = build_problem(device)

    def report(i, loss, offset):
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"|offset| {float(offset.norm()) * 100:.2f} cm")

    out = adam_fit(loss_fn, offset0, LR, steps, report)
    err0 = float(offset0.norm())
    err = float(out["params"].norm())
    print(f"pose error {err0 * 100:.1f} cm -> {err * 100:.3f} cm "
          f"({err0 / max(err, 1e-9):.0f}x), {out['s_per_step']:.4f} s/step")
    out["result"] = err
    return out


def main(steps: int = STEPS, device="cuda") -> float:
    """The remaining offset in metres (the JAX example's return value)."""
    return fit(steps, device)["result"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(0 if main(args.steps, args.device) < 0.02 else 1)
