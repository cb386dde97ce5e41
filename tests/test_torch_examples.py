"""The port's fit examples (`lidar_brdf_tpu_torch/examples/fit_*.py`): a
short-step smoke of each, and each one's step-0 loss and gradient against
`jax.value_and_grad` of the same loss built from the calls the JAX example
(`examples/fit_*.py`) makes, at the example's own size, on the CPU.

Both sides take the packet walk (the JAX examples call `simulate_chunk`
without a traversal; the port passes `packet_fn`), on the same rays and
noise: the port's noise module draws its buffers as the JAX package does
(fixture ``jax_noise``).  These are the gradients through the packet-walk
path: the BRDF table (`fit_brdf`), the origin offset (`fit_pose`) and the
per-component vertex offsets with the triangle rows built again from the
moved vertices on every pass (`fit_geometry`).  Tolerances, those of
`tests/test_torch_grad.py`: the loss to rtol 1e-5, the gradient within
atol 2e-4 * max|g_jax| and rtol 2e-3 (XLA contracts multiply-adds into
FMAs and sums scatter-added cotangents in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_brdf_tpu.api import build_rays, build_scene_bvh
from lidar_brdf_tpu.core.config import SensorConfig, ShadingMode
from lidar_brdf_tpu.io import synthetic
from lidar_brdf_tpu.io.materials import MaterialLibrary
from lidar_brdf_tpu.physics.returns import SimScalars
from lidar_brdf_tpu.runtime.simulate import simulate_chunk
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.geom import packet as tpacket
from lidar_brdf_tpu_torch.utils import noise as tnoise

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)

EXAMPLES = ("fit_brdf", "fit_pose", "fit_geometry")
SEEDS = {"fit_brdf": 0, "fit_pose": 3, "fit_geometry": 7}


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's noise buffers drawn as the JAX package draws them."""
    monkeypatch.setattr(tnoise, "make_sim_noise", lambda seed, device="cpu":
                        convert.noise_from_numpy(jnoise.make_sim_noise(
                            jax.random.PRNGKey(seed)), device))
    monkeypatch.setattr(tnoise, "make_raygen_noise", lambda seed, device="cpu":
                        convert.noise_from_numpy(jnoise.make_raygen_noise(
                            jax.random.PRNGKey(seed)), device))


def jax_problem(name):
    """(loss, x0) as `examples/<name>.py` builds them."""
    rng = np.random.default_rng(SEEDS[name])
    scene = synthetic.city_scene(rng, num_buildings=16)
    bvh = build_scene_bvh(scene)
    res = (96, 48) if name == "fit_geometry" else (64, 32)
    cfg = SensorConfig(
        tls_position=(0.0, 10.0, 0.0), tls_fov_horizontal=360.0,
        tls_fov_vertical=90.0, tls_middle_angle_vertical=-40.0,
        tls_resolution_horizontal=res[0], tls_resolution_vertical=res[1],
        rays_per_pulse=2, max_returns=1, chunk_pulses=res[0] * res[1],
        shading_mode=ShadingMode.MEASURED,
        include_shiny_surface_error=False)
    rays = build_rays(cfg, scene)
    noise = jnoise.make_sim_noise(jax.random.PRNGKey(0))
    scalars = SimScalars.from_config(cfg, 0.0)
    mats = MaterialLibrary.default().table_at(1064)
    if name == "fit_geometry":
        faces = np.asarray(scene.faces)
        fcomp = np.asarray(scene.face_comp)
        vcomp = np.zeros(int(scene.num_vertices), np.int32)
        vcomp[faces.reshape(-1)] = np.repeat(fcomp, 3)
        C = int(fcomp.max()) + 1
    scene, bvh, mats, rays = jax.tree.map(jnp.asarray,
                                          (scene, bvh, mats, rays))

    def chunk(sc=scene, m=mats, r=rays):
        return simulate_chunk(sc, bvh, m, r, noise, scalars, cfg,
                              scene_has_water=False)

    if name == "fit_brdf":
        def forward(table):
            c = chunk(m=mats.__class__(**{**mats.__dict__,
                                          "brdf_table": table}))
            return jnp.where(c.mask, c.intensity, 0.0)

        target = forward(mats.brdf_table)
        return (lambda t: jnp.mean((forward(t) - target) ** 2) * 1e6,
                jnp.full_like(mats.brdf_table, 0.5))
    if name == "fit_pose":
        def forward(off):
            c = chunk(r=rays.__class__(
                origin=rays.origin + off[None, None, :],
                direction=rays.direction, gps_time=rays.gps_time))
            return jnp.where(c.mask, c.distance, 0.0), c.mask

        x0 = jnp.array([0.12, -0.08, 0.09], jnp.float32)
        zero = jnp.zeros(3, jnp.float32)
    else:
        def forward(off):
            c = chunk(sc=scene.__class__(**{
                **scene.__dict__,
                "vertices": scene.vertices + off[jnp.asarray(vcomp)]}))
            return jnp.where(c.mask, c.distance, 0.0), c.mask

        x0 = jnp.asarray(rng.normal(0.0, 0.02, size=(C, 3))
                         .astype(np.float32))
        zero = jnp.zeros((C, 3), jnp.float32)
    target, target_mask = forward(zero)

    def loss(off):
        pred, mask = forward(off)
        both = mask & target_mask
        return (jnp.sum(jnp.where(both, (pred - target) ** 2, 0.0))
                / jnp.maximum(jnp.sum(both), 1))

    return loss, x0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_smoke(name, capsys):
    """Three steps on the CPU: finite, falling loss (the flat BRDF guess,
    the 18 cm pose error and the 2 cm misregistration are all far from
    the minimum), one line per step reported at least once."""
    mod = importlib.import_module(f"lidar_brdf_tpu_torch.examples.{name}")
    out = mod.fit(steps=3, device="cpu")
    losses = out["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert np.isfinite(out["result"]) and out["s_per_step"] > 0
    assert np.isfinite(mod.main(steps=1, device="cpu"))
    assert "step    2" in capsys.readouterr().out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_step0_grad_matches_jax(name, jax_noise):
    mod = importlib.import_module(f"lidar_brdf_tpu_torch.examples.{name}")
    loss_fn, x0 = mod.build_problem("cpu")
    jloss, jx0 = jax_problem(name)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    lj, gj = jax.jit(jax.value_and_grad(jloss))(jx0)
    lj, gj = float(lj), np.asarray(gj)
    x = x0.clone().requires_grad_(True)
    lt = loss_fn(x)
    lt.backward()
    lt, gt = float(lt.detach()), x.grad.numpy()
    assert np.isfinite(lt) and lt > 0
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    scale = np.abs(gj).max()
    assert scale > 0 and np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, atol=2e-4 * scale, rtol=2e-3)


def test_geometry_walks_the_moved_triangles(jax_noise, monkeypatch):
    """`fit_geometry` builds the triangle rows from the displaced vertices
    on every pass (JAX packs inside each traced call): one build per
    forward pass, from the vertices of that pass."""
    from lidar_brdf_tpu_torch.examples import fit_geometry
    built = []
    rows = tpacket.triangle_rows
    monkeypatch.setattr(fit_geometry, "triangle_rows",
                        lambda v, f: built.append(v.detach().clone())
                        or rows(v, f))
    loss_fn, x0 = fit_geometry.build_problem("cpu")
    assert len(built) == 1                      # the target's pass
    loss_fn(x0)
    assert len(built) == 2
    assert not torch.equal(built[0], built[1])
    assert float((built[1] - built[0]).abs().max()) > 1e-3
