"""The port's user surface against the JAX package's on the CPU: the rest
of `api.py` (`tls_path_from_canvas`, `loss_curve`, `simulate_tls_path`),
the CLI (`python -m lidar_brdf_tpu_torch.cli`, run here through `main`
with ``--device cpu``) and `viz.py`.

Both packages draw their noise from their own generators; to compare
scans, the port's noise module is pointed at the JAX buffers
(the `jax_noise` fixture), so both scan the same rays with the same noise.  Clouds
and PLY points are held at `tests/test_torch_simulate.py`'s tolerances
(discrete fields exact, positions atol 1e-4, intensity rtol 1e-4);
`presets` / `config-template` text, `render_ortho` images and the colour
values of every render mode are exact.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from lidar_brdf_tpu import api as japi
from lidar_brdf_tpu import cli as jcli
from lidar_brdf_tpu import viz as jviz
from lidar_brdf_tpu.core.config import LiDARType, SensorConfig, ShadingMode
from lidar_brdf_tpu.io import ply as jply
from lidar_brdf_tpu.io import synthetic as jsyn
from lidar_brdf_tpu.utils import noise as jnoise
from lidar_brdf_tpu_torch import api as tapi
from lidar_brdf_tpu_torch import cli as tcli
from lidar_brdf_tpu_torch import viz as tviz
from lidar_brdf_tpu_torch.core import config as tcfg
from lidar_brdf_tpu_torch.core import convert
from lidar_brdf_tpu_torch.io import ply as tply
from lidar_brdf_tpu_torch.io import synthetic as tsyn
from lidar_brdf_tpu_torch.utils import noise as tnoise

# parallel test workers share the host: keep PyTorch to two threads
torch.set_num_threads(2)


def _np(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@pytest.fixture
def jax_noise(monkeypatch):
    """The port's noise buffers drawn as the JAX package draws them."""
    monkeypatch.setattr(tnoise, "make_sim_noise", lambda seed, **kw:
                        convert.noise_from_numpy(jnoise.make_sim_noise(
                            jax.random.PRNGKey(seed))))
    monkeypatch.setattr(tnoise, "make_raygen_noise", lambda seed, **kw:
                        convert.noise_from_numpy(jnoise.make_raygen_noise(
                            jax.random.PRNGKey(seed))))


def _tls_cfg(**kw):
    base = dict(lidar_type=LiDARType.TERRESTRIAL_SPHERICAL,
                tls_position=(0.0, 8.0, 0.0), tls_fov_horizontal=120.0,
                tls_fov_vertical=40.0, tls_middle_angle_vertical=-40.0,
                tls_resolution_horizontal=32, tls_resolution_vertical=16,
                rays_per_pulse=2, max_returns=2, chunk_pulses=512,
                shading_mode=ShadingMode.MEASURED)
    base.update(kw)
    return SensorConfig(**base)


def _assert_points(t: dict, j: dict):
    """PLY records (`read_ply` dicts) of the two packages, row by row."""
    assert t.keys() == j.keys() and len(t["x"]) == len(j["x"]) > 100
    for k in t:
        if k in ("x", "y", "z"):
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        elif k == "intensity":
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=0)
        elif t[k].dtype == np.uint8:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _assert_clouds(ct, cj):
    for k in ("mask", "comp_id", "return_number", "num_returns", "asprs"):
        np.testing.assert_array_equal(getattr(ct, k).numpy(),
                                      np.asarray(getattr(cj, k)), err_msg=k)
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ct.intensity.numpy(),
                               np.asarray(cj.intensity), rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# api
# ---------------------------------------------------------------------------

def test_tls_path_from_canvas_and_loss_curve_match_jax():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(0), num_boxes=3)
    tscene = convert.scene_from_numpy(_np(scene))
    rng = np.random.default_rng(1)
    pts = np.cumsum(rng.normal(0, 20, (40, 2)), axis=0) + 200
    pts[5] = pts[4]                                   # a redundant point
    for eps in (0.5, 3.0, 20.0):
        np.testing.assert_array_equal(
            tapi.tls_path_from_canvas(pts, (512, 400), tscene, 1.7, eps),
            japi.tls_path_from_canvas(pts, (512, 400), scene, 1.7, eps))
    for cfg in (SensorConfig(), SensorConfig(loss_threshold=0.2,
                                             loss_power=3.0)):
        for a, b in zip(tapi.loss_curve(tcfg.SensorConfig.from_json(
                cfg.to_json()), 97), japi.loss_curve(cfg, 97)):
            np.testing.assert_array_equal(a, b)


def test_simulate_tls_path_matches_jax(tmp_path, jax_noise):
    """Three waypoints, one cloud each, slot by slot; with ``out_dir``
    each cloud goes to `<i>.ply` on the background writer, as JAX writes
    it."""
    scene = jsyn.terrain_with_boxes(np.random.default_rng(2), num_boxes=3)
    cfg = _tls_cfg(max_returns=1)
    positions = np.array([[0, 8, 0], [4, 8, 0], [4, 8, 4]], np.float32)
    cj = japi.simulate_tls_path(scene, cfg, positions,
                                out_dir=str(tmp_path / "j"))
    ct = tapi.simulate_tls_path(
        convert.scene_from_numpy(_np(scene)),
        tcfg.SensorConfig.from_json(cfg.to_json()), positions,
        out_dir=str(tmp_path / "t"), device="cpu")
    assert len(ct) == len(cj) == 3
    for i, (a, b) in enumerate(zip(ct, cj)):
        _assert_clouds(a, b)
        _assert_points(tply.read_ply(str(tmp_path / "t" / f"{i}.ply")),
                       jply.read_ply(str(tmp_path / "j" / f"{i}.ply")))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _write_cfg(path, cfg):
    with open(path, "w") as fh:
        fh.write(cfg.to_json())
    return str(path)


@pytest.mark.parametrize("scene", ["demo", "obj"])
def test_cli_simulate_matches_jax(tmp_path, jax_noise, scene):
    """`simulate` on `:demo:` and on an OBJ directory (the city at a small
    size, with a measured-BRDF directory): the port's PLY points equal the
    JAX CLI's."""
    cfg = _tls_cfg(tls_fov_horizontal=360.0, tls_middle_angle_vertical=-30.0,
                   tls_position=(0.0, 10.0, 0.0))
    args = ["--config", _write_cfg(tmp_path / "cfg.json", cfg)]
    if scene == "demo":
        args += ["--scene", ":demo:"]
        extra_t = extra_j = []
    else:
        city = tsyn.city_scene(np.random.default_rng(0), num_buildings=16)
        args += ["--scene", chip_smoke.city_scene_dir(
            city, str(tmp_path / "city"))]
        bdir = chip_smoke.brdf_dir(str(tmp_path / "brdf_t"))
        shutil.copytree(bdir, str(tmp_path / "brdf_j"))
        extra_t = ["--brdf-dir", bdir]
        extra_j = ["--brdf-dir", str(tmp_path / "brdf_j")]
    out_t, out_j = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    assert tcli.main(["simulate", *args, *extra_t, "--out", out_t,
                      "--device", "cpu"]) == 0
    assert jcli.main(["simulate", *args, *extra_j, "--out", out_j]) == 0
    _assert_points(tply.read_ply(out_t), jply.read_ply(out_j))


def test_cli_wavelength_sweep_writes_a_file_per_wavelength(tmp_path,
                                                          jax_noise):
    cfg = _tls_cfg(wavelength_nm=(905, 906), max_returns=1)
    args = ["simulate", "--scene", ":demo:", "--config",
            _write_cfg(tmp_path / "cfg.json", cfg)]
    assert tcli.main([*args, "--out", str(tmp_path / "t.ply"),
                      "--device", "cpu"]) == 0
    assert jcli.main([*args, "--out", str(tmp_path / "j.ply")]) == 0
    for wl in (905, 906):
        _assert_points(tply.read_ply(str(tmp_path / f"t_{wl}.ply")),
                       jply.read_ply(str(tmp_path / f"j_{wl}.ply")))


@pytest.mark.parametrize("cmd", [["presets"], ["config-template"]])
def test_cli_text_commands_match_jax(capsys, cmd):
    assert tcli.main(cmd) == 0
    t = capsys.readouterr()
    assert jcli.main(cmd) == 0
    j = capsys.readouterr()
    assert t.out == j.out and len(t.out) > 100


def test_cli_errors_exit_2(tmp_path, capsys):
    for argv in (["simulate", "--scene", ":demo:", "--sensor", "no-such",
                  "--device", "cpu"],
                 ["simulate", "--scene", str(tmp_path / "empty"),
                  "--device", "cpu"]):
        os.makedirs(tmp_path / "empty", exist_ok=True)
        assert tcli.main(argv) == 2
        assert "error:" in capsys.readouterr().err
        assert jcli.main([a for a in argv if a not in ("--device", "cpu")]) \
            == 2
    with pytest.raises(SystemExit):
        tcli.main(["simulate", "--scene", ":demo:", "--device", "tpu"])


def test_cli_needs_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tls_cfg(max_returns=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["simulate", "--scene", ":demo:", "--config",
                   _write_cfg(tmp_path / "cfg.json", cfg), "--out",
                   str(tmp_path / "t.ply")])
    assert not os.path.exists(tmp_path / "t.ply")


def test_cli_render_commands(tmp_path, jax_noise):
    """`render-ortho` writes the JAX CLI's bytes; `render-overlays`
    writes a picture of the scan (the port draws its own)."""
    root = chip_smoke.water_scene_dir(str(tmp_path / "water"))
    for mode in ("kad", "asprs"):
        pt, pj = str(tmp_path / f"t_{mode}.png"), str(tmp_path / f"j_{mode}.png")
        args = ["render-ortho", "--scene", root, "--mode", mode,
                "--size", "96"]
        assert tcli.main(args + ["--out", pt]) == 0
        assert jcli.main(args + ["--out", pj]) == 0
        assert open(pt, "rb").read() == open(pj, "rb").read()
    cfg = _tls_cfg(max_returns=1)
    out = str(tmp_path / "overlays.png")
    assert tcli.main(["render-overlays", "--scene", root, "--config",
                      _write_cfg(tmp_path / "cfg.json", cfg), "--out", out,
                      "--num-rays", "50", "--device", "cpu"]) == 0
    from lidar_brdf_tpu_torch.io.png import read_png
    img = read_png(out)
    assert img.ndim == 3 and (img < 1.0).any() and (img == 1.0).any()


# ---------------------------------------------------------------------------
# viz
# ---------------------------------------------------------------------------

def _scan():
    scene = jsyn.terrain_with_boxes(np.random.default_rng(4), num_boxes=4)
    cfg = _tls_cfg(include_outliers=True)
    cloud = japi.simulate(scene, cfg)
    return scene, cfg, cloud


def test_viz_colour_values_match_jax():
    """Every render mode colours each point with JAX's value, on the
    compacted cloud the renderers draw."""
    _, _, cj = _scan()
    ct = convert.pointcloud_from_numpy(_np(cj)).compact_host()
    cj = cj.compact_host()
    for mode in tviz.RENDER_MODES:
        vt, mt = tviz._colors(ct, mode)
        vj, mj = jviz._colors(cj, mode)
        assert mt == mj, mode
        np.testing.assert_array_equal(vt, vj, err_msg=mode)
    with pytest.raises(ValueError):
        tviz._colors(ct, "nope")


def test_render_ortho_matches_jax(tmp_path):
    scene, _, _ = _scan()
    tscene = convert.scene_from_numpy(_np(scene))
    for mode in ("kad", "semantic", "asprs", "height"):
        pt, pj = str(tmp_path / f"t_{mode}.png"), str(tmp_path / f"j_{mode}.png")
        it = tviz.render_ortho(tscene, pt, mode=mode, size=80)
        ij = jviz.render_ortho(scene, pj, mode=mode, size=80)
        assert it == {**ij, "path": pt}
        assert open(pt, "rb").read() == open(pj, "rb").read()


def test_render_png_and_overlays_draw_the_cloud(tmp_path):
    """The port's own pictures: every mode writes an image whose lit
    pixels are the cloud's points (a splat each, in the mode's colours);
    the overlays image spans the max-range disc."""
    from lidar_brdf_tpu.api import build_rays, build_scene_bvh
    from lidar_brdf_tpu_torch.io.png import read_png
    scene, cfg, cj = _scan()
    ct = convert.pointcloud_from_numpy(_np(cj))
    paths = tviz.render_all_modes(ct, str(tmp_path / "c"), dpi=20)
    assert len(paths) == len(tviz.RENDER_MODES)
    n = int(ct.mask.sum())
    for p in paths:
        img = read_png(p)
        lit = int((img < 1.0).any(axis=2).sum())
        assert 0 < lit <= n, (p, lit, n)
    img = read_png(paths[0])
    assert max(img.shape[:2]) == 8 * 20
    tcfg_ = tcfg.SensorConfig.from_json(cfg.to_json())
    out = tviz.render_overlays(
        convert.scene_from_numpy(_np(scene)), ct, tcfg_,
        str(tmp_path / "o.png"),
        bvh=convert.bvh_from_numpy(_np(build_scene_bvh(scene))),
        rays=convert.rays_from_numpy(_np(build_rays(cfg, scene))),
        num_rays=30, dpi=20)
    img = read_png(out)
    assert max(img.shape[:2]) == 9 * 20
    blue = (img[..., 2] > 0.9) & (img[..., 0] < 0.1) & (img[..., 1] < 0.1)
    assert blue.sum() > 50                    # the disc and the sensor
