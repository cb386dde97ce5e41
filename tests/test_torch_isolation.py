"""The PyTorch port stands alone: importing every one of its modules loads
neither `jax` nor the JAX package, and no source file of the port names
them in an import."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lidar_brdf_tpu_torch")


def _modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_importing_the_port_loads_no_jax():
    mods = _modules()
    for m in ("kernels.traverse", "kernels.pulse", "kernels.cuda_build",
              "kernels.packet", "geom.packet", "physics.intensity",
              "sensors.als", "sensors.paths", "cli", "viz", "io.obj",
              "io.ply", "io.png", "io.rgl_bsdf", "runtime.metrics",
              "runtime.checkpoint", "utils.analysis", "utils.regular_grid",
              "examples", "examples.fit_brdf", "examples.fit_pose",
              "examples.fit_geometry"):
        assert "lidar_brdf_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lidar_brdf_tpu' "
            "or m.startswith('lidar_brdf_tpu.'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(\.*)(jax|lidar_brdf_tpu)\b"
                     r"(?!_torch)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
