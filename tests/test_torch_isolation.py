"""The PyTorch port stands alone: importing every one of its modules loads
neither `jax` nor the JAX package, no source file of the port names them
in an import, and the port builds no file of the repository root's
`native/`."""

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
              "kernels.cull", "kernels.gather",
              "kernels.packet", "geom.packet", "physics.intensity",
              "sensors.als", "sensors.paths", "cli", "viz", "io.obj",
              "io.ply", "io.png", "io.rgl_bsdf", "runtime.metrics",
              "runtime.checkpoint", "utils.analysis", "utils.regular_grid",
              "examples", "examples.fit_brdf", "examples.fit_pose",
              "examples.fit_geometry", "parallel", "parallel.multihost",
              "parallel.shard", "parallel.worker", "bench_scaling"):
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


def test_the_port_builds_its_own_native_copy():
    """No file of the port names the repository root's `native/` source or
    library: the port compiles its own copy
    (`lidar_brdf_tpu_torch/native/lidar_native.cpp`) into `build/native/`.
    `kernels/csrc/` and that copy are the port's own."""
    pat = re.compile(r"""REPO_ROOT\w*\s*,\s*["']native["']"""
                     r"""|["'](?:\.\./)+native/|os\.pardir\s*,\s*["']native""")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                path = os.path.join(root, f)
                with open(path, encoding="utf-8") as fh:
                    if pat.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []
    code = ("from lidar_brdf_tpu_torch.io import native\n"
            "print(native._SRC)\nprint(native._LIB)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    src, lib = (os.path.realpath(p) for p in proc.stdout.split())
    assert src == os.path.join(os.path.realpath(PKG), "native",
                               "lidar_native.cpp")
    assert os.path.exists(src)
    assert not lib.startswith(os.path.join(os.path.realpath(REPO),
                                           "native") + os.sep)
