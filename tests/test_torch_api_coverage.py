"""Name-by-name completeness of the port.

Every public top-level name defined in a module of `lidar_brdf_tpu/` must
have a counterpart at the top level of the same-named module of
`lidar_brdf_tpu_torch/` (defined or imported there), or stand in `DROPPED`
with the reason it has none.  Both packages are parsed with `ast`; neither
is imported.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "lidar_brdf_tpu")
PORT_PKG = os.path.join(ROOT, "lidar_brdf_tpu_torch")

# JAX module -> the port module that holds its counterparts
MODULE_MAP = {
    "kernels/traverse_pallas.py": "kernels/traverse.py",
    "kernels/pulse_pallas.py": "kernels/pulse.py",
}

# (JAX module, name) -> the port's name for it
RENAMED = {
    ("kernels/traverse_pallas.py", "PallasCulledTraverser"): "TileTraverser",
    ("geom/morton.py", "expand_bits_jnp"): "expand_bits_torch",
    ("geom/morton.py", "morton3d_jnp"): "morton3d_torch",
}

VERTGRAD = ("a TPU scatter workaround: the vertex gradient's per-face "
            "permutation for the Pallas winner VJPs; autograd's index "
            "backward does that work in the port")
# (JAX module, name or None for the whole module) -> why the port has none
DROPPED = {
    ("geom/vertgrad.py", None): VERTGRAD,
    ("kernels/pulse_pallas.py", "PermutedLayout"): (
        "a TPU layout workaround: bucket-contiguous rows that replace a "
        "scatter on the TPU; the port writes through pulse indices"),
    ("kernels/traverse_pallas.py", "MAX_CB"): (
        "a Pallas VMEM cap on candidate blocks a pass; K1 walks each list "
        "whole"),
    ("kernels/pulse_pallas.py", "MAX_KB"): (
        "a Pallas VMEM cap on ladder blocks a pass; K2 walks each ladder "
        "whole"),
}


def _defined(path: str) -> set:
    """Public names a module defines at its top level."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def _bound(path: str) -> set:
    """Names a module binds at its top level, its imports included."""
    out = _defined(path)
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def _jax_modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_PKG)


def missing_names() -> list:
    """(JAX module, name) pairs with neither a counterpart nor a reason."""
    missing = []
    for rel in _jax_modules():
        names = _defined(os.path.join(JAX_PKG, rel))
        if (rel, None) in DROPPED:
            continue
        port = os.path.join(PORT_PKG, MODULE_MAP.get(rel, rel))
        have = _bound(port) if os.path.exists(port) else set()
        for name in sorted(names):
            want = RENAMED.get((rel, name), name)
            if want not in have and (rel, name) not in DROPPED:
                missing.append((rel, name))
    return missing


def test_every_public_name_has_a_counterpart():
    assert missing_names() == []


def test_every_dropped_and_renamed_entry_names_a_real_name():
    """The lists stay honest: each entry names a module and a name the JAX
    package still has, each reason is written out, and each renamed
    counterpart exists in the port."""
    for (rel, name), why in DROPPED.items():
        path = os.path.join(JAX_PKG, rel)
        assert os.path.exists(path), rel
        assert name is None or name in _defined(path), (rel, name)
        assert len(why) > 20
    for (rel, name), new in RENAMED.items():
        assert name in _defined(os.path.join(JAX_PKG, rel)), (rel, name)
        port = os.path.join(PORT_PKG, MODULE_MAP.get(rel, rel))
        assert new in _defined(port), (rel, new)


@pytest.mark.parametrize("rel", [m for m in _jax_modules()
                                 if (m, None) not in DROPPED])
def test_module_has_a_counterpart(rel):
    """Every JAX module but a dropped one has a same-named port module."""
    assert os.path.exists(os.path.join(PORT_PKG, MODULE_MAP.get(rel, rel)))
