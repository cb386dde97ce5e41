"""What the kernel variant scripts (`k2_variants.py`, `k4_variants.py`)
share: a variant is a text change of one of the package's CUDA sources,
built with the package's nvcc flags into `build/variants/` and loaded with
ctypes, so that the package's own wrapper launches it.  Imported by those
scripts, which run from the repository root:

    python3 scripts/k4_variants.py base prefetch
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")


def apply_edits(name: str, text: str, edits) -> str:
    """``text`` with every (old, new, count) of ``edits`` replaced in turn;
    ``count`` is how many times ``old`` must be there (None: at least
    once).  Exits when it is not, so that a variant never runs the base
    source under its own name."""
    for old, new, count in edits:
        found = text.count(old)
        if found == 0 or (count is not None and found != count):
            raise SystemExit(f"variant {name}: {old!r} is in the source "
                             f"{found} times, not {count or 'one or more'}")
        text = text.replace(old, new)
    return text


def _build(tag: str, text: str, cb):
    """nvcc ``text`` into build/variants/lib<tag>.so; (ptxas lines, lib)."""
    src = os.path.join(OUT, tag + ".cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(OUT, "lib" + tag + ".so")
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", cb.CSRC, "-o",
                           so, src], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise SystemExit(f"variant {tag} failed to build:\n"
                         f"{proc.stdout}{proc.stderr}")
    return ([l.strip() for l in (proc.stdout + proc.stderr).splitlines()
             if "registers" in l or "spill" in l], ctypes.CDLL(so))


def build_all(prefix: str, sources: dict, declare) -> dict:
    """Build every {variant name: source text} at once (one nvcc each, all
    started together), load each library, give its C functions their types
    (``declare(lib)`` and the error-string function) and print one JSON
    line of ptxas figures per variant.  Returns {name: library}."""
    from lidar_brdf_tpu_torch.kernels import cuda_build as cb
    os.makedirs(OUT, exist_ok=True)
    names = list(sources)
    tag = lambda n: prefix + "_" + re.sub(r"\W", "_", n)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: _build(tag(n), sources[n], cb), names)))
    libs = {}
    for n, (ptxas, lib) in built.items():
        declare(lib)
        lib.lbt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lbt_cuda_error_string.restype = ctypes.c_char_p
        libs[n] = lib
        print(json.dumps({"variant": n, "ptxas": ptxas}), flush=True)
    return libs


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()
