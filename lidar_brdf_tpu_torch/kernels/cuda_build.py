"""nvcc build and ctypes binding of the port's hand-written CUDA kernels.

Each kernel source under `csrc/` is compiled on first use, with a plain C
interface, into its own shared library under the git-ignored
`build/kernels/`, and loaded with ctypes.  One `CudaLibrary` per source
holds the loaded library, its build record and its launch count (the
wrapper adds one per kernel launch, and nowhere else).  Nothing here runs
at import: a module that launches a kernel builds it inside its wrapper.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


class CudaLibrary:
    """One kernel source: its built library, launch count and build record.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions after loading.
    """

    def __init__(self, source: str, declare):
        self.source = os.path.join(CSRC, source)
        self.path = os.path.join(
            BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")
        self._declare = declare
        self.lock = threading.Lock()
        self.lib = None
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""

    def _stale(self) -> bool:
        """The library is missing or older than any source or header."""
        if not os.path.exists(self.path):
            return True
        newest = max(os.path.getmtime(p) for p in
                     [self.source, *glob.glob(os.path.join(CSRC, "*.cuh"))])
        return newest > os.path.getmtime(self.path)

    def build(self, force: bool = False) -> ctypes.CDLL:
        """Compile (if needed) and load the library; raises on failure."""
        with self.lock:
            if self.lib is not None and not force:
                return self.lib
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            if force or self._stale():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    proc = subprocess.run(
                        [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                        capture_output=True, text=True, timeout=600)
                    self.build_log = proc.stdout + proc.stderr
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed to build {self.source}:\n"
                            f"{self.build_log}")
                    os.replace(tmp, self.path)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(self.path)
            self._declare(lib)
            lib.lbt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.lbt_cuda_error_string.restype = ctypes.c_char_p
            self.build_seconds = time.perf_counter() - t0
            self.lib = lib
            return lib

    def check(self, rc: int, what: str):
        """Raise when a launch function returned a CUDA error code."""
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.lib.lbt_cuda_error_string(rc).decode())


def check_tensor(name, x, dtype, ndim, device):
    """Raise unless ``x`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.dtype != dtype or x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got "
                         f"{x.dim()}-D {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
