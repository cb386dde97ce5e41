"""nvcc build and ctypes binding of the port's hand-written CUDA kernels.

Each kernel source under `csrc/` is compiled on first use, with a plain C
interface, into its own shared library under the git-ignored
`build/kernels/`, and loaded with ctypes.  One `CudaLibrary` per source
holds the loaded library, its launch function, its build record and its
launch count (the wrapper adds one per kernel launch, and nowhere else).
Nothing here runs at import: a module that launches a kernel builds it
inside its wrapper.

The launch path is kept short, because a small launch is bound by the
host, not the card: the launch function is resolved once (only the first
call takes the build lock), the stream is PyTorch's raw current-stream
handle (no `torch.cuda.Stream` object per call), and `check_tensor` tests
dtype, rank, device and contiguity in one expression.
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
    """One kernel source: its built library, launch function, launch count
    and build record.

    ``declare(lib)`` sets ``argtypes``/``restype`` of the library's C
    functions after loading; ``entry`` names the launch function that
    `launcher` returns.
    """

    def __init__(self, source: str, declare, entry: str):
        self.source = os.path.join(CSRC, source)
        self.path = os.path.join(
            BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")
        self._declare = declare
        self.entry = entry
        self.lock = threading.Lock()
        self.lib = None
        self.fn = None
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
            self.fn = getattr(lib, self.entry)
            self.lib = lib
            return lib

    def launcher(self):
        """The launch function; builds and loads the library at first use."""
        if self.fn is None:
            self.build()
        return self.fn

    def check(self, rc: int, what: str):
        """Raise when a launch function returned a CUDA error code."""
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: "
                               + self.lib.lbt_cuda_error_string(rc).decode())


def raw_stream(device_index: int) -> int:
    """PyTorch's current stream on a CUDA device, as the raw handle a C
    launch function takes."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_tensor(name, x, dtype, ndim, device_index):
    """Raise unless ``x`` is a contiguous ``ndim``-D ``dtype`` tensor on the
    device with index ``device_index`` (``get_device()``: -1 on the CPU):
    TypeError for a non-tensor, ValueError for anything else."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if not (x.dtype is dtype and x.dim() == ndim
            and x.get_device() == device_index and x.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {ndim}-D {dtype} tensor on device "
            f"{device_index}; got {x.dim()}-D {x.dtype} on {x.device}, "
            f"contiguous={x.is_contiguous()}")
