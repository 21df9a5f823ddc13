"""Build and load the CUDA kernels of ``vaudio_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into
``build/vaudio_torch/<hash>/`` beside the package (the hash covers the
sources and the flags, so an edited kernel is rebuilt), and loaded with
``ctypes``.  Nothing here runs at import time: the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vaudio_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: (argtypes, restype int = the
# cudaError_t of the launch).
_SIGNATURES = {
    "vaudio_mip_pool_u8": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    "vaudio_hann_peak_weighted_sum": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of vaudio_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvaudio_torch_kernels.so"


def build() -> Path:
    """Compile the library if it is not there yet; returns its path.  The
    compiler's report (registers, spills) is kept in ``nvcc.log`` beside
    it."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    cus = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus],
                              capture_output=True, text=True)
        (path.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)        # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.vaudio_error_string.argtypes = [ctypes.c_int]
            handle.vaudio_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib().vaudio_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(x, what: str) -> None:
    """The kernels run on CUDA tensors only (a CPU tensor takes the plain
    version before this is reached)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for a tensor on {x.device}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
