"""Build and load the CUDA kernels of ``vaudio_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` — one ``nvcc -c``
per source, all started together, then one link — into one shared library
with a plain C interface, at first use, into ``build/vaudio_torch/<hash>/``
beside the package (the hash covers the sources and the flags, so an edited
kernel is rebuilt), and loaded with ``ctypes``.  Nothing here runs at
import time: the CPU has no ``nvcc``.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: (argtypes, restype int = the
# cudaError_t of the launch).
_SIGNATURES = {
    "vaudio_mip_pool_u8": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    "vaudio_mip_pool_planes_u8": [_P, _P, _I, _I, _I, _I, _F, _F, _P],
    "vaudio_mip_pool_yuv420_u8": [_P] * 4 + [_I] * 6 + [_F] * 10 + [_P],
    "vaudio_mip_pool_plan": [_I] * 5 + [_P],
    "vaudio_hann_peak_weighted_sum": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _P],
    "vaudio_vision_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                            _P],
    "vaudio_agc_overlap_add": [_P] * 9 + [_I] * 5 + [_F, _F, _P],
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
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        procs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = work / (src.stem + ".o")
            procs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _obj, proc in procs:
            out = proc.communicate()[0]
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out[-4000:]}")
        tmp = work / path.name
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *(str(obj) for _n, obj, _p in procs)],
                capture_output=True, text=True)
            log.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link ({link.returncode}):\n"
                              f"{link.stderr[-4000:]}")
        (path.parent / "nvcc.log").write_text("".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        os.replace(tmp, path)        # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
