"""The audio ring buffer of the live stream — the PyTorch port of
:mod:`vaudio.runtime.ringbuffer`: a ctypes binding to the C++ ring of
``vaudio_torch/native/ringbuffer.cpp`` and a pure-Python ring with the same
semantics.

Both implement the reference's real-time transport contract
(SoundEngine.swift:88-217,442-474):

* a fixed ring of ``num_frames`` hop-sized frames;
* a warm-up gate (silence until ``warmup`` frames were buffered once);
* drop-on-full writes and zero-fill-on-underrun reads;
* partial-frame reads through an intra-frame cursor;
* ``reset()`` clears the audio but not the warm-up latch (the reference's
  ``stop()`` never resets ``isBufferWarmedUp``); ``reset_full()`` clears
  the latch and the counters too.

The C++ runtime (the ring and the frame reader of
``vaudio_torch/native/framereader.cpp``) is built with ``g++`` at first use
into ``build/vaudio_torch_native/<hash>/`` beside the package (the hash
covers the sources and the flags, so an edited source is rebuilt) and
loaded with ``ctypes``.  Where it cannot be built or loaded,
:func:`make_ring_buffer` takes the Python ring, as the JAX package does:
a choice of host ring, not a fallback from the device.
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
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "vaudio_torch_native"
SOURCES = ("ringbuffer.cpp", "framereader.cpp")
# The JAX package's Makefile flags, without -march=native: a library built
# on one host may be loaded on another that shares the build directory.
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the runtime library for the current sources lives once
    built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libvaudio_torch_rt.so"


def build() -> Path:
    """Compile the runtime library if it is not there yet; returns its
    path.  Concurrent builds (several test workers) each compile to a
    temporary file and move it into place, so no process ever loads a
    half-written library."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the native "
                           "runtime")
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        out = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp,
             *(str(NATIVE_DIR / name) for name in SOURCES)],
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed ({out.returncode}):\n"
                               f"{out.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every entry point's argument and result types."""
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    F = ctypes.POINTER(ctypes.c_float)
    signatures = {
        "va_rb_create": ([I, I, I], P),
        "va_rb_destroy": ([P], None),
        "va_rb_write": ([P, F], I),
        "va_rb_pull": ([P, F, I], I),
        "va_rb_available": ([P], I),
        "va_rb_reset": ([P], None),
        "va_rb_reset_stats": ([P], None),
        "va_rb_dropped": ([P], I64),
        "va_rb_underruns": ([P], I64),
        "va_rb_warmed": ([P], I),
        "va_fr_open": ([ctypes.c_char_p, I64, I], P),
        "va_fr_buffer": ([P, I], ctypes.POINTER(ctypes.c_uint8)),
        "va_fr_next": ([P, I], I),
        "va_fr_release": ([P, I], None),
        "va_fr_frames_read": ([P], I64),
        "va_fr_done": ([P], I),
        "va_fr_close": ([P], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _load_native() -> Optional[ctypes.CDLL]:
    """The loaded runtime library (built on first use), or None where it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError, subprocess.SubprocessError):
                return None
            _bind(lib)
            _lib = lib
        return _lib


class NativeRingBuffer:
    """ctypes wrapper over ``native/ringbuffer.cpp``."""

    def __init__(self, num_frames: int, frame_size: int, warmup: int):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native ring buffer unavailable")
        self._lib = lib
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.warmup = warmup
        self._h = lib.va_rb_create(num_frames, frame_size, warmup)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.va_rb_destroy(h)
            self._h = None

    def write(self, frame: np.ndarray) -> bool:
        frame = np.ascontiguousarray(frame, dtype=np.float32)
        if frame.size != self.frame_size:
            raise ValueError(f"ring frame of {frame.size} samples, expected "
                             f"{self.frame_size}")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.va_rb_write(self._h, ptr))

    def pull(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.va_rb_pull(self._h, ptr, n)
        return out

    @property
    def available(self) -> int:
        return self._lib.va_rb_available(self._h)

    @property
    def dropped_frames(self) -> int:
        return self._lib.va_rb_dropped(self._h)

    @property
    def underrun_samples(self) -> int:
        return self._lib.va_rb_underruns(self._h)

    @property
    def warmed_up(self) -> bool:
        return bool(self._lib.va_rb_warmed(self._h))

    def reset(self) -> None:
        self._lib.va_rb_reset(self._h)

    def reset_full(self) -> None:
        """Reset for a new client: the audio AND the warm-up latch and the
        drop / underrun counters (contrast :meth:`reset`, the reference's
        stop semantics, which keeps them)."""
        self._lib.va_rb_reset(self._h)
        self._lib.va_rb_reset_stats(self._h)


class PyRingBuffer:
    """The lock-guarded Python ring (the reference's NSLock design)."""

    def __init__(self, num_frames: int, frame_size: int, warmup: int):
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.warmup = warmup
        self._data = np.zeros((num_frames, frame_size), np.float32)
        self._write_index = 0
        self._read_index = 0
        self._frame_cursor = 0
        self._available = 0
        self.warmed_up = False
        self.dropped_frames = 0
        self.underrun_samples = 0
        self._lock = threading.Lock()

    def write(self, frame: np.ndarray) -> bool:
        frame = np.asarray(frame, np.float32).reshape(self.frame_size)
        with self._lock:
            if self._available >= self.num_frames:
                self.dropped_frames += 1
                return False
            self._data[self._write_index] = frame
            self._write_index = (self._write_index + 1) % self.num_frames
            self._available += 1
            return True

    def pull(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        with self._lock:
            if self._available < self.warmup and not self.warmed_up:
                return out
            self.warmed_up = True
            written = 0
            while written < n:
                if self._available == 0:
                    self.underrun_samples += n - written
                    break  # the rest stays zero
                rem = self.frame_size - self._frame_cursor
                to_copy = min(rem, n - written)
                start = self._frame_cursor
                out[written:written + to_copy] = \
                    self._data[self._read_index, start:start + to_copy]
                written += to_copy
                self._frame_cursor += to_copy
                if self._frame_cursor >= self.frame_size:
                    self._frame_cursor = 0
                    self._read_index = (self._read_index + 1) \
                        % self.num_frames
                    self._available -= 1
        return out

    @property
    def available(self) -> int:
        with self._lock:
            return self._available

    def reset(self) -> None:
        with self._lock:
            self._available = 0
            self._read_index = 0
            self._write_index = 0
            self._frame_cursor = 0
            self._data[:] = 0.0

    def reset_full(self) -> None:
        """Reset for a new client: the audio AND the warm-up latch and the
        drop / underrun counters (contrast :meth:`reset`, the reference's
        stop semantics, which keeps them)."""
        self.reset()
        with self._lock:
            self.warmed_up = False
            self.dropped_frames = 0
            self.underrun_samples = 0


def make_ring_buffer(num_frames: int, frame_size: int, warmup: int,
                     prefer_native: bool = True):
    """The stream's ring buffer: the C++ ring when ``prefer_native`` and
    the runtime library builds, else the Python ring (the JAX package's
    semantics)."""
    if prefer_native:
        try:
            return NativeRingBuffer(num_frames, frame_size, warmup)
        except RuntimeError:
            pass
    return PyRingBuffer(num_frames, frame_size, warmup)
