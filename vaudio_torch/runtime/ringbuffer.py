"""The audio ring buffer of the live stream — the PyTorch port's copy of
the pure-Python ring of :mod:`vaudio.runtime.ringbuffer`.

It implements the reference's real-time transport contract
(SoundEngine.swift:88-217,442-474):

* a fixed ring of ``num_frames`` hop-sized frames;
* a warm-up gate (silence until ``warmup`` frames were buffered once);
* drop-on-full writes and zero-fill-on-underrun reads;
* partial-frame reads through an intra-frame cursor;
* ``reset()`` clears the audio but not the warm-up latch (the reference's
  ``stop()`` never resets ``isBufferWarmedUp``); ``reset_full()`` clears
  the latch and the counters too.
"""

from __future__ import annotations

import threading

import numpy as np


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
                     prefer_native: bool = True) -> PyRingBuffer:
    """The stream's ring buffer.  The JAX package prefers its C++ ring and
    takes the Python one where that library cannot be built; the port has
    no C++ ring yet, so ``prefer_native`` is accepted and the Python ring
    is what every caller gets."""
    return PyRingBuffer(num_frames, frame_size, warmup)
