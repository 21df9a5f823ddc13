"""Frame sources (a copy of the parts of :mod:`vaudio.io.sources` the port
uses).  A source is any object with ``.frames()`` yielding (H, W, 3) RGB
arrays, u8 or f32 in [0, 1]."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class BorrowedFrame(np.ndarray):
    """Marker subclass: an ndarray view whose memory belongs to a reader's
    slot pool and is recycled a few iterations later.  Consumers that keep
    a frame past the current iteration copy it (:func:`own_frame`)."""


def own_frame(frame):
    """``frame`` with any borrowed (pool-backed) arrays copied — safe to
    hold indefinitely.  Accepts an ndarray or a dict of planes."""
    if isinstance(frame, dict):
        return {k: (np.array(v) if isinstance(v, BorrowedFrame) else v)
                for k, v in frame.items()}
    return np.array(frame) if isinstance(frame, BorrowedFrame) else frame


class ArraySource:
    """A decoded video tensor (T, H, W, 3) as a source.

    u8 tensors stay u8 (the device step normalizes them), so the
    host-to-device copy ships one byte per channel; ``as_float=True``
    converts up front instead.  A 3-D (H, W, 3) array is one frame.
    """

    def __init__(self, frames: np.ndarray, fps: float = 30.0,
                 as_float: bool = False):
        frames = np.asarray(frames)
        if frames.ndim == 3 and frames.shape[-1] == 3:
            frames = frames[None]            # single frame -> T=1 clip
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"expected [T,H,W,3] or [H,W,3], got {frames.shape}")
        if frames.dtype == np.uint8 and as_float:
            frames = frames.astype(np.float32) / 255.0
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        self._frames = frames
        self.fps = fps

    @property
    def shape(self) -> Tuple[int, int]:
        return self._frames.shape[1], self._frames.shape[2]

    @property
    def num_frames(self) -> int:
        return self._frames.shape[0]

    def tensor(self) -> np.ndarray:
        return self._frames

    def frames(self) -> Iterator[np.ndarray]:
        yield from self._frames

    @classmethod
    def load(cls, path: str, fps: float = 30.0) -> "ArraySource":
        """Load frames from .npy/.npz (key 'frames')."""
        if path.endswith(".npz"):
            return cls(np.load(path)["frames"], fps)
        return cls(np.load(path), fps)
