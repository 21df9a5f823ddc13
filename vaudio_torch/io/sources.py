"""Frame sources (a copy of the parts of :mod:`vaudio.io.sources` the port
uses).  A source is any object with ``.frames()`` yielding (H, W, 3) RGB
arrays, u8 or f32 in [0, 1], or dicts ``{"y", "u", "v"}`` of planar u8
YUV 4:2:0."""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  studio_swing: bool = True) -> np.ndarray:
    """Planar YUV 4:2:0 (I420) -> u8 RGB (H, W, 3), BT.601, on the host;
    ``studio_swing`` 16-235/16-240 (the common camera output), else full
    swing.  u, v (H/2, W/2), or already at the luma's size (no upsample)."""
    y = y.astype(np.float32)
    u = u.astype(np.float32) - 128.0
    v = v.astype(np.float32) - 128.0
    if u.shape != y.shape:
        u = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[:y.shape[0],
                                                          :y.shape[1]]
        v = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[:y.shape[0],
                                                          :y.shape[1]]
    if studio_swing:
        yv = (y - 16.0) * (255.0 / 219.0)
        scale = 255.0 / 224.0
        u, v = u * scale, v * scale
    else:
        yv = y
    r = yv + 1.402 * v
    g = yv - 0.344136 * u - 0.714136 * v
    b = yv + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def parse_yuv420(buf: bytes, height: int, width: int, fmt: str = "i420"):
    """One raw YUV 4:2:0 frame (H W 3 / 2 bytes) -> (y, u, v) u8 planes:
    ``i420`` planar Y, U, V; ``nv12`` planar Y then interleaved UV."""
    h, w = height, width
    ysz, csz = h * w, (h // 2) * (w // 2)
    y = np.frombuffer(buf, np.uint8, ysz).reshape(h, w)
    if fmt == "i420":
        u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(h // 2, w // 2)
        v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(
            h // 2, w // 2)
    else:
        uv = np.frombuffer(buf, np.uint8, 2 * csz, ysz).reshape(h // 2, w)
        u = np.ascontiguousarray(uv[:, 0::2])
        v = np.ascontiguousarray(uv[:, 1::2])
    return y, u, v


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


class RawVideoSource:
    """Uncompressed frames from a plain file, a FIFO or a capture-device
    node, read whole frame by whole frame (CameraModel.swift:12-37).

    ``pix_fmt``: ``rgb24`` (yields u8 (H, W, 3)), or ``i420`` / ``nv12``
    (H W 3 / 2 bytes a frame; yields host-converted u8 RGB, or with
    ``raw=True`` planar ``{"y", "u", "v"}`` dicts for the device-side
    conversion, half the bytes to ship).  ``max_frames`` stops after N
    frames (a device node never ends).

    The port reads with the Python exact-read loop only: ``native=True``
    (the JAX package's C++ read-ahead reader) raises, and ``native=None``
    (auto) quietly means Python, as in the JAX package where its library
    does not load.  That is a choice of host reader, not a fallback from
    the device.  ``zero_copy`` has no effect (each frame is its own array).
    """

    def __init__(self, path: str, width: int, height: int,
                 pix_fmt: str = "rgb24", fps: float = 30.0,
                 studio_swing: bool = True, raw: bool = False,
                 max_frames: Optional[int] = None,
                 native: Optional[bool] = None,
                 zero_copy: bool = False):
        if pix_fmt not in ("rgb24", "i420", "nv12"):
            raise ValueError(f"unknown pix_fmt {pix_fmt!r} "
                             f"(expected rgb24, i420 or nv12)")
        if raw and pix_fmt == "rgb24":
            raise ValueError("raw planar output requires a YUV pix_fmt")
        if native:
            raise NotImplementedError(
                "vaudio_torch does not port the native frame reader yet "
                "(ROADMAP.md queue 1 item 9.1); use native=None or False")
        self.path = path
        self._w, self._h = int(width), int(height)
        self.pix_fmt = pix_fmt
        self.fps = fps
        self.studio_swing = studio_swing
        self.raw = raw
        self.max_frames = max_frames

    @property
    def shape(self) -> Tuple[int, int]:
        return self._h, self._w

    @property
    def frame_bytes(self) -> int:
        if self.pix_fmt == "rgb24":
            return self._h * self._w * 3
        return self._h * self._w * 3 // 2

    def _read_exact(self, f, n: int) -> bytes:
        """Exactly n bytes, or fewer at the end: FIFOs and devices return
        short reads at pipe-buffer boundaries."""
        chunks = []
        got = 0
        while got < n:
            chunk = f.read(n - got)
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def frames(self) -> Iterator:
        h, w = self._h, self._w
        n = 0
        with open(self.path, "rb", buffering=0) as f:
            # max_frames is checked before reading: a live source that
            # delivered exactly max_frames must not block on one more.
            while self.max_frames is None or n < self.max_frames:
                buf = self._read_exact(f, self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    break
                n += 1
                if self.pix_fmt == "rgb24":
                    yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
                    continue
                y, u, v = parse_yuv420(buf, h, w, self.pix_fmt)
                if self.raw:
                    yield {"y": y, "u": u, "v": v}
                else:
                    yield yuv420_to_rgb(y, u, v, self.studio_swing)


class CameraSource(RawVideoSource):
    """A live capture-device node (a V4L2 ``/dev/video*`` set to a raw
    pixel format, or a FIFO a capture process feeds): NV12 1080p by
    default, planar dicts for the device-side conversion, an endless
    stream (stop with ``max_frames`` or ``Auralizer.stop()``)."""

    def __init__(self, device: str = "/dev/video0", width: int = 1920,
                 height: int = 1080, pix_fmt: str = "nv12",
                 fps: float = 30.0, max_frames: Optional[int] = None):
        super().__init__(device, width=width, height=height,
                         pix_fmt=pix_fmt, fps=fps,
                         raw=pix_fmt in ("i420", "nv12"),
                         max_frames=max_frames)


class Yuv420FileSource(RawVideoSource):
    """A raw YUV 4:2:0 file or stream: :class:`RawVideoSource` restricted
    to the YUV formats; ``raw=True`` yields planar dicts instead of
    host-converted RGB."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0, studio_swing: bool = True,
                 raw: bool = False, fmt: str = "i420"):
        if fmt not in ("i420", "nv12"):
            raise ValueError(f"unknown YUV format {fmt!r}")
        super().__init__(path, width, height, pix_fmt=fmt, fps=fps,
                         studio_swing=studio_swing, raw=raw)
        self.fmt = fmt
