"""Frame sources (a copy of :mod:`vaudio.io.sources`).  A source is any
object with ``.frames()`` yielding (H, W, 3) RGB arrays, u8 or f32 in
[0, 1], or dicts ``{"y", "u", "v"}`` of planar u8 YUV 4:2:0."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from collections import deque
from typing import Iterator, Optional, Tuple

import numpy as np


def hsb_to_rgb(h: float, s: float, b: float) -> np.ndarray:
    """HSB -> RGB, the UIColor(hue:saturation:brightness:) model used by the
    tutorial's synthetic frames (Tutorial/TutorialStart.swift:109-124)."""
    h = (h % 1.0) * 6.0
    i = int(h) % 6
    f = h - int(h)
    p = b * (1.0 - s)
    q = b * (1.0 - s * f)
    t = b * (1.0 - s * (1.0 - f))
    rgb = [(b, t, p), (q, b, p), (p, b, t), (p, q, b), (t, p, b),
           (b, p, q)][i]
    return np.asarray(rgb, dtype=np.float32)


def solid_color_frames(rgb, width: int = 640, height: int = 480,
                       num_frames: int = 1) -> np.ndarray:
    """Constant-colour frames, f32[num_frames, height, width, 3] — the
    createColorBuffer equivalent (Utilities/CreateColorBuffer.swift:16-65)."""
    rgb = np.asarray(rgb, dtype=np.float32).reshape(3)
    out = np.empty((num_frames, height, width, 3), np.float32)
    out[...] = rgb
    return out


def hsb_frames(hue: float, saturation: float, brightness: float,
               width: int = 640, height: int = 480,
               num_frames: int = 1) -> np.ndarray:
    """Tutorial-style synthetic frames parameterized in HSB
    (Tutorial/TutorialStart.swift:46,109-124: 640x480 solid colour at the
    slider-selected hue, saturation and brightness)."""
    return solid_color_frames(hsb_to_rgb(hue, saturation, brightness),
                              width, height, num_frames)


def bgra_to_rgb(frame_bgra_u8: np.ndarray) -> np.ndarray:
    """Camera-format conversion: BGRA u8 -> RGB f32 in [0, 1] (the
    reference forces kCVPixelFormatType_32BGRA, VisionEngine.swift:62-64)."""
    f = frame_bgra_u8.astype(np.float32) / 255.0
    return f[..., [2, 1, 0]]


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


class NativeFrameReader:
    """ctypes binding to the C++ read-ahead frame reader
    (``native/framereader.cpp``): a background thread reads fixed-size raw
    frames from a file, FIFO or device node into a bounded pool of slots,
    so the consumer's device dispatch overlaps the next frame's I/O (the
    reference's capture-delegate thread, VisionEngine.swift:55-75).

    Two ways to consume:

    * :meth:`frames_bytes` — one ``bytes`` copy per frame out of its slot,
      which is recycled at once;
    * :meth:`frames_view` — zero-copy read-only views of the slots, each
      recycled ``release_lag`` iterations after it was yielded.
    """

    def __init__(self, path: str, frame_bytes: int, n_buffers: int = 4,
                 timeout_ms: Optional[int] = None):
        """``timeout_ms`` bounds the wait for each frame; None waits as
        long as it takes (a live capture source idles until its producer
        connects)."""
        from vaudio_torch.runtime.ringbuffer import _load_native
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native frame reader unavailable")
        self._lib = lib
        self._h = lib.va_fr_open(os.fsencode(path), frame_bytes, n_buffers)
        if not self._h:
            raise FileNotFoundError(f"cannot open {path!r}")
        self.frame_bytes = frame_bytes
        self.n_buffers = n_buffers
        self.timeout_ms = timeout_ms

    def _next_slot(self) -> int:
        """Block for the next filled slot; -1 = the stream ended and was
        drained."""
        while True:
            slot = self._lib.va_fr_next(
                self._h,
                self.timeout_ms if self.timeout_ms is not None else 1000)
            if slot == -2:
                if self.timeout_ms is None:
                    continue
                raise TimeoutError(f"no frame within {self.timeout_ms} ms")
            return slot

    def frames_bytes(self) -> Iterator[bytes]:
        while True:
            slot = self._next_slot()
            if slot == -1:
                return
            ptr = self._lib.va_fr_buffer(self._h, slot)
            data = ctypes.string_at(ptr, self.frame_bytes)
            self._lib.va_fr_release(self._h, slot)
            yield data

    def frames_view(self, release_lag: int = 2) -> Iterator[np.ndarray]:
        """Zero-copy frames: read-only u8[frame_bytes] views of the pool
        slots, marked :class:`BorrowedFrame`.

        The view yielded at iteration n is recycled at iteration
        ``n + release_lag`` (and when the generator closes): the consumer
        is done with a frame within that window, as the per-frame stream
        is (its copy to the device has consumed the host memory when it
        returns), or copies it.  ``n_buffers > release_lag`` is required,
        so that the reader thread always has a slot to fill ahead."""
        if release_lag < 1:
            raise ValueError("release_lag must be >= 1")
        if release_lag >= self.n_buffers:
            raise ValueError(
                f"release_lag ({release_lag}) must be < n_buffers "
                f"({self.n_buffers}): holding every pool slot leaves the "
                f"reader thread no free slot and deadlocks the stream")
        pending: deque = deque()
        try:
            while True:
                slot = self._next_slot()
                if slot == -1:
                    return
                ptr = self._lib.va_fr_buffer(self._h, slot)
                buf = (ctypes.c_uint8 * self.frame_bytes).from_address(
                    ctypes.addressof(ptr.contents))
                view = np.frombuffer(buf, np.uint8).view(BorrowedFrame)
                view.flags.writeable = False
                pending.append(slot)
                while len(pending) > release_lag:
                    self._lib.va_fr_release(self._h, pending.popleft())
                yield view
        finally:
            while pending:
                self._lib.va_fr_release(self._h, pending.popleft())

    @property
    def frames_read(self) -> int:
        return self._lib.va_fr_frames_read(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.va_fr_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class RawVideoSource:
    """Uncompressed frames from a plain file, a FIFO or a capture-device
    node, read whole frame by whole frame (CameraModel.swift:12-37).

    ``pix_fmt``: ``rgb24`` (yields u8 (H, W, 3)), or ``i420`` / ``nv12``
    (H W 3 / 2 bytes a frame; yields host-converted u8 RGB, or with
    ``raw=True`` planar ``{"y", "u", "v"}`` dicts for the device-side
    conversion, half the bytes to ship).  ``max_frames`` stops after N
    frames (a device node never ends).

    ``native``: read through the C++ read-ahead reader
    (:class:`NativeFrameReader`, a background thread overlapping the
    frame I/O with the consumer's device dispatch).  None = that reader
    where the runtime library builds, else the Python exact-read loop, as
    in the JAX package (a choice of host reader, not a fallback from the
    device); True = required; False = the Python loop.

    ``zero_copy``: with the native reader, yield frames as read-only views
    over its pool slots (:meth:`NativeFrameReader.frames_view`, no
    frame-sized copy), marked :class:`BorrowedFrame`: a frame's memory is
    recycled two iterations later, so a consumer that keeps frames longer
    copies them (:func:`own_frame`, as the chunked stream does).
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
        self.path = path
        self._w, self._h = int(width), int(height)
        self.pix_fmt = pix_fmt
        self.fps = fps
        self.studio_swing = studio_swing
        self.raw = raw
        self.max_frames = max_frames
        self.native = native
        self.zero_copy = zero_copy

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

    def _frame_bytes_iter(self) -> Iterator[bytes]:
        """Raw frame payloads: the native read-ahead reader where it loads
        (required with ``native=True``), else the Python exact-read
        loop."""
        if self.native is not False:
            reader = None
            try:
                reader = NativeFrameReader(self.path, self.frame_bytes)
            except RuntimeError:     # the library would not build or load
                if self.native:
                    raise
            if reader is not None:
                try:
                    if self.zero_copy:
                        yield from reader.frames_view()
                    else:
                        yield from reader.frames_bytes()
                finally:
                    reader.close()
                return
        with open(self.path, "rb", buffering=0) as f:
            while True:
                buf = self._read_exact(f, self.frame_bytes)
                if len(buf) < self.frame_bytes:
                    break
                yield buf

    def frames(self) -> Iterator:
        h, w = self._h, self._w
        n = 0
        it = self._frame_bytes_iter()
        try:
            # max_frames is checked before reading: a live source that
            # delivered exactly max_frames must not block on one more.
            while self.max_frames is None or n < self.max_frames:
                buf = next(it, None)
                if buf is None:
                    break
                n += 1
                borrowed = isinstance(buf, BorrowedFrame)
                if self.pix_fmt == "rgb24":
                    frame = np.frombuffer(buf, np.uint8).reshape(h, w, 3)
                    # np.frombuffer drops the subclass: mark the pool view
                    # again so that consumers which keep frames copy it.
                    yield frame.view(BorrowedFrame) if borrowed else frame
                    continue
                y, u, v = parse_yuv420(buf, h, w, self.pix_fmt)
                if self.raw:
                    if borrowed:
                        # Only true pool views are marked: nv12's u and v
                        # were copied out by the de-interleave.
                        y = y.view(BorrowedFrame)
                        if self.pix_fmt == "i420":
                            u = u.view(BorrowedFrame)
                            v = v.view(BorrowedFrame)
                    yield {"y": y, "u": u, "v": v}
                else:
                    yield yuv420_to_rgb(y, u, v, self.studio_swing)
        finally:
            it.close()


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


class Cv2CameraSource:
    """Live webcam capture through OpenCV ``VideoCapture`` (most webcams
    deliver MJPEG/H.264, which cv2's codecs decode; :class:`CameraSource`
    reads a V4L2 node already set to a raw pixel format).  ``device`` is a
    capture index (0 = the default camera) or any string cv2 accepts.

    The capture opens once at construction; ``frames()`` drains it until
    the device stops or ``max_frames`` is reached, and a second
    ``frames()`` continues the same live stream.  Yields u8 RGB."""

    def __init__(self, device=0, width: Optional[int] = None,
                 height: Optional[int] = None, fps: Optional[float] = None,
                 max_frames: Optional[int] = None):
        try:
            import cv2
        except ImportError:
            raise RuntimeError(
                "Cv2CameraSource requires the opencv-python package; "
                "for raw V4L2 nodes use CameraSource instead")
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(device)
        if not self._cap.isOpened():
            self._cap.release()
            raise RuntimeError(f"cv2 could not open capture device "
                               f"{device!r}")
        # Requested properties are best-effort (a camera may ignore them);
        # the shape is read back below.
        if width is not None:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        if height is not None:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        if fps is not None:
            self._cap.set(cv2.CAP_PROP_FPS, fps)
        self._w = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._h = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS)) or (fps or 30.0)
        self.max_frames = max_frames
        self._delivered = 0

    @property
    def shape(self) -> Tuple[int, int]:
        return self._h, self._w

    def frames(self) -> Iterator[np.ndarray]:
        if self._cap is None:
            raise RuntimeError("capture is closed")
        while self.max_frames is None or self._delivered < self.max_frames:
            ok, bgr = self._cap.read()
            if not ok:
                break
            self._delivered += 1
            yield np.ascontiguousarray(bgr[..., ::-1])   # BGR -> RGB

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self) -> "Cv2CameraSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# File extensions the CLI routes to VideoFileSource (anything else on
# --input is raw frames or a device node).
VIDEO_FILE_EXTENSIONS = (".mp4", ".m4v", ".mov", ".avi", ".mkv", ".webm",
                         ".mpg", ".mpeg", ".wmv", ".flv")


class VideoFileSource:
    """Decode an encoded video file (mp4/avi/mkv/...) into RGB frames.

    ``backend``: ``"cv2"`` (OpenCV ``VideoCapture``, frames as stored, the
    container's fps unless ``fps`` is given), ``"ffmpeg"`` (an ``ffmpeg``
    subprocess decoding rgb24 on a pipe, resampled to ``fps`` with ``-r``
    when it is given) or ``"auto"`` (cv2 if importable, else ffmpeg, else
    an error naming both).  Frames are u8 RGB (the device step normalizes
    them); ``as_float=True`` yields f32 in [0, 1]."""

    def __init__(self, path: str, width: Optional[int] = None,
                 height: Optional[int] = None, fps: Optional[float] = None,
                 backend: str = "auto", as_float: bool = False):
        if backend not in ("auto", "cv2", "ffmpeg"):
            raise ValueError(f"unknown backend {backend!r}")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.as_float = as_float
        self._cv2 = None
        if backend in ("auto", "cv2"):
            try:
                import cv2
                self._cv2 = cv2
            except ImportError:
                if backend == "cv2":
                    raise RuntimeError(
                        "backend='cv2' requires the opencv-python package")
        if self._cv2 is None and shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "VideoFileSource needs a decode backend: neither the cv2 "
                "module nor an ffmpeg binary on PATH is available. Use "
                "ArraySource (.npy/.npz tensors), RawVideoSource (raw "
                "rgb24/yuv), or the synthetic generators instead.")
        self.backend = "cv2" if self._cv2 is not None else "ffmpeg"
        self._num_frames: Optional[int] = None
        probed_fps: Optional[float] = None
        if self.backend == "cv2":
            cap = self._cv2.VideoCapture(path)
            if not cap.isOpened():
                cap.release()
                raise RuntimeError(
                    f"cv2 could not open {path!r} (unsupported container "
                    "or codec); try backend='ffmpeg' or a raw source")
            if width is None or height is None:
                width = int(cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
                height = int(cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
            probed_fps = float(cap.get(self._cv2.CAP_PROP_FPS)) or None
            n = int(cap.get(self._cv2.CAP_PROP_FRAME_COUNT))
            self._num_frames = n if n > 0 else None
            cap.release()
        elif width is None or height is None:
            width, height = self._probe_dims()
        self.fps = float(fps if fps is not None else (probed_fps or 30.0))
        self._resample = fps is not None      # ffmpeg -r only when asked
        if not width or not height:
            raise RuntimeError(f"could not determine frame size of {path!r}")
        self._w, self._h = int(width), int(height)

    def _probe_dims(self) -> Tuple[int, int]:
        probe = shutil.which("ffprobe")
        if probe is None:
            raise RuntimeError("ffprobe not found; pass width/height")
        out = subprocess.check_output([
            probe, "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=width,height", "-of", "csv=p=0",
            self.path]).decode().strip().split(",")
        return int(out[0]), int(out[1])

    @property
    def shape(self) -> Tuple[int, int]:
        return self._h, self._w

    @property
    def num_frames(self) -> Optional[int]:
        """Container frame count when the backend can probe it, else None."""
        return self._num_frames

    def _finish(self, rgb_u8: np.ndarray) -> np.ndarray:
        if self.as_float:
            return rgb_u8.astype(np.float32) / 255.0
        return rgb_u8

    def frames(self) -> Iterator[np.ndarray]:
        if self.backend == "cv2":
            cap = self._cv2.VideoCapture(self.path)
            try:
                while True:
                    ok, bgr = cap.read()
                    if not ok:
                        break
                    # cv2 decodes BGR; the pipeline is RGB throughout.
                    yield self._finish(
                        np.ascontiguousarray(bgr[..., ::-1]))
            finally:
                cap.release()
            return
        cmd = ["ffmpeg", "-v", "error", "-i", self.path,
               "-f", "rawvideo", "-pix_fmt", "rgb24"]
        if self._resample:
            cmd += ["-r", str(self.fps)]
        cmd += ["pipe:1"]
        frame_bytes = self._w * self._h * 3
        with subprocess.Popen(cmd, stdout=subprocess.PIPE) as proc:
            while True:
                buf = proc.stdout.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                yield self._finish(np.frombuffer(buf, np.uint8).reshape(
                    self._h, self._w, 3))

    def tensor(self) -> np.ndarray:
        """Decode the whole clip to one [T, H, W, 3] tensor."""
        return np.stack(list(self.frames()))
