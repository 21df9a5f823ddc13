"""The port's C++ host runtime on the CPU (vaudio_torch/native, built with
g++ into build/): the ring buffer against the JAX package's Python ring on
the same write/pull/reset scripts, the read-ahead frame reader on a file
and a FIFO, RawVideoSource's native and zero-copy reading against the JAX
package's Python reader, and a zero-copy stream against an owned-frame
stream."""

import os
import threading
from pathlib import Path

import numpy as np
import pytest

from torch_frames import structured_frames, yuv420_bytes
from vaudio.io.sources import RawVideoSource as JaxRawVideoSource
from vaudio.runtime.ringbuffer import PyRingBuffer as JaxPyRingBuffer
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.io import BorrowedFrame, NativeFrameReader, RawVideoSource
from vaudio_torch.runtime import ringbuffer
from vaudio_torch.runtime.ringbuffer import (NativeRingBuffer, PyRingBuffer,
                                             make_ring_buffer)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 60.0

# ---------------------------------------------------------------------------
# The ring: one script of operations through the port's rings and the JAX
# package's Python ring, every output and counter compared after each step.
# ("w", v) writes a frame of value v (or the array v); ("p", n) pulls n.
# ---------------------------------------------------------------------------

RING_SCRIPTS = {
    "warmup_gate": ((8, 4, 3), [("w", 1.0), ("w", 1.0), ("p", 4), ("w", 1.0),
                                ("p", 4), ("p", 4)]),
    "warmup_latch_persists": ((8, 4, 3), [("w", 1.0)] * 3 + [
        ("p", 12), ("w", 2.0), ("p", 4), ("p", 4)]),
    "drop_on_full": ((4, 2, 1), [("w", float(i)) for i in range(4)] + [
        ("w", 99.0), ("w", 98.0), ("p", 8), ("w", 5.0), ("p", 2)]),
    "underrun": ((4, 4, 1), [("w", 1.0), ("p", 10), ("p", 3), ("w", 2.0),
                             ("p", 6)]),
    "partial_reads": ((4, 6, 1), [("w", np.arange(6.0)), ("p", 2), ("p", 3),
                                  ("w", np.arange(6.0, 12.0)), ("p", 3),
                                  ("p", 5), ("p", 1)]),
    "stereo_frames": ((3, 2 * 2048, 2), [("w", np.linspace(-1, 1, 4096))] * 4
                      + [("p", 512), ("p", 3000), ("p", 4096), ("p", 8192),
                         ("w", 0.25), ("p", 1000)]),
    "reset_keeps_latch": ((4, 2, 2), [("w", 1.0), ("w", 1.0), ("p", 2),
                                      ("reset",), ("w", 5.0), ("p", 2),
                                      ("p", 2)]),
    "reset_full_clears_latch": ((2, 2, 2), [("w", 1.0)] * 3 + [
        ("p", 6), ("reset_full",), ("w", 1.0), ("p", 2), ("w", 3.0),
        ("p", 4)]),
}


def run_ring_script(ring, script, frame_size):
    trace = []
    for op in script:
        if op[0] == "w":
            v = op[1]
            frame = (np.full(frame_size, v, np.float32) if np.isscalar(v)
                     else np.asarray(v, np.float32))
            out = ring.write(frame)
        elif op[0] == "p":
            out = ring.pull(op[1]).tolist()
        else:
            out = getattr(ring, op[0])()
        trace.append((op[0], out, ring.available, bool(ring.warmed_up),
                      int(ring.dropped_frames), int(ring.underrun_samples)))
    return trace


@pytest.mark.parametrize("impl", ["native", "python"])
@pytest.mark.parametrize("script", list(RING_SCRIPTS))
def test_ring_script_equals_the_jax_ring(script, impl):
    """The port's C++ ring (and its Python ring) give the JAX package's
    Python ring's outputs and counters at every step of the script: the
    warm-up gate, drop-on-full, underrun, partial reads, a stereo frame,
    reset and reset_full."""
    (num_frames, frame_size, warmup), ops = RING_SCRIPTS[script]
    cls = NativeRingBuffer if impl == "native" else PyRingBuffer
    got = run_ring_script(cls(num_frames, frame_size, warmup), ops,
                          frame_size)
    ref = run_ring_script(JaxPyRingBuffer(num_frames, frame_size, warmup),
                          ops, frame_size)
    assert got == ref


def test_make_ring_buffer_prefers_the_native_ring():
    assert isinstance(make_ring_buffer(4, 2, 1), NativeRingBuffer)
    assert isinstance(make_ring_buffer(4, 2, 1, prefer_native=False),
                      PyRingBuffer)
    with pytest.raises(ValueError, match="expected 2"):
        NativeRingBuffer(4, 2, 1).write(np.zeros(3, np.float32))


def test_make_ring_buffer_takes_the_python_ring_without_a_library(
        monkeypatch):
    """Where the runtime library cannot be built, the stream's ring is the
    Python one (the JAX package's semantics); a native ring asked for
    explicitly raises."""
    monkeypatch.setattr(ringbuffer, "_load_native", lambda: None)
    assert isinstance(make_ring_buffer(4, 2, 1), PyRingBuffer)
    with pytest.raises(RuntimeError, match="unavailable"):
        NativeRingBuffer(4, 2, 1)


def test_the_library_builds_under_build_and_nowhere_in_vaudio():
    lib = ringbuffer._load_native()
    path = ringbuffer.library_path()
    assert lib is not None and lib._name == str(path) and path.exists()
    assert path.is_relative_to(REPO / "build" / "vaudio_torch_native")
    assert not path.is_relative_to(REPO / "vaudio")
    # The hash covers the sources: the port's copies of the JAX package's.
    for name in ringbuffer.SOURCES:
        assert (REPO / "vaudio_torch" / "native" / name).exists()


def test_concurrent_builds_agree(tmp_path, monkeypatch):
    """Four builders at once into an empty build root (as the test workers
    start): each compiles to its own temporary file and moves it into
    place, so every one returns a library that loads and no temporary file
    is left."""
    import ctypes
    monkeypatch.setattr(ringbuffer, "BUILD_ROOT", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(ringbuffer.build())
        except Exception as e:          # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1
    ctypes.CDLL(str(paths[0])).va_rb_create
    assert [p.name for p in paths[0].parent.iterdir()] == [paths[0].name]


# ---------------------------------------------------------------------------
# The frame reader
# ---------------------------------------------------------------------------

def clip_bytes(n, frame_bytes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, frame_bytes, dtype=np.uint8).tobytes()
            for _ in range(n)]


def test_frame_reader_on_a_file(tmp_path):
    frames = clip_bytes(5, 96)
    path = tmp_path / "clip.raw"
    path.write_bytes(b"".join(frames) + b"\x01" * 17)   # a torn last frame
    reader = NativeFrameReader(str(path), 96)
    try:
        assert list(reader.frames_bytes()) == frames
        assert reader.frames_read == 5
    finally:
        reader.close()
    reader = NativeFrameReader(str(path), 96, n_buffers=4)
    try:
        views = []
        for v in reader.frames_view(release_lag=2):
            assert isinstance(v, BorrowedFrame) and not v.flags.writeable
            views.append(v.tobytes())       # read within the lag
        assert views == frames
    finally:
        reader.close()
    with pytest.raises(FileNotFoundError):
        NativeFrameReader(str(tmp_path / "missing"), 96)


@pytest.mark.parametrize("lag", [0, 4, 5])
def test_frame_reader_release_lag_checks(tmp_path, lag):
    """A lag under 1, or one that holds every pool slot (the reader thread
    would have none to fill: a deadlock), is refused."""
    path = tmp_path / "clip.raw"
    path.write_bytes(b"".join(clip_bytes(2, 8)))
    reader = NativeFrameReader(str(path), 8, n_buffers=4)
    try:
        with pytest.raises(ValueError, match="release_lag"):
            next(reader.frames_view(release_lag=lag))
    finally:
        reader.close()


def test_frame_reader_on_a_fifo(tmp_path):
    """A FIFO opened before its writer: the reader waits for the writer,
    accumulates the short writes into whole frames and ends at the
    writer's close; with no writer, a bounded wait times out."""
    fifo = str(tmp_path / "frames.fifo")
    os.mkfifo(fifo)
    frames = clip_bytes(4, 1000, seed=1)
    reader = NativeFrameReader(fifo, 1000, timeout_ms=30000)

    def writer():
        with open(fifo, "wb") as f:
            for fr in frames:
                f.write(fr[:300])           # short writes mid-frame
                f.flush()
                f.write(fr[300:])
                f.flush()

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        got = [v.tobytes() for v in reader.frames_view()]
    finally:
        reader.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and got == frames
    idle = str(tmp_path / "idle.fifo")
    os.mkfifo(idle)
    reader = NativeFrameReader(idle, 16, timeout_ms=50)
    try:
        with pytest.raises(TimeoutError):
            next(reader.frames_bytes())
    finally:
        reader.close()


# ---------------------------------------------------------------------------
# RawVideoSource's native and zero-copy reading
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pix_fmt,raw", [("rgb24", False), ("i420", True),
                                         ("i420", False), ("nv12", True)])
@pytest.mark.parametrize("zero_copy", [True, False])
def test_native_raw_video_source_equals_jax(tmp_path, pix_fmt, raw,
                                            zero_copy):
    """RawVideoSource(native=True) gives the frames of the JAX package's
    Python reader (native=False), in rgb24, i420 (planar dicts or host
    RGB) and nv12; zero-copy frames are BorrowedFrame pool views (nv12's
    de-interleaved chroma excepted), copies are owned."""
    H, W, T = 16, 24, 4
    rgb = structured_frames(3, T, H, W, mip=2)
    if pix_fmt == "rgb24":
        data = rgb.tobytes()
    else:
        from torch_frames import rgb_to_yuv420
        yuv = rgb_to_yuv420(rgb)
        data = b"".join(yuv420_bytes(yuv, k, pix_fmt) for k in range(T))
    path = tmp_path / f"clip.{pix_fmt}"
    path.write_bytes(data)
    src = RawVideoSource(str(path), W, H, pix_fmt=pix_fmt, raw=raw,
                         native=True, zero_copy=zero_copy)
    ref = list(JaxRawVideoSource(str(path), W, H, pix_fmt=pix_fmt, raw=raw,
                                 native=False).frames())
    n = 0
    for got, want in zip(src.frames(), ref):
        # Compare within the frame's lifetime (two iterations).
        if isinstance(want, dict):
            assert set(got) == {"y", "u", "v"}
            for k in "yuv":
                np.testing.assert_array_equal(got[k], want[k])
                borrowed = zero_copy and (k == "y" or pix_fmt == "i420")
                assert isinstance(got[k], BorrowedFrame) == borrowed
        else:
            np.testing.assert_array_equal(got, want)
            assert isinstance(got, BorrowedFrame) == (
                zero_copy and pix_fmt == "rgb24")
        n += 1
    assert n == len(ref) == T
    capped = RawVideoSource(str(path), W, H, pix_fmt=pix_fmt, raw=raw,
                            native=True, max_frames=2)
    assert len(list(capped.frames())) == 2


def test_native_none_and_false_read_the_same(tmp_path):
    frames = structured_frames(4, 3, 8, 8, mip=1)
    path = tmp_path / "clip.rgb"
    path.write_bytes(frames.tobytes())
    for native in (None, False):
        got = list(RawVideoSource(str(path), 8, 8, native=native).frames())
        np.testing.assert_array_equal(np.stack(got), frames)


@pytest.mark.parametrize("chunk_frames", [1, 8])
@pytest.mark.parametrize("pix_fmt", ["rgb24", "i420"])
def test_zero_copy_stream_equals_owned_frames(tmp_path, chunk_frames,
                                              pix_fmt):
    """A stream fed from RawVideoSource(native=True, zero_copy=True) gives
    the PCM of the same stream fed owned frames, bit for bit, per frame
    (each pool view copied to the device before its slot is recycled) and
    in chunks of 8 (chunks hold frames past their iteration: own_frame
    copies them)."""
    H, W, T = 32, 64, 10
    rgb = structured_frames(5, T, H, W, mip=2)
    cfg = AuralizerConfig(mip_level=2, channels=2, ring_buffer_frames=16)
    if pix_fmt == "rgb24":
        data, owned = rgb.tobytes(), list(rgb)
    else:
        from torch_frames import rgb_to_yuv420
        yuv = rgb_to_yuv420(rgb)
        data = b"".join(yuv420_bytes(yuv, k) for k in range(T))
        owned = [{k: yuv[k][t] for k in "yuv"} for t in range(T)]
    path = tmp_path / "clip.raw"
    path.write_bytes(data)
    src = RawVideoSource(str(path), W, H, pix_fmt=pix_fmt,
                         raw=pix_fmt != "rgb24", native=True, zero_copy=True)
    pcm = []
    for source in (src, owned):
        aur = Auralizer(source=source, config=cfg, device="cpu",
                        chunk_frames=chunk_frames)
        aur.run_until_exhausted(timeout=TIMEOUT)
        assert isinstance(aur._stream.ring, NativeRingBuffer)
        assert aur.metrics["frames_processed"] == T
        pcm.append(aur.pull(T * cfg.hop_size * cfg.channels))
    assert np.abs(pcm[1]).max() > 0
    np.testing.assert_array_equal(pcm[0], pcm[1])
