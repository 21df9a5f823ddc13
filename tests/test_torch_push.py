"""The port's push-model frame source (vaudio_torch.io.push) against the JAX
package's on the same push/pop scripts, its encoder, and the front door's
handling of a push stream (vaudio_torch.api.Auralizer) on the CPU."""

import io
import threading
import time
import zipfile

import numpy as np
import pytest

import vaudio.io.push as jax_push
from torch_frames import structured_frames
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.io import PushSource
from vaudio_torch.io.push import encode_frame

TIMEOUT = 60.0
CFG = AuralizerConfig(mip_level=2, ring_buffer_frames=16)


def wait_for(cond, what, timeout=TIMEOUT):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# Scripts of ("push", v) / ("pop",) / ("close",) / ("state",).  A pop under
# "block" comes only where the queue holds a frame or is closed.
PUSH_SCRIPTS = {
    "hold": (dict(maxsize=3, when_empty="hold"), [
        ("pop",), ("push", "a"), ("pop",), ("pop",), ("state",),
        ("push", "b"), ("push", "c"), ("push", "d"), ("push", "e"),
        ("state",), ("pop",), ("pop",), ("pop",), ("pop",), ("close",),
        ("state",), ("pop",)]),
    "dark": (dict(maxsize=2, when_empty="dark"), [
        ("pop",), ("push", 1), ("push", 2), ("push", 3), ("state",),
        ("pop",), ("pop",), ("pop",), ("push", 4), ("close",), ("state",),
        ("pop",), ("pop",)]),
    "block": (dict(maxsize=4, when_empty="block"), [
        ("push", 1), ("pop",), ("push", 2), ("push", 3), ("state",),
        ("pop",), ("push", 4), ("push", 5), ("push", 6), ("push", 7),
        ("push", 8), ("state",), ("pop",), ("close",), ("pop",), ("pop",),
        ("pop",), ("state",), ("pop",)]),
}

_END = "<end>"


def run_push_script(ps, script):
    it = ps.frames()
    trace = []
    for op in script:
        if op[0] == "push":
            ps.push(op[1])
            trace.append(("push", ps.fill, ps.pushed, ps.dropped))
        elif op[0] == "pop":
            trace.append(("pop", next(it, _END)))
        elif op[0] == "close":
            ps.close()
            trace.append(("close", ps.closed))
        else:
            trace.append(("state", ps.state()))
    with pytest.raises(ValueError, match="closed"):
        ps.push("late")
    return trace


@pytest.mark.parametrize("policy", list(PUSH_SCRIPTS))
def test_push_source_script_equals_jax(policy):
    """hold / dark / block: the same frames, idle ticks (None, or the held
    frame), drops of the oldest frame, end after close and state() as the
    JAX package's PushSource."""
    kwargs, script = PUSH_SCRIPTS[policy]
    got = run_push_script(PushSource(**kwargs), script)
    ref = run_push_script(jax_push.PushSource(**kwargs), script)
    assert got == ref
    assert ("pop", _END) in got


def test_push_source_arguments():
    for kwargs in (dict(maxsize=0), dict(when_empty="spin")):
        with pytest.raises(ValueError):
            PushSource(**kwargs)
        with pytest.raises(ValueError):
            jax_push.PushSource(**kwargs)


def test_block_policy_waits_and_pushers_never_wait():
    """A blocked consumer wakes on a push; a consumer suspended between
    next() calls never blocks a pusher."""
    ps = PushSource(maxsize=4, when_empty="block")
    got = []
    t = threading.Thread(target=lambda: got.extend(ps.frames()),
                         daemon=True)
    t.start()
    time.sleep(0.05)
    assert got == []
    ps.push("x")
    wait_for(lambda: got == ["x"], "the blocked consumer to wake")
    ps.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and got == ["x"]
    ps = PushSource(maxsize=4, when_empty="hold")
    it = ps.frames()
    ps.push(1)
    assert next(it) == 1                        # the generator is suspended
    done = threading.Event()
    threading.Thread(target=lambda: (ps.push(2), done.set()),
                     daemon=True).start()
    assert done.wait(5)


@pytest.mark.parametrize("frame", [
    np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3),
    np.linspace(0, 1, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3),
    np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)[:, ::2],
])
def test_encode_frame_npy_equals_jax(frame):
    """RGB frames go as .npy bodies, byte for byte the JAX encoder's."""
    assert encode_frame(frame) == jax_push.encode_frame(frame)
    body, ctype = encode_frame(frame)
    assert ctype == "application/octet-stream"
    np.testing.assert_array_equal(np.load(io.BytesIO(body)), frame)


def test_encode_frame_npz_equals_jax():
    """Planar YUV dicts go as .npz archives with the JAX encoder's members,
    byte for byte (the archive's own headers carry a time stamp)."""
    rng = np.random.default_rng(0)
    frame = {"y": rng.integers(0, 256, (8, 12), dtype=np.uint8),
             "u": rng.integers(0, 256, (4, 6), dtype=np.uint8),
             "v": rng.integers(0, 256, (4, 6), dtype=np.uint8)[:, ::1]}
    got, ref = encode_frame(frame)[0], jax_push.encode_frame(frame)[0]
    zg, zr = zipfile.ZipFile(io.BytesIO(got)), zipfile.ZipFile(io.BytesIO(ref))
    assert zg.namelist() == zr.namelist() == ["y.npy", "u.npy", "v.npy"]
    for name in zg.namelist():
        assert zg.read(name) == zr.read(name)


# ---------------------------------------------------------------------------
# The front door with a push source (vaudio/api.py:156-200)
# ---------------------------------------------------------------------------

def test_non_block_policy_rejected_single_stream():
    aur = Auralizer(source=PushSource(when_empty="hold"), config=CFG,
                    device="cpu")
    with pytest.raises(ValueError, match="block"):
        aur.start()
    assert aur.push_source is None


def test_push_source_installed_on_start_and_closed_by_stop():
    """start() installs the push source and its idle probe; stop() closes
    it at once, waking the producer blocked on the empty queue (no zombie:
    a new source starts)."""
    ps = PushSource(when_empty="block")
    aur = Auralizer(source=ps, config=CFG, device="cpu")
    assert aur.push_source is None
    aur.start()
    try:
        assert aur.push_source is ps
        ps.push(structured_frames(1, 1, 32, 32, mip=2)[0])
        wait_for(lambda: aur.metrics["frames_processed"] >= 1, "a frame")
        # One frame, no close: its audio is in the ring without a next
        # push (the drain thread reads every dispatch on its own).
        wait_for(lambda: aur.metrics["buffer_fill"] >= 1, "its audio")
        t0 = time.monotonic()
        aur.stop()
        assert time.monotonic() - t0 < 5.0
        assert ps.closed and not aur.is_running
        other = PushSource(when_empty="block")
        aur.start(other)
        other.close()
        wait_for(lambda: not aur.is_running, "the restarted stream to end")
        aur.raise_if_failed()
    finally:
        aur.stop()


def test_chunked_push_flushes_partial_chunk_on_idle():
    """chunk_frames=4 on a push source: two frames and an empty queue are
    dispatched as single steps at once, not held for a full chunk."""
    ps = PushSource(when_empty="block")
    aur = Auralizer(source=ps, config=CFG, device="cpu", chunk_frames=4)
    aur.start()
    try:
        for f in structured_frames(2, 2, 32, 32, mip=2):
            ps.push(f)
        wait_for(lambda: aur.metrics["buffer_fill"] >= 2,
                 "the sub-chunk's audio")
        assert aur.metrics["dispatches"] == 2
        aur.raise_if_failed()
    finally:
        aur.stop()


def test_frame_error_is_the_engines():
    aur = Auralizer(config=CFG, device="cpu")
    assert aur.frame_error(np.zeros((32, 32, 3), np.uint8)) is None
    assert "too small" in aur.frame_error(np.zeros((8, 8, 3), np.uint8))
    assert "(H, W, 3)" in aur.frame_error(np.zeros((8, 8), np.uint8))
