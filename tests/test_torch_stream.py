"""The port's live stream (vaudio_torch.runtime.stream and the streaming
front door of vaudio_torch.api.Auralizer) on the CPU: the ring buffer's
real-time contract, the stream against the port's own offline runs
(exactly) and against the JAX package's stream (2e-5), the lifecycle, the
checkpoints across both packages, and the pieces still to port."""

import json
import threading
import time

import numpy as np
import pytest
import torch

import vaudio.runtime.checkpoint as jax_checkpoint
import vaudio.runtime.step as jax_step
from torch_frames import structured_frames
from vaudio.runtime.stream import StreamingAuralizer as JaxStream
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import BorrowedFrame
from vaudio_torch.runtime import checkpoint, chunked, step
from vaudio_torch.runtime.ringbuffer import PyRingBuffer, make_ring_buffer
from vaudio_torch.runtime.stream import StreamingAuralizer

PCM_ATOL = 2e-5          # the JAX package's chunked band (test_chunked.py:20)
TIMEOUT = 60.0
# The live configuration of chip_smoke.py at a small size: both kernel
# paths on, a ring large enough that nothing drops.
LIVE = AuralizerConfig(channels=2, use_pallas=True, use_pallas_vision=True,
                       ring_buffer_frames=64)


def stream_pcm(frames, cfg, **kwargs):
    """Run a port stream over ``frames`` on the CPU; returns (all of its PCM
    interleaved, the Auralizer)."""
    aur = Auralizer(source=frames, config=cfg, device="cpu", **kwargs)
    aur.run_until_exhausted(timeout=TIMEOUT)
    n = len(frames) * cfg.hop_size * cfg.channels
    assert aur.metrics["buffer_fill"] == len(frames)
    return aur.pull(n), aur


# ---------------------------------------------------------------------------
# The ring buffer (tests/test_stream.py:26-86, for the port's Python ring)
# ---------------------------------------------------------------------------

class TestRingBufferContract:
    def test_warmup_gate(self):
        rb = PyRingBuffer(num_frames=8, frame_size=4, warmup=3)
        rb.write(np.ones(4, np.float32))
        rb.write(np.ones(4, np.float32))
        np.testing.assert_array_equal(rb.pull(4), 0.0)
        assert rb.available == 2
        rb.write(np.ones(4, np.float32))
        np.testing.assert_array_equal(rb.pull(4), 1.0)

    def test_warmup_latch_persists(self):
        rb = PyRingBuffer(num_frames=8, frame_size=4, warmup=3)
        for _ in range(3):
            rb.write(np.ones(4, np.float32))
        rb.pull(12)
        rb.write(np.full(4, 2.0, np.float32))
        np.testing.assert_array_equal(rb.pull(4), 2.0)

    def test_drop_on_full(self):
        rb = PyRingBuffer(num_frames=4, frame_size=2, warmup=1)
        for i in range(4):
            assert rb.write(np.full(2, float(i), np.float32))
        assert not rb.write(np.full(2, 99.0, np.float32))
        assert rb.available == 4 and rb.dropped_frames == 1
        np.testing.assert_array_equal(rb.pull(8), [0, 0, 1, 1, 2, 2, 3, 3])

    def test_zero_fill_underrun(self):
        rb = PyRingBuffer(num_frames=4, frame_size=4, warmup=1)
        rb.write(np.ones(4, np.float32))
        out = rb.pull(10)
        np.testing.assert_array_equal(out[:4], 1.0)
        np.testing.assert_array_equal(out[4:], 0.0)
        assert rb.underrun_samples == 6

    def test_partial_frame_reads(self):
        rb = PyRingBuffer(num_frames=4, frame_size=6, warmup=1)
        rb.write(np.arange(6, dtype=np.float32))
        np.testing.assert_array_equal(rb.pull(2), [0, 1])
        np.testing.assert_array_equal(rb.pull(3), [2, 3, 4])
        rb.write(np.arange(6, 12, dtype=np.float32))
        np.testing.assert_array_equal(rb.pull(3), [5, 6, 7])

    def test_reset_clears_audio_not_latch(self):
        rb = PyRingBuffer(num_frames=4, frame_size=2, warmup=2)
        rb.write(np.ones(2, np.float32))
        rb.write(np.ones(2, np.float32))
        rb.pull(2)
        rb.reset()
        assert rb.available == 0
        rb.write(np.full(2, 5.0, np.float32))
        np.testing.assert_array_equal(rb.pull(2), 5.0)

    def test_reset_full_clears_latch_and_counters(self):
        rb = PyRingBuffer(num_frames=2, frame_size=2, warmup=2)
        for _ in range(3):
            rb.write(np.ones(2, np.float32))
        rb.pull(6)
        assert rb.warmed_up and rb.dropped_frames == 1
        rb.reset_full()
        assert not rb.warmed_up and rb.dropped_frames == 0
        assert rb.underrun_samples == 0
        rb.write(np.ones(2, np.float32))
        np.testing.assert_array_equal(rb.pull(2), 0.0)   # gated again

    def test_prefer_native_takes_the_python_ring(self):
        assert isinstance(make_ring_buffer(4, 2, 1, prefer_native=True),
                          PyRingBuffer)


# ---------------------------------------------------------------------------
# The stream against the port's offline runs, and against the JAX stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk_frames", [1, 4])
@pytest.mark.parametrize("depth", [1, 4])
def test_stream_equals_run_offline(chunk_frames, depth):
    """The stream's PCM is the port's offline PCM, bit for bit: per frame
    it is run_offline; with chunks of 4 it is run_offline_batched(chunk=4)
    over the whole chunks and the single-stepped remainder."""
    frames = structured_frames(11, 10, 64, 128)
    got, aur = stream_pcm(frames, LIVE, chunk_frames=chunk_frames,
                          pipeline_depth=depth)
    if chunk_frames == 1:
        ref, _, _ = step.run_offline(frames, LIVE, device="cpu")
    else:
        head, carry, _ = chunked.run_offline_batched(frames[:8], LIVE,
                                                     chunk=4, device="cpu")
        tail, _, _ = step.run_offline(frames[8:], LIVE, carry=carry,
                                      device="cpu")
        ref = torch.cat([head, tail])
    np.testing.assert_array_equal(got, ref.numpy().reshape(-1))
    m = aur.metrics
    assert m["frames_processed"] == 10
    assert m["dispatches"] == (10 if chunk_frames == 1 else 4)
    assert m["dropped_frames"] == 0 and m["achieved_fps"] > 0
    assert set(aur.debug) == {"hues", "grads", "spectrum", "pcm"}
    assert aur.debug["pcm"].shape == (2048, 2)


@pytest.mark.parametrize("cfg", [
    AuralizerConfig(channels=2, ring_buffer_frames=64),
    AuralizerConfig(use_pallas_audio=True, ring_buffer_frames=64),
])
def test_stream_matches_the_jax_stream(cfg):
    """The port's stream against the JAX package's StreamingAuralizer on
    the same 64x64 clip: PCM within 2e-5."""
    frames = structured_frames(12, 6, 64, 64)
    ref_stream = JaxStream(cfg, prefer_native=False)
    ref_stream.run_until_exhausted(list(frames), timeout=TIMEOUT)
    n = len(frames) * cfg.hop_size * cfg.channels
    ref = ref_stream.pull(n)
    got, _ = stream_pcm(frames, cfg)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, atol=PCM_ATOL)


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_borrowed_frames_are_copied_before_reuse(chunk_frames):
    """A zero-copy source lends every frame from one recycled buffer
    (BorrowedFrame views): the stream copies what it keeps past the
    iteration, so its PCM is that of the true frames."""
    frames = structured_frames(26, 8, 64, 64)
    cfg = AuralizerConfig(ring_buffer_frames=64)

    def source():
        buf = np.empty_like(frames[0])
        for f in frames:
            buf[...] = f
            yield buf.view(BorrowedFrame)

    aur = Auralizer(source=source(), config=cfg, device="cpu",
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=TIMEOUT)
    if chunk_frames == 1:
        ref, _, _ = step.run_offline(frames, cfg, device="cpu")
    else:
        ref, _, _ = chunked.run_offline_batched(frames, cfg, chunk=4,
                                                device="cpu")
    np.testing.assert_array_equal(aur.pull(8 * 2048), ref.numpy())


def test_audio_stream_yields_every_sample():
    frames = structured_frames(13, 4, 64, 64)
    cfg = AuralizerConfig(ring_buffer_frames=64)
    aur = Auralizer(source=frames, config=cfg, device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    got = np.concatenate(list(aur.audio_stream(quantum=512, pace=False)))
    ref, _, _ = step.run_offline(frames, cfg, device="cpu")
    np.testing.assert_array_equal(got, ref.numpy())


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------

def test_stop_clears_the_ring_and_keeps_the_dsp_carry():
    frames = structured_frames(14, 5, 64, 64)
    s = StreamingAuralizer(AuralizerConfig(), device="cpu")
    s.run_until_exhausted(list(frames), timeout=TIMEOUT)
    before = s.snapshot_carry()
    assert s.ring.available == 5
    s.stop()
    assert s.ring.available == 0
    after = s.snapshot_carry()
    for name in ("hues", "phases", "prev_spectrum", "running_max"):
        np.testing.assert_array_equal(getattr(after, name),
                                      getattr(before, name))
    assert np.abs(before.ola_tail).max() > 0
    np.testing.assert_array_equal(after.ola_tail, 0.0)


@pytest.mark.parametrize("front", ["Auralizer", "StreamingAuralizer"])
def test_toggle_starts_and_stops(front):
    cfg = AuralizerConfig()
    aur = (Auralizer(config=cfg, device="cpu") if front == "Auralizer"
           else StreamingAuralizer(cfg, device="cpu"))
    release = threading.Event()

    def source():
        yield np.zeros((32, 32, 3), np.uint8)
        release.wait(TIMEOUT)

    aur.toggle(source())
    assert aur.is_running
    release.set()
    aur.toggle()
    assert not aur.is_running
    aur.raise_if_failed()
    if front == "Auralizer":
        assert aur.failure is None


def test_idle_probe_releases_a_partial_chunk():
    """When the source reports it is about to block, the producer
    dispatches the frames of the unfinished chunk one by one instead of
    holding their audio until the chunk fills."""
    cfg = AuralizerConfig(ring_buffer_frames=64)
    frames = structured_frames(25, 6, 32, 32)
    s = StreamingAuralizer(cfg, chunk_frames=4, device="cpu")
    idle = threading.Event()
    s.idle_probe = idle.is_set
    seen = []

    def source():
        yield frames[0]
        idle.set()                    # the queue runs empty after frame 1
        yield frames[1]
        t0 = time.monotonic()
        while s.ring.available < 2 and time.monotonic() - t0 < TIMEOUT:
            time.sleep(0.001)
        seen.append(s.ring.available)
        idle.clear()
        yield from frames[2:]

    s.run_until_exhausted(source(), timeout=TIMEOUT)
    assert seen == [2]                # released before frame 2 arrived
    assert s.metrics.dispatches == 3  # two single steps, one chunk of 4
    a, carry, _ = step.run_offline(frames[:2], cfg, device="cpu")
    b, _, _ = chunked.run_offline_batched(frames[2:], cfg, chunk=4,
                                          carry=carry, device="cpu")
    np.testing.assert_array_equal(s.pull(6 * 2048),
                                  torch.cat([a, b]).numpy())


def test_live_params_change_takes_effect_on_the_next_frame():
    """The source changes the live params just before it yields frame 3:
    frames 0-2 run with the old values and 3-5 with the new ones."""
    cfg = AuralizerConfig(channels=2, ring_buffer_frames=64)
    frames = structured_frames(15, 6, 64, 64)
    params = LiveParams()
    new = dict(spectrum_mixing=0.5, attack=0.5, stereo_width=0.25)

    def source():
        for t, f in enumerate(frames):
            if t == 3:
                for k, v in new.items():
                    setattr(params, k, v)
            yield f

    aur = Auralizer(source=source(), config=cfg, params=params,
                    device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    got = aur.pull(6 * 2048 * 2)
    a, carry, _ = step.run_offline(frames[:3], cfg, device="cpu")
    b, _, _ = step.run_offline(frames[3:], cfg,
                               LiveParams(**new).as_arrays(), carry=carry,
                               device="cpu")
    np.testing.assert_array_equal(got, torch.cat([a, b]).numpy().reshape(-1))
    c, _, _ = step.run_offline(frames[3:], cfg, carry=carry, device="cpu")
    assert not torch.equal(b, c)             # the change is audible


@pytest.mark.parametrize("chunk_frames,n_old,n_new", [(1, 3, 3), (4, 3, 5)])
def test_resolution_change(chunk_frames, n_old, n_new):
    """A frame-size change mid-stream, and mid-chunk (the partial chunk at
    the old size is single-stepped): the stream keeps flowing and equals
    the offline runs at each size."""
    cfg = AuralizerConfig(mip_level=2, ring_buffer_frames=64)
    old = structured_frames(16, n_old, 64, 64, mip=2)
    new = structured_frames(17, n_new, 96, 64, mip=2)
    aur = Auralizer(source=list(old) + list(new), config=cfg, device="cpu",
                    chunk_frames=chunk_frames)
    aur.run_until_exhausted(timeout=TIMEOUT)
    m = aur.metrics
    assert m["frames_processed"] == n_old + n_new
    assert m["resolution_changes"] == 1
    got = aur.pull((n_old + n_new) * 2048)
    a, carry, _ = step.run_offline(old, cfg, device="cpu")
    if chunk_frames == 1:
        b, _, _ = step.run_offline(new, cfg, carry=carry, device="cpu")
    else:
        b1, carry, _ = chunked.run_offline_batched(new[:4], cfg, chunk=4,
                                                   carry=carry, device="cpu")
        b2, _, _ = step.run_offline(new[4:], cfg, carry=carry, device="cpu")
        b = torch.cat([b1, b2])
    np.testing.assert_array_equal(got, torch.cat([a, b]).numpy())


def test_bad_frame_fails_loudly():
    s = StreamingAuralizer(AuralizerConfig(mip_level=2), device="cpu")

    def source():
        yield np.full((64, 64, 3), 0.5, np.float32)
        yield np.zeros((64, 64), np.float32)        # no channel axis

    with pytest.raises(RuntimeError, match="stream producer failed"):
        s.run_until_exhausted(source(), timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="stream producer failed"):
        s.raise_if_failed()


def test_drain_failure_surfaces():
    s = StreamingAuralizer(AuralizerConfig(), pipeline_depth=4,
                           device="cpu")

    class PoisonRing(PyRingBuffer):
        def write(self, row):
            raise RuntimeError("poisoned ring")

    s.ring = PoisonRing(4, 2048, 1)
    with pytest.raises(RuntimeError, match="stream producer failed"):
        s.run_until_exhausted(list(structured_frames(18, 4, 32, 32)),
                              timeout=TIMEOUT)
    s.stop()


def test_metrics_log_jsonl(tmp_path):
    log = str(tmp_path / "metrics.jsonl")
    aur = Auralizer(source=structured_frames(19, 8, 32, 32),
                    config=AuralizerConfig(ring_buffer_frames=64),
                    device="cpu", metrics_log=log, chunk_frames=3)
    aur.run_until_exhausted(timeout=TIMEOUT)
    records = [json.loads(line) for line in open(log)]
    # Two chunks of 3, then the remainder of 2 single-stepped.
    assert [r["frames"] for r in records] == [3, 3, 1, 1]
    assert all(r["latency_ms"] >= 0 and "buffer_fill" in r
               and r["dropped_frames"] == 0 for r in records)
    aur.stop()
    assert aur._stream._metrics_fh is None


def test_restart_resets_metrics():
    frames = list(structured_frames(20, 3, 32, 32))
    s = StreamingAuralizer(AuralizerConfig(ring_buffer_frames=64),
                           device="cpu")
    s.run_until_exhausted(frames, timeout=TIMEOUT)
    assert s.metrics.frames_processed == 3
    s.run_until_exhausted(frames * 2, timeout=TIMEOUT)
    assert s.metrics.frames_processed == 6
    assert s.metrics.achieved_fps > 0


def test_run_until_exhausted_timeout_raises():
    s = StreamingAuralizer(AuralizerConfig(), device="cpu")
    release = threading.Event()

    def hung_source():
        release.wait(TIMEOUT)
        return
        yield  # pragma: no cover

    try:
        with pytest.raises(TimeoutError, match="still running"):
            s.run_until_exhausted(hung_source(), timeout=0.5)
        with pytest.raises(RuntimeError, match="has not exited"):
            s.start(iter([]))
    finally:
        release.set()
    if s._thread is not None:
        s._thread.join(timeout=10)
    s.start(iter([]))
    s.stop()


def test_realtime_pacing():
    """realtime=True paces the producer at video_fps: 6 frames at 60 fps
    take at least 5 frame periods."""
    cfg = AuralizerConfig(video_fps=60.0, ring_buffer_frames=64)
    aur = Auralizer(source=structured_frames(21, 6, 32, 32), config=cfg,
                    device="cpu", realtime=True)
    aur.run_until_exhausted(timeout=TIMEOUT)
    m = aur._stream.metrics
    assert m.end_time - m.start_time >= 5 / 60.0
    assert aur.metrics["achieved_fps"] <= 60.0 * 1.05


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A carry saved by the JAX package after 4 frames, continued by the
    port's stream: the continued PCM matches JAX's within 2e-5."""
    cfg = AuralizerConfig(channels=2, ring_buffer_frames=64)
    frames = structured_frames(22, 8, 64, 64)
    _, c4, _ = jax_step.run_offline(frames[:4], cfg)
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_state(path, c4)
    ref, _, _ = jax_step.run_offline(frames[4:], cfg,
                                     carry=jax_checkpoint.load_state(path,
                                                                     cfg))
    aur = Auralizer(source=frames[4:], config=cfg, device="cpu")
    aur.load_state(path)
    aur.run_until_exhausted(timeout=TIMEOUT)
    np.testing.assert_allclose(aur.pull(4 * 2048 * 2),
                               np.asarray(ref).reshape(-1), atol=PCM_ATOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """A carry saved by the port's stream after 4 frames, continued by the
    JAX package: within 2e-5 of the port continuing it; the port resumes
    its own checkpoint exactly."""
    cfg = AuralizerConfig(channels=2, ring_buffer_frames=64)
    frames = structured_frames(23, 8, 64, 64)
    aur = Auralizer(source=frames[:4], config=cfg, device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    path = str(tmp_path / "port.npz")
    aur.save_state(path)
    saved = np.load(path)
    assert str(saved["carry_type"]) == "StepCarry"
    assert saved["hues"].dtype == np.int32
    restored = jax_checkpoint.load_state(path, cfg)
    ref, _, _ = jax_step.run_offline(frames[4:], cfg, carry=restored)
    got, _, _ = step.run_offline(frames[4:], cfg,
                                 carry=checkpoint.load_state(path, cfg, "cpu"),
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PCM_ATOL)
    whole, _, _ = step.run_offline(frames, cfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), whole[4 * 2048:].numpy())


def test_checkpoint_validation(tmp_path):
    cfg = AuralizerConfig()
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, step.init_carry(cfg))
    with pytest.raises(ValueError, match="wrong AuralizerConfig"):
        checkpoint.load_state(path, AuralizerConfig(nfft=2048), "cpu")
    other = str(tmp_path / "o.npz")
    np.savez(other, carry_type=np.array("OrthoCarry"),
             phases=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="another model family"):
        checkpoint.load_state(other, cfg, "cpu")


def test_snapshot_while_streaming(tmp_path):
    """save_state from another thread while the producer dispatches."""
    cfg = AuralizerConfig(ring_buffer_frames=64)
    aur = Auralizer(source=structured_frames(24, 30, 32, 32), config=cfg,
                    device="cpu")
    path = str(tmp_path / "live.npz")
    aur.start()
    saves = 0
    while aur.is_running:
        aur.save_state(path)
        saves += 1
    aur.raise_if_failed()
    aur.save_state(path)
    aur.stop()
    assert saves >= 1
    restored = checkpoint.load_state(path, cfg, "cpu")
    assert torch.all(torch.isfinite(restored.phases))


# ---------------------------------------------------------------------------
# What the front door does not port yet
# ---------------------------------------------------------------------------

def test_pieces_still_to_port_raise():
    aur = Auralizer(config=AuralizerConfig(), device="cpu")
    for call in (lambda: aur.attach_control("ctl.fifo"),
                 lambda: aur.live_debug("out"), lambda: aur.serve(),
                 lambda: aur.inspect_frame(np.zeros((32, 32, 3))),
                 lambda: aur.sonify(np.zeros((2, 32, 32, 3)), debug=True),
                 lambda: Auralizer(config=AuralizerConfig(),
                                   model="orthomodes", device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(TypeError, match="config="):
        Auralizer(AuralizerConfig(), device="cpu")
    with pytest.raises(ValueError, match="no frame source"):
        aur.start()
