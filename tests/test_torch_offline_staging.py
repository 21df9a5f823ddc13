"""The offline route's page-locked slice ring (vaudio_torch.runtime.staging
``OfflineStaging``): the slice plan and the fill on the CPU, the direct
path a CPU device takes, the ring's re-making on a signature change, the
staged walk's order and failures with the card's streams and events
stood in for, and on the card (``cuda``-marked) the staged PCM equal to
the direct path's bit for bit.  This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_offline_staging.py
"""

import contextlib
import os
import time
import weakref

import numpy as np
import pytest
import torch

from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig
from vaudio_torch.runtime import chunked, staging
from vaudio_torch.runtime.chunked import run_offline_batched
from vaudio_torch.runtime.staging import (RING, OfflineStaging, fill_threads,
                                          row_parts, slice_frames, slice_plan)
from vaudio_torch.runtime.step import check_frames
from vaudio_torch.utils.profiling import SPANS

H, W = 64, 96
CHUNK = 8
CFG = AuralizerConfig(channels=2)


def rgb(seed, T, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (T, h, w, 3),
                                                np.uint8)


def clip(kind, seed, T):
    """A clip of T frames: RGB u8, RGB f32 in [0, 1] or planar YUV."""
    if kind == "yuv":
        g = np.random.default_rng(seed)
        return {"y": g.integers(16, 236, (T, H, W), np.uint8),
                "u": g.integers(16, 241, (T, H // 2, W // 2), np.uint8),
                "v": g.integers(16, 241, (T, H // 2, W // 2), np.uint8)}
    f = rgb(seed, T)
    return (f / np.float32(255.0)).astype(np.float32) if kind == "f32" else f


def frame_bytes(f):
    planes = f.values() if isinstance(f, dict) else [f]
    return sum(p[0].nbytes for p in planes)


def planes_of(f):
    f = check_frames(f)
    return f if isinstance(f, dict) else {None: f}


# ---- the slice plan, the budget and the row split (pure) -------------------

@pytest.mark.parametrize("T,chunk,per_slice", [
    (150, 64, 21), (600, 64, 5), (64, 64, 64), (27, 8, 3), (8 * 5 + 3, 8, 3),
    (1, 64, 5), (17, 8, 100), (599, 64, 21)])
def test_slice_plan_covers_the_clip_in_order(T, chunk, per_slice):
    """The slices cover [0, T) once, in order; each lies inside its chunk
    (the chunks of ``chunk`` frames, ragged tail included), holds at most
    ``per_slice`` frames, and a chunk has as few slices as will do, of
    lengths apart by at most one."""
    plan = slice_plan(T, chunk, per_slice)
    assert [(c0, c1) for c0, c1, _ in plan] == [
        (c0, min(c0 + chunk, T)) for c0 in range(0, T, chunk)]
    at = 0
    for c0, c1, slices in plan:
        assert len(slices) == -(-(c1 - c0) // per_slice)
        lengths = [s1 - s0 for s0, s1 in slices]
        assert max(lengths) - min(lengths) <= 1
        assert max(lengths) <= per_slice
        for s0, s1 in slices:
            assert s0 == at and c0 <= s0 < s1 <= c1
            at = s1
    assert at == T


def test_slice_budget():
    """A slice holds as many frames as the budget does, at least one: a 4K
    RGB frame 5 a slice and the ring under 0.6 GB page-locked, a 1080p
    frame 21; a frame over the budget goes alone."""
    uhd, hd = 2160 * 3840 * 3, 1080 * 1920 * 3
    assert slice_frames(uhd) == 5 and slice_frames(hd) == 21
    assert RING * staging.SLICE_BYTES < 0.6e9
    for fb in (uhd, hd, 18432, 3 * 2 ** 20):
        assert slice_frames(fb) * fb <= staging.SLICE_BYTES
        assert (slice_frames(fb) + 1) * fb > staging.SLICE_BYTES
    assert slice_frames(staging.SLICE_BYTES * 3) == 1


@pytest.mark.parametrize("n,rows,parts", [(5, 64, 7), (1, 64, 8), (8, 3, 8),
                                          (2, 1080, 1), (3, 4, 5)])
def test_row_parts_cover_every_row_once(n, rows, parts):
    runs = row_parts(n, rows, parts)
    assert len(runs) == parts
    seen = [(f, r) for run in runs for f, r0, r1 in run
            for r in range(r0, r1)]
    assert seen == [(f, r) for f in range(n) for r in range(rows)]
    sizes = [sum(r1 - r0 for _, r0, r1 in run) for run in runs]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("frame_bytes,want", [
    (2160 * 3840 * 3, 8), (1080 * 1920 * 3, 4), (1080 * 1920 * 3 // 2, 2),
    (H * W * 3, 1), (1, 1)])
def test_fill_threads_follow_the_frame_and_the_affinity(frame_bytes, want):
    """A thread for each FILL_BYTES_PER_THREAD of a frame (a 1080p RGB
    frame 4, its I420 planes 2, a 4K frame as many as allowed), within the
    CPUs this process may run on less one, and at most MAX_FILL_THREADS."""
    cpus = len(os.sched_getaffinity(0))
    assert fill_threads(frame_bytes) == max(
        1, min(want, cpus - 1, staging.MAX_FILL_THREADS))


def test_stage_span_is_registered():
    assert "vaudio.ingest.stage" in SPANS


# ---- the ring, the fill and the direct path on the CPU ---------------------

def test_ring_is_remade_only_on_a_new_signature():
    """One ring of RING buffers a plane, kept while the frame signature
    and the slice length stay, re-made on a new shape, dtype or plane
    set; plain host memory when not ``pinned``."""
    st = OfflineStaging(pinned=False)
    a = planes_of(rgb(0, 10))
    bufs = st.ring(a, 4)
    assert (st.allocs, st.reuses) == (1, 0)
    assert len(bufs) == RING
    for b in bufs:
        assert b[None].shape == (4, H, W, 3) and b[None].dtype == torch.uint8
        assert not b[None].is_pinned()
    assert st.ring(planes_of(rgb(1, 30)), 4) is bufs    # T does not count
    assert (st.allocs, st.reuses) == (1, 1)
    st.ring(planes_of(rgb(2, 10, h=32)), 4)              # a new frame shape
    st.ring(planes_of(clip("f32", 3, 10)), 4)            # a new dtype
    st.ring(planes_of(clip("f32", 3, 10)), 2)            # a new slice length
    yuv = st.ring(planes_of(clip("yuv", 4, 10)), 4)      # planes
    assert (st.allocs, st.reuses) == (5, 1)
    assert set(yuv[0]) == {"y", "u", "v"}
    assert yuv[0]["u"].shape == (4, H // 2, W // 2)
    st.ring(planes_of(clip("yuv", 5, 3)), 4)
    assert (st.allocs, st.reuses) == (5, 2)


@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
@pytest.mark.parametrize("s0,s1", [(0, 5), (5, 8), (11, 14), (13, 14)])
def test_fill_copies_the_slice_into_the_buffer_head(kind, s0, s1):
    f = clip(kind, 7, 14)
    planes = planes_of(f)
    st = OfflineStaging(pinned=False)
    buf = st.ring(planes, 5)[1]
    st.fill(planes, s0, s1, buf, threads=3)
    for k, p in planes.items():
        assert torch.equal(buf[k][:s1 - s0], p[s0:s1])


@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
def test_a_cpu_device_takes_the_direct_path(kind):
    """On a CPU device the staging object hands the clip over as it is:
    the PCM equals the run without it, every chunk counts as direct, and
    no ring, thread or stream is made."""
    T = 2 * CHUNK + 3
    f = clip(kind, 8, T)
    st = OfflineStaging(pinned=False)
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
    assert torch.equal(a, b)
    assert st.metrics() == {"staging_allocs": 0, "staging_reuses": 0,
                            "staged_chunks": 0, "direct_chunks": 3}
    assert st._fill is None and st._stager is None and st._bufs == []


def test_engages_only_for_host_clips_bound_for_cuda():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    u8, f32 = planes_of(rgb(0, 2)), planes_of(clip("f32", 0, 2))
    assert OfflineStaging.engages(u8, cuda)
    assert OfflineStaging.engages(f32, cuda)
    assert OfflineStaging.engages(planes_of(clip("yuv", 0, 2)), cuda)
    assert not OfflineStaging.engages(u8, cpu)
    assert not OfflineStaging.engages(
        planes_of(rgb(0, 2).astype(np.float64)), cuda)


def test_sonify_counts_direct_chunks_on_the_cpu():
    aur = Auralizer(config=CFG, device="cpu")
    assert aur.ingest_metrics() == {"staging_allocs": 0, "staging_reuses": 0,
                                    "staged_chunks": 0, "direct_chunks": 0}
    aur.sonify(rgb(1, 70))                        # two chunks of 64
    aur.sonify(rgb(2, 4))                         # scan: not chunked
    assert aur.ingest_metrics()["direct_chunks"] == 2
    assert aur.ingest_metrics()["staged_chunks"] == 0


# ---- the staged walk with the card's streams and events stood in for -------

class _Event:
    def __init__(self, *a, **k):
        self.recorded = 0

    def record(self, stream=None):
        self.recorded += 1

    def synchronize(self):
        assert self.recorded, "a wait on an event never recorded"


class _Stream:
    def __init__(self, device=None):
        self.device = device
        self.waits = []

    def wait_event(self, ev):
        assert ev.recorded, "a wait on an event never recorded"
        self.waits.append(ev)
        time.sleep(0.002)       # room for the staging thread to run ahead


@pytest.fixture
def stand_in(monkeypatch):
    """The staged walk on the CPU: events, streams and the device context
    stood in for (copies are synchronous there), every clip staged, and
    three frames a slice so that a chunk of 8 has three slices."""
    compute = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: compute)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: None,
                        raising=False)
    monkeypatch.setattr(OfflineStaging, "engages",
                        staticmethod(lambda planes, device: True))
    monkeypatch.setattr(staging, "SLICE_BYTES", 3 * H * W * 3)
    return compute


@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
@pytest.mark.parametrize("T", [3 * CHUNK + 3, CHUNK, 5])
def test_staged_walk_equals_the_direct_path(stand_in, kind, T):
    f = clip(kind, 10 + T, T)
    st = OfflineStaging(pinned=False)
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
    assert torch.equal(a, b)
    n = -(-T // CHUNK)
    assert st.metrics() == {"staging_allocs": 1, "staging_reuses": 0,
                            "staged_chunks": n, "direct_chunks": 0}
    assert len(stand_in.waits) == n          # one wait a chunk, its last
    per = slice_frames(frame_bytes(f))
    assert st._bufs[0][None if kind != "yuv" else "y"].shape[0] == per


def test_at_most_two_chunks_are_held_at_once(stand_in, monkeypatch):
    """A chunk's device tensor is made only once no more than one other
    chunk's is still held: the dispatching thread lets go of a chunk
    before it marks it run."""
    real = torch.empty
    held, most = [], [0]

    def empty(*shape, **kw):
        t = real(*shape, **kw)
        if kw.get("device") is not None and tuple(t.shape[1:]) == (H, W, 3):
            held.append(weakref.ref(t))
            most[0] = max(most[0], sum(r() is not None for r in held))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    st = OfflineStaging(pinned=False)
    for seed in range(3):
        run_offline_batched(rgb(seed, 6 * CHUNK + 3), CFG, chunk=CHUNK,
                            device="cpu", staging=st)
    assert len(held) == 3 * 7 and most[0] <= 2


def test_staged_walk_reuses_the_ring_across_calls(stand_in):
    st = OfflineStaging(pinned=False)
    for seed, T in ((1, 2 * CHUNK + 3), (2, CHUNK + 1), (3, 3)):
        f = rgb(seed, T)
        a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                      staging=st)
        b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
        assert torch.equal(a, b)
    assert st.metrics() == {"staging_allocs": 1, "staging_reuses": 2,
                            "staged_chunks": 6, "direct_chunks": 0}


def test_a_failing_step_stops_the_staging_thread(stand_in, monkeypatch):
    """A step that raises mid-clip reaches the caller, and the call
    returns only once the staging thread has stopped; the next clip
    stages as usual."""
    st = OfflineStaging(pinned=False)
    real = chunked.chunk_pipeline
    calls = []

    def failing(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return real(*a, **k)

    monkeypatch.setattr(chunked, "chunk_pipeline", failing)
    f = rgb(4, 5 * CHUNK)
    with pytest.raises(RuntimeError, match="step failed"):
        run_offline_batched(f, CFG, chunk=CHUNK, device="cpu", staging=st)
    monkeypatch.setattr(chunked, "chunk_pipeline", real)
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
    assert torch.equal(a, b)


def test_a_failing_fill_reaches_the_caller(stand_in, monkeypatch):
    st = OfflineStaging(pinned=False)
    real = staging._copy_rows
    calls = []

    def failing(dst, src, run):
        calls.append(1)
        if len(calls) == 4:
            raise ValueError("fill failed")
        real(dst, src, run)

    monkeypatch.setattr(staging, "_copy_rows", failing)
    with pytest.raises(ValueError, match="fill failed"):
        run_offline_batched(rgb(5, 3 * CHUNK), CFG, chunk=CHUNK,
                            device="cpu", staging=st)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.fixture
def small_slices(monkeypatch):
    """Three frames a slice, so a chunk of 8 crosses in three slices and
    the ring of three turns over within a chunk."""
    monkeypatch.setattr(staging, "SLICE_BYTES", 3 * H * W * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
@pytest.mark.parametrize("T", [4 * CHUNK + 3, CHUNK + 3, 3])
def test_staged_pcm_equals_the_direct_path_on_the_card(dev, small_slices,
                                                       kind, T):
    f = clip(kind, 20 + T, T)
    st = OfflineStaging()
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device=dev,
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device=dev)
    assert torch.equal(a, b)
    assert st.metrics() == {"staging_allocs": 1, "staging_reuses": 0,
                            "staged_chunks": -(-T // CHUNK),
                            "direct_chunks": 0}
    for buf in st._bufs:
        assert all(t.is_pinned() for t in buf.values())


@pytest.mark.cuda
def test_back_to_back_clips_and_overwritten_frames_on_the_card(dev,
                                                               small_slices):
    """Clips staged back to back with no wait between them, each host
    array overwritten as soon as its call returns: the ring is refilled
    only after the DMAs that read it, and the caller's memory is read
    before the call returns, so each clip's PCM equals its direct run."""
    clips = [rgb(30 + i, T) for i, T in enumerate((5 * CHUNK + 3, 2 * CHUNK,
                                                   3 * CHUNK + 1))]
    refs = [run_offline_batched(c, CFG, chunk=CHUNK, device=dev)[0]
            for c in clips]
    torch.cuda.synchronize()
    st = OfflineStaging()
    outs = []
    for c in clips:
        outs.append(run_offline_batched(c, CFG, chunk=CHUNK, device=dev,
                                        staging=st)[0])
        c[...] = 255 - c                        # the caller reuses its array
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        assert torch.equal(a, b)
    assert (st.allocs, st.reuses, st.staged_chunks) == (1, 2, 6 + 2 + 4)


@pytest.mark.cuda
def test_at_most_two_chunks_on_the_card(dev):
    """1080p frames in chunks of 8: the staged run's peak of device
    memory is the direct run's plus at most one chunk (the next one,
    crossing while one runs), with the same PCM."""
    f = rgb(50, 6 * CHUNK + 3, h=1080, w=1920)
    chunk_bytes = CHUNK * f[0].nbytes
    st = OfflineStaging()
    run_offline_batched(f[:CHUNK + 1], CFG, chunk=CHUNK, device=dev,
                        staging=st)

    def peak(**kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        pcm = run_offline_batched(f, CFG, chunk=CHUNK, device=dev, **kw)[0]
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base, pcm

    direct, a = peak()
    staged, b = peak(staging=st)
    assert torch.equal(a, b)
    assert staged - direct <= chunk_bytes + 8 * 2 ** 20, (staged, direct)


@pytest.mark.cuda
def test_sonify_stages_on_the_card(dev, small_slices):
    """``Auralizer.sonify`` stages host clips (chunks of 64) through its
    own ring, re-made for each new signature and reused for a kept one,
    takes a clip already on the card direct, and returns the direct
    path's PCM bit for bit, whatever the caller does with its arrays
    once the call has returned."""
    aur = Auralizer(config=CFG, device=dev)
    clips = [clip("u8", 40, 9 * CHUNK + 3), clip("yuv", 41, 2 * CHUNK + 5),
             clip("u8", 42, 9 * CHUNK + 3)]
    for c in clips:
        want = run_offline_batched(c, CFG, aur.params.as_arrays(),
                                   device=dev)[0].cpu().numpy()
        got = aur.sonify(c)
        if isinstance(c, dict):
            for p in c.values():
                p[...] = 0
        else:
            c[...] = 0
        assert np.array_equal(got, want)
    m = aur.ingest_metrics()
    assert (m["staging_allocs"], m["staging_reuses"]) == (3, 0)
    assert m["staged_chunks"] == 2 + 1 + 2 and m["direct_chunks"] == 0
    aur.sonify(torch.as_tensor(rgb(43, CHUNK + 1), device=dev))
    assert aur.ingest_metrics()["direct_chunks"] == 1
    aur.sonify(rgb(44, 9 * CHUNK + 3))
    assert aur.ingest_metrics()["staging_reuses"] == 1
