"""The ingest module (vaudio_torch.runtime.ingest): the host dtype rule
and the direct crossing on every route, nothing made before its first
use, the kept buffers of the stream's chunk and the pod's tick
(``HostBuffers``), and the offline route's page-locked slice ring
(``OfflineStaging``): the slice plan and the fill on the CPU, the direct
path a CPU device takes, the ring's re-making on a signature change, the
staged walk's order and failures with the card's streams and events
stood in for, and on the card (``cuda``-marked) the staged PCM equal to
the direct path's bit for bit.  The pod's tick buffer at 32x48 frames
and a few ticks: made at the first tick and re-made only when the
tick's stacked signature changes (``staging_allocs``), every other tick
stacked into it (``staging_reuses``); the step's batch never shares its
memory; zero-copy frames recycled two ticks later are consumed within
their tick.  The card's half of the pod's buffer (page-locked) is
tests/test_torch_cuda.py::test_pod_staging_on_the_card_is_pinned.  This
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ingest.py
"""

import contextlib
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import BorrowedFrame
from vaudio_torch.parallel import make_stream_mesh
from vaudio_torch.parallel.sharding import StreamShards
from vaudio_torch.runtime import MultiStreamAuralizer, chunked, ingest
from vaudio_torch.runtime.chunked import run_offline_batched
from vaudio_torch.runtime.engine import AuralizerEngine
from vaudio_torch.runtime.ingest import (RING, OfflineStaging, check_frames,
                                         fill_threads, host_frames,
                                         row_parts, slice_frames, slice_plan,
                                         to_device)
from vaudio_torch.runtime.step import run_offline
from vaudio_torch.utils.profiling import SPANS

H, W = 64, 96
CHUNK = 8
CFG = AuralizerConfig(channels=2)
# The pod's frames.
PH, PW = 32, 48
# The routes' tests check what crosses, not the synthesis: a small grid
# and few partials keep their steps cheap.
SMALL = AuralizerConfig(grid_size=2, num_harmonics=2, num_bessel_synth=2,
                        ring_buffer_frames=64)
HOP = 2048
TIMEOUT = 120.0


def rgb(seed, T, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (T, h, w, 3),
                                                np.uint8)


def clip(kind, seed, T):
    """A clip of T frames: RGB u8, RGB f32 or f64 in [0, 1], or planar
    YUV."""
    if kind == "yuv":
        g = np.random.default_rng(seed)
        return {"y": g.integers(16, 236, (T, H, W), np.uint8),
                "u": g.integers(16, 241, (T, H // 2, W // 2), np.uint8),
                "v": g.integers(16, 241, (T, H // 2, W // 2), np.uint8)}
    f = rgb(seed, T)
    if kind == "f64":
        return f / 255.0
    return (f / np.float32(255.0)).astype(np.float32) if kind == "f32" else f


def frame_bytes(f):
    planes = f.values() if isinstance(f, dict) else [f]
    return sum(p[0].nbytes for p in planes)


def planes_of(f):
    f = check_frames(f)
    return f if isinstance(f, dict) else {None: f}


# ---- the host dtype rule and the crossing on every route -------------------

def frames_of(f):
    """A clip's frames one by one, as a live or a pod source yields them."""
    if isinstance(f, dict):
        return [{k: v[t] for k, v in f.items()} for t in range(len(f["y"]))]
    return list(f)


def dtypes(frames):
    return {p.dtype for p in (frames.values() if isinstance(frames, dict)
                              else [frames])}


def spying(step, seen):
    def spy(carry, frames, params):
        seen.update(dtypes(frames))
        return step(carry, frames, params)
    return spy


@pytest.mark.parametrize("kind", ["u8", "f32", "f64", "yuv"])
def test_every_route_crosses_in_the_host_dtype(kind):
    """One host dtype rule on every route: u8 RGB and planar-YUV planes
    cross as they are, f32 as it is, f64 as f32.  The offline direct path,
    the live stream and the pod hand their steps that dtype, and each
    gives the PCM of the clip cast on the host, bit for bit."""
    T = 3
    f = clip(kind, 90, T)
    want = torch.uint8 if kind in ("u8", "yuv") else torch.float32
    host = host_frames(f)
    assert dtypes(check_frames(host)) == {want}
    assert dtypes(to_device(check_frames(f), "cpu")) == {want}
    ref = run_offline(f, SMALL, device="cpu")[0].numpy()
    if kind == "f64":
        np.testing.assert_array_equal(
            run_offline(host, SMALL, device="cpu")[0].numpy(), ref)
    aur = Auralizer(source=frames_of(f), config=SMALL, device="cpu",
                    debug=False, prefer_native=False)
    live_seen, pod_seen = set(), set()
    aur._stream._step = spying(aur._stream._step, live_seen)
    aur.run_until_exhausted(timeout=TIMEOUT)
    np.testing.assert_array_equal(aur.pull(T * HOP), ref)
    p = MultiStreamAuralizer(SMALL, n_streams=1, prefer_native=False,
                             engine=AuralizerEngine(SMALL, device="cpu"))
    p._step = spying(p._step, pod_seen)
    run(p, [frames_of(f)])
    np.testing.assert_array_equal(p.pull(0, T * HOP), ref)
    p.stop()
    assert live_seen == pod_seen == {want}


# ---- nothing made before its first use -------------------------------------

def staging_threads():
    return {t.ident for t in threading.enumerate()
            if t.name.startswith(("vaudio-fill", "vaudio-stage"))}


def test_nothing_is_made_before_its_first_use():
    """Constructing an Auralizer, a pod and a started one-frame stream
    makes no host buffer, no fill or staging thread and no copy stream:
    the ring waits for the first staged clip, the tick buffer for the
    first tick, the chunk buffer for the first chunk."""
    before = staging_threads()
    aur = Auralizer(config=CFG, device="cpu")
    p = make_pod(2)
    release = threading.Event()

    def source():
        release.wait(TIMEOUT)
        yield from rgb_clip(0, 3)

    live = Auralizer(source=source(), config=SMALL, device="cpu",
                     prefer_native=False)
    live.start()
    try:
        st = aur._staging
        assert aur.ingest_metrics()["staging_allocs"] == 0 and st.bufs == []
        assert (st._fill, st._stager, st._copy_stream) == (None, None, None)
        assert p.metrics_dict()["staging_allocs"] == 0
        assert p._staging.bufs == []
        assert live._stream._staging.allocs == 0
        assert live._stream._staging.bufs == []
        assert staging_threads() <= before
    finally:
        release.set()
        live.stop()
    run(p, [rgb_clip(s, 2) for s in range(2)])
    assert p.metrics_dict()["staging_allocs"] == 1
    p.stop()


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
    assert RING * ingest.SLICE_BYTES < 0.6e9
    for fb in (uhd, hd, 18432, 3 * 2 ** 20):
        assert slice_frames(fb) * fb <= ingest.SLICE_BYTES
        assert (slice_frames(fb) + 1) * fb > ingest.SLICE_BYTES
    assert slice_frames(ingest.SLICE_BYTES * 3) == 1


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
        1, min(want, cpus - 1, ingest.MAX_FILL_THREADS))


def test_stage_span_is_registered():
    assert "vaudio.ingest.stage" in SPANS


# ---- the ring, the fill and the direct path on the CPU ---------------------

def test_ring_is_remade_only_on_a_new_signature():
    """One ring of RING buffers a plane, kept while the frame signature
    and the slice length stay, re-made on a new shape, dtype or plane
    set; plain host memory for a CPU device."""
    st = OfflineStaging("cpu")
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
    st = OfflineStaging("cpu")
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
    st = OfflineStaging("cpu")
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
    assert torch.equal(a, b)
    assert st.metrics() == {"staging_allocs": 0, "staging_reuses": 0,
                            "staged_chunks": 0, "direct_chunks": 3}
    assert st._fill is None and st._stager is None and st.bufs == []


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
    monkeypatch.setattr(ingest, "SLICE_BYTES", 3 * H * W * 3)
    return compute


@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
@pytest.mark.parametrize("T", [3 * CHUNK + 3, CHUNK, 5])
def test_staged_walk_equals_the_direct_path(stand_in, kind, T):
    f = clip(kind, 10 + T, T)
    st = OfflineStaging("cpu")
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu",
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device="cpu")
    assert torch.equal(a, b)
    n = -(-T // CHUNK)
    assert st.metrics() == {"staging_allocs": 1, "staging_reuses": 0,
                            "staged_chunks": n, "direct_chunks": 0}
    assert len(stand_in.waits) == n          # one wait a chunk, its last
    per = slice_frames(frame_bytes(f))
    assert st.bufs[0][None if kind != "yuv" else "y"].shape[0] == per


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
    st = OfflineStaging("cpu")
    for seed in range(3):
        run_offline_batched(rgb(seed, 6 * CHUNK + 3), CFG, chunk=CHUNK,
                            device="cpu", staging=st)
    assert len(held) == 3 * 7 and most[0] <= 2


def test_staged_walk_reuses_the_ring_across_calls(stand_in):
    st = OfflineStaging("cpu")
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
    st = OfflineStaging("cpu")
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
    st = OfflineStaging("cpu")
    real = ingest._copy_rows
    calls = []

    def failing(dst, src, run):
        calls.append(1)
        if len(calls) == 4:
            raise ValueError("fill failed")
        real(dst, src, run)

    monkeypatch.setattr(ingest, "_copy_rows", failing)
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
    monkeypatch.setattr(ingest, "SLICE_BYTES", 3 * H * W * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "f32", "yuv"])
@pytest.mark.parametrize("T", [4 * CHUNK + 3, CHUNK + 3, 3])
def test_staged_pcm_equals_the_direct_path_on_the_card(dev, small_slices,
                                                       kind, T):
    f = clip(kind, 20 + T, T)
    st = OfflineStaging(dev)
    a, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device=dev,
                                  staging=st)
    b, _, _ = run_offline_batched(f, CFG, chunk=CHUNK, device=dev)
    assert torch.equal(a, b)
    assert st.metrics() == {"staging_allocs": 1, "staging_reuses": 0,
                            "staged_chunks": -(-T // CHUNK),
                            "direct_chunks": 0}
    for buf in st.bufs:
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
    st = OfflineStaging(dev)
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
    st = OfflineStaging(dev)
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


# ---- the pod's tick buffer --------------------------------------------------

def rgb_clip(seed, T):
    return np.random.default_rng(seed).integers(0, 256, (T, PH, PW, 3),
                                                np.uint8)


def yuv_clip(seed, T):
    """T planar-YUV 4:2:0 frames, a dict of u8 planes each."""
    g = np.random.default_rng(seed)
    return [{"y": g.integers(16, 236, (PH, PW), np.uint8),
             "u": g.integers(16, 241, (PH // 2, PW // 2), np.uint8),
             "v": g.integers(16, 241, (PH // 2, PW // 2), np.uint8)}
            for _ in range(T)]


def make_pod(n_streams, **kwargs):
    cfg = AuralizerConfig()
    return MultiStreamAuralizer(
        cfg, n_streams=n_streams, prefer_native=False,
        engine=AuralizerEngine(cfg, device="cpu"), **kwargs)


def wait_for(cond, p):
    t0 = time.monotonic()
    while not cond():
        p.raise_if_failed()
        assert time.monotonic() - t0 < TIMEOUT
        time.sleep(0.005)


def run(p, sources):
    p.start([iter(s) for s in sources])
    wait_for(lambda: not p.is_running, p)
    p.raise_if_failed()
    return p


def counts(p):
    m = p.metrics_dict()
    return m["staging_allocs"], m["staging_reuses"], m["dispatches"]


def test_steady_pod_allocates_once():
    """S = 3 over 6 ticks: one buffer, made at the first tick and kept."""
    p = run(make_pod(3), [rgb_clip(s, 6) for s in range(3)])
    assert counts(p) == (1, 5, 6)
    buf = p._staging.bufs[0][None]
    assert buf.shape == (3, PH, PW, 3) and buf.dtype == torch.uint8
    assert not buf.is_pinned()         # a CPU engine: plain host memory
    p.stop()


def test_resize_remakes_the_buffer_once_each_way():
    """A live grow 1 -> 2 and a shrink 2 -> 1 each add exactly one alloc;
    every other tick reuses."""
    p = make_pod(1, exit_when_exhausted=False)
    p.start([iter(rgb_clip(0, 3))])
    wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 3, p)
    assert counts(p)[:2] == (1, 2)
    p.resize(2)
    p.replace_source(0, iter(rgb_clip(1, 3)))
    p.replace_source(1, iter(rgb_clip(2, 3)))
    wait_for(lambda: p.stream_metrics(1)["buffer_fill"] >= 3, p)
    allocs, reuses, dispatches = counts(p)
    assert allocs == 2 and reuses == dispatches - 2
    assert p._staging.bufs[0][None].shape[0] == 2
    p.resize(1)
    p.pull(0, 6 * HOP)
    p.replace_source(0, iter(rgb_clip(3, 4)))
    wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 4, p)
    allocs, reuses, dispatches = counts(p)
    assert allocs == 3 and reuses == dispatches - 3
    assert p._staging.bufs[0][None].shape[0] == 1
    p.stop()


@pytest.mark.parametrize("chunk,yuv", [(3, False), (1, True), (3, True)])
def test_chunked_and_yuv_pods_keep_their_own_buffers(chunk, yuv):
    """A chunked pod stacks into one (S, T, ...) buffer, a planar-YUV pod
    into one buffer a plane; each made once."""
    sources = ([yuv_clip(s, 6) for s in range(2)] if yuv
               else [rgb_clip(s, 6) for s in range(2)])
    p = run(make_pod(2, chunk_frames=chunk), sources)
    assert counts(p) == (1, 6 // chunk - 1, 6 // chunk)
    lead = (2, chunk) if chunk > 1 else (2,)
    bufs = p._staging.bufs[0]
    want = ({"y": (PH, PW), "u": (PH // 2, PW // 2),
             "v": (PH // 2, PW // 2)} if yuv else {None: (PH, PW, 3)})
    assert {k: tuple(b.shape) for k, b in bufs.items()} \
        == {k: lead + s for k, s in want.items()}
    p.stop()


def _leaves(tree):
    if isinstance(tree, StreamShards):
        return [x for part in tree for x in _leaves(part)]
    if isinstance(tree, dict):
        return list(tree.values())
    return [tree]


@pytest.mark.parametrize("case", ["rgb", "chunked", "yuv", "mesh"])
def test_step_batch_never_shares_the_staging_buffer(case):
    """On the CPU, where ``.to`` alone would hand back the same memory,
    the tick's put copies: no leaf of the step's batch (a mesh's shards
    included) shares memory with the staging buffer."""
    kwargs = {"chunk_frames": 2} if case == "chunked" else {}
    if case == "mesh":
        kwargs.update(mesh=make_stream_mesh(2, 1, devices=["cpu"] * 2),
                      params=LiveParams())     # a mesh shares one
    p = make_pod(2, **kwargs)
    seen = []
    step = p._step

    def spy(carry, batch, params):
        staged = [b.numpy() for b in p._staging.bufs[0].values()]
        seen.append(any(np.shares_memory(x.numpy(), s)
                        for x in _leaves(batch) for s in staged))
        return step(carry, batch, params)

    p._step = spy
    sources = ([yuv_clip(s, 4) for s in range(2)] if case == "yuv"
               else [rgb_clip(s, 4) for s in range(2)])
    run(p, sources)
    assert seen == [False] * p.metrics.dispatches and seen
    p.stop()


def pooled(clip, n_buffers=3, lag=2):
    """``clip``'s frames as read-only :class:`BorrowedFrame` views over a
    pool of ``n_buffers`` slots, each view's slot recycled (overwritten
    with other bytes) ``lag`` iterations after it was yielded, as
    ``NativeFrameReader.frames_view`` recycles its pool."""
    pool = np.zeros((n_buffers,) + clip.shape[1:], np.uint8)
    for n, frame in enumerate(clip):
        if n >= lag:
            pool[(n - lag) % n_buffers] = 255 - pool[(n - lag) % n_buffers]
        pool[n % n_buffers] = frame
        view = pool[n % n_buffers].view(BorrowedFrame)
        view.flags.writeable = False
        yield view


@pytest.mark.parametrize("chunk", [1, 3])
def test_borrowed_frames_equal_owned_frames(chunk):
    """A pod fed pool views recycled two ticks later gives bit for bit the
    PCM of the same pod fed owned frames: the stack into the staging
    buffer (chunks: ``own_frame``) consumes each view within its tick."""
    clips = [rgb_clip(10 + s, 6) for s in range(2)]
    owned = run(make_pod(2, chunk_frames=chunk), clips)
    borrowed = run(make_pod(2, chunk_frames=chunk),
                   [pooled(c) for c in clips])
    for s in range(2):
        want = owned.pull(s, 6 * HOP)
        assert np.any(want)
        np.testing.assert_array_equal(borrowed.pull(s, 6 * HOP), want)
    owned.stop()
    borrowed.stop()


def test_stream_chunks_reuse_one_buffer():
    """A stream in chunks of 3 stacks its 10 chunks into one kept host
    buffer, made at the first, and gives run_offline_batched's PCM."""
    frames = rgb_clip(20, 30)
    aur = Auralizer(source=frames, config=SMALL, device="cpu", debug=False,
                    prefer_native=False, chunk_frames=3)
    aur.run_until_exhausted(timeout=TIMEOUT)
    st = aur._stream._staging
    assert (st.allocs, st.reuses) == (1, 9)
    assert st.bufs[0][None].shape == (3, PH, PW, 3)
    want, _, _ = run_offline_batched(frames, SMALL, chunk=3, device="cpu")
    np.testing.assert_array_equal(aur.pull(30 * HOP), want.numpy())
