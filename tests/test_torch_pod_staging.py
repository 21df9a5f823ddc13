"""The serving pod's tick staging buffer (vaudio_torch.runtime.multistream
``_TickStaging``) on the CPU, at 32x48 frames and a few ticks: one host
buffer a leaf of the tick's stacked signature, made at the first tick and
re-made only when that signature changes (``staging_allocs``), every
other tick stacked into it (``staging_reuses``); the step's batch never
shares its memory; zero-copy frames recycled two ticks later are consumed
within their tick.  The card's half (a page-locked buffer) is
tests/test_torch_cuda.py::test_pod_staging_on_the_card_is_pinned.
"""

import time

import numpy as np
import pytest
import torch

from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import BorrowedFrame
from vaudio_torch.parallel import make_stream_mesh
from vaudio_torch.parallel.sharding import StreamShards
from vaudio_torch.runtime import MultiStreamAuralizer
from vaudio_torch.runtime.engine import AuralizerEngine

H, W = 32, 48
HOP = 2048
TIMEOUT = 120.0


def rgb_clip(seed, T):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3),
                                                np.uint8)


def yuv_clip(seed, T):
    """T planar-YUV 4:2:0 frames, a dict of u8 planes each."""
    g = np.random.default_rng(seed)
    return [{"y": g.integers(16, 236, (H, W), np.uint8),
             "u": g.integers(16, 241, (H // 2, W // 2), np.uint8),
             "v": g.integers(16, 241, (H // 2, W // 2), np.uint8)}
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
    buf = p._staging._bufs[None]
    assert buf.shape == (3, H, W, 3) and buf.dtype == torch.uint8
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
    assert p._staging._bufs[None].shape[0] == 2
    p.resize(1)
    p.pull(0, 6 * HOP)
    p.replace_source(0, iter(rgb_clip(3, 4)))
    wait_for(lambda: p.stream_metrics(0)["buffer_fill"] >= 4, p)
    allocs, reuses, dispatches = counts(p)
    assert allocs == 3 and reuses == dispatches - 3
    assert p._staging._bufs[None].shape[0] == 1
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
    bufs = p._staging._bufs
    want = ({"y": (H, W), "u": (H // 2, W // 2), "v": (H // 2, W // 2)}
            if yuv else {None: (H, W, 3)})
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
        staged = [b.numpy() for b in p._staging._bufs.values()]
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
