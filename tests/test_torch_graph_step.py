"""The per-frame step as a CUDA graph (``runtime.step.GraphedStep``): the
live stream's step (``make_step``) and the pod's tick (``raw_step``).

On the CPU: the input signature that decides a capture, the eager step
the CPU keeps, the counters on the stream's and the pod's metrics, the
replay span, and the wrapper's bookkeeping with the card's streams and
graphs stood in for (:func:`card`: a replay runs the captured step again
on the static inputs and overwrites the captured outputs, as a replay
does): replays equal to the eager step bit for bit through a params
change and a restored carry, results that outlive the next replay, the
caller's carry untouched, a capture per signature with the newest two
kept, the kernels' launch counters, and a failed capture falling back to
the eager step.

On the card (``cuda``-marked, skipped without one): the graphed step
``torch.equal`` to ``frame_step`` called eagerly with the same constants,
PCM and every carry field, over 40+ frames at 1080p, RGB and YUV, the
pod at S = 8 then 3, the stream with ``pipeline_depth`` 2, and the
counters.  This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_step.py
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from torch_frames import structured_frames, structured_yuv_frames
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.dsp.core import hann_window_norm
from vaudio_torch.ops import pool_kernel, spectrum_kernel
from vaudio_torch.runtime import MultiStreamAuralizer, step
from vaudio_torch.runtime.engine import AuralizerEngine
from vaudio_torch.runtime.step import (GraphedStep, StepCarry, frame_step,
                                       init_carry, params_to_device,
                                       step_signature)
from vaudio_torch.runtime.stream import StreamingAuralizer
from vaudio_torch.synth.spectrum import SynthConstants
from vaudio_torch.utils.profiling import SPANS

# A ring that holds a whole test stream.
CFG = AuralizerConfig(channels=2, ring_buffer_frames=64)
# The bookkeeping tests check what the wrapper copies and counts, not the
# synthesis: a small grid and few partials keep their steps cheap.
SMALL = AuralizerConfig(grid_size=2, num_harmonics=2, num_bessel_synth=2,
                        channels=2)
H, W = 64, 96
COUNTS = ("graph_captures", "graph_replays", "eager_steps")
TIMEOUT = 120.0


# ---- the card stood in for ---------------------------------------------------

class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def card(monkeypatch):
    """``GraphedStep`` on a CPU device as on a card: the graph, its
    capture and the streams stood in for.  The capture records the step;
    a replay runs it again on the static inputs (``state["replaying"]``
    set) and writes the results into the captured outputs."""
    state = {"capturing": False, "replaying": False}
    run = GraphedStep._run

    class Graph:
        def replay(self):
            state["replaying"] = True
            try:
                new, out = self.run()
            finally:
                state["replaying"] = False
            for dst, src in zip((*self.out[0], *self.out[1].values()),
                                (*new, *out.values())):
                dst.copy_(src)

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local" and stream is not None
        state["capturing"] = True
        try:
            yield
        finally:
            state["capturing"] = False

    def recording_run(self, g):
        result = run(self, g)
        if state["capturing"]:
            g.graph.run = lambda: run(self, g)
            g.graph.out = result
        return result

    monkeypatch.setattr(GraphedStep, "_run", recording_run)
    monkeypatch.setattr(GraphedStep, "graphed", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    return state


# ---- helpers -----------------------------------------------------------------

def _params(live=None, n=None):
    arrays = (live or LiveParams()).as_arrays()
    if n is None:
        return arrays
    return {k: np.stack([v] * n) for k, v in arrays.items()}


def _eager(cfg, device):
    """``frame_step`` called eagerly with constants of its own."""
    consts = SynthConstants.create(cfg, device)
    window = torch.as_tensor(hann_window_norm(cfg.nfft), device=device)

    def run(carry, frame, params, debug=False):
        return frame_step(carry, frame, params_to_device(params, cfg, device),
                          cfg, consts, window, debug=debug)
    return run


def _assert_same(got, want):
    (gc, go), (wc, wo) = got, want
    for name in StepCarry._fields:
        assert torch.equal(getattr(gc, name), getattr(wc, name)), name
    assert set(go) == set(wo)
    for k in wo:
        assert torch.equal(go[k], wo[k]), k


def _chain(run, carry, frames, params_at, restore=None):
    """``run`` over ``frames`` from ``carry``: the params of each frame from
    ``params_at(t)``, the carry replaced by ``restore[1]`` at frame
    ``restore[0]``; every (carry, out)."""
    results = []
    for t, frame in enumerate(frames):
        if restore is not None and t == restore[0]:
            carry = restore[1]
        carry, out = run(carry, frame, params_at(t))
        results.append((carry, out))
    return results


def _carry_copy(carry):
    return StepCarry(*(x.clone() for x in carry))


# ---- the signature -----------------------------------------------------------

def _sig_inputs():
    carry = init_carry(SMALL, "cpu")
    frame = torch.zeros((H, W, 3), dtype=torch.uint8)
    return carry, frame, _params()


def _yuv(frame):
    h, w = frame.shape[:2]
    return {"y": torch.zeros((h, w), dtype=torch.uint8),
            "u": torch.zeros((h // 2, w // 2), dtype=torch.uint8),
            "v": torch.zeros((h // 2, w // 2), dtype=torch.uint8)}


def _batch(carry, n):
    return StepCarry(*(x.expand((n,) + x.shape).contiguous()
                       for x in carry))


VARIANTS = {
    "layout": lambda c, f, p, d: (c, _yuv(f), p, d),
    "shape": lambda c, f, p, d: (c, torch.zeros((H, W + 8, 3),
                                                dtype=torch.uint8), p, d),
    "dtype": lambda c, f, p, d: (c, f.to(torch.float32), p, d),
    "stream_axis": lambda c, f, p, d: (_batch(c, 3), f[None].expand(
        3, *f.shape), _params(n=3), d),
    "stream_count": lambda c, f, p, d: (_batch(c, 2), f[None].expand(
        2, *f.shape), _params(n=2), d),
    "carry_shape": lambda c, f, p, d: (init_carry(CFG, "cpu"), f, p, d),
    "param_keys": lambda c, f, p, d: (c, f, {**p, "pan_angles": np.zeros(
        SMALL.num_cells, np.float32)}, d),
    "param_dims": lambda c, f, p, d: (c, f, {**p, "attack": np.zeros(
        (1,), np.float32)}, d),
    "device": lambda c, f, p, d: (c, f, p, torch.device("cuda")),
}


@pytest.mark.parametrize("what", sorted(VARIANTS))
def test_signature_tells_apart(what):
    """Each of layout, frame shape, dtype, stream axis and count, carry
    shapes, params' keys and dims, and device gives another signature."""
    carry, frame, params = _sig_inputs()
    base = step_signature(carry, frame, params, "cpu")
    assert base == step_signature(_carry_copy(carry), frame.clone(),
                                  dict(params), torch.device("cpu"))
    assert step_signature(*VARIANTS[what](carry, frame, params,
                                          torch.device("cpu"))) != base


def test_signature_tells_stream_counts_apart():
    """A pod resized from 3 streams to 2 captures again."""
    carry, frame, params = _sig_inputs()
    three = VARIANTS["stream_axis"](carry, frame, params, "cpu")
    two = VARIANTS["stream_count"](carry, frame, params, "cpu")
    assert step_signature(*three) != step_signature(*two)


def test_signature_ignores_values():
    """Values are read through the static buffers: new values, the same
    signature."""
    carry, frame, params = _sig_inputs()
    other = StepCarry(*(x + 1 for x in carry))
    live = LiveParams(attack=0.5, stereo_width=0.2)
    assert step_signature(other, frame + 7, live.as_arrays(), "cpu") == \
        step_signature(carry, frame, params, "cpu")


# ---- the CPU stays eager -----------------------------------------------------

def test_the_cpu_step_stays_eager():
    """On the CPU ``make_step`` and the pod's ``raw_step`` run
    ``frame_step`` eagerly: ``eager_steps`` counts every call, nothing is
    captured."""
    frames = structured_frames(3, 3, H, W)
    live = step.make_step(SMALL, device="cpu")
    raw = AuralizerEngine(SMALL, device="cpu").raw_step()
    assert not raw.graphed
    carry = init_carry(SMALL, "cpu")
    batch = _batch(carry, 2)
    for f in frames:
        carry, _ = live(carry, f, _params())
        batch, _ = raw(batch, torch.as_tensor(np.stack([f, f])),
                       _params(n=2))
    want = dict.fromkeys(COUNTS, 0) | {"eager_steps": 3}
    assert live.counts() == want and raw.counts() == want
    assert not raw._graphs


def test_debug_stays_eager_on_the_cpu():
    """``debug`` on the CPU: eager, with the debug outputs."""
    live = step.make_step(SMALL, debug=True, device="cpu")
    _carry, out = live(init_carry(SMALL, "cpu"),
                       structured_frames(4, 1, H, W)[0], _params())
    assert {"pcm", "hues", "grads", "spectrum"} <= set(out)
    assert live.counts()["eager_steps"] == 1
    assert live.counts()["graph_captures"] == 0


def test_replay_span_is_listed():
    assert "vaudio.step.replay" in SPANS


def test_mesh_steps_stay_eager(card, monkeypatch):
    """The mesh steps of ``parallel`` take the engine's eager step, even
    where the engine's own step would capture."""
    from vaudio_torch.parallel import make_batched_step, make_stream_mesh
    from vaudio_torch.parallel.sharding import _engine_step

    def no_capture(*args):
        raise AssertionError("a mesh step captured a graph")

    monkeypatch.setattr(GraphedStep, "_capture", no_capture)
    eng = AuralizerEngine(SMALL, device="cpu")
    one = make_batched_step(SMALL, device="cpu")
    mesh = _engine_step(eng, make_stream_mesh(1, 1, devices=["cpu"]),
                        chunk=False, params_sharded=False)
    frames = torch.as_tensor(structured_frames(5, 2, H, W))
    carry = _batch(init_carry(SMALL, "cpu"), 2)
    _c, out = one(carry, frames, _params())
    _m, mout = mesh(carry, frames, _params())
    ref = _eager(SMALL, "cpu")(carry, frames, _params(n=2))
    assert torch.equal(out["pcm"], ref[1]["pcm"])
    assert torch.equal(mout["pcm"].gather("cpu"), ref[1]["pcm"])


# ---- the counters on the stream's and the pod's metrics ---------------------

def test_stream_metrics_expose_the_counters():
    """``Auralizer.metrics`` carries the step's three counters for this
    run; on the CPU every frame is an eager step."""
    frames = structured_frames(6, 4, H, W)
    aur = Auralizer(source=frames, config=SMALL, device="cpu",
                    prefer_native=False)
    aur.run_until_exhausted(timeout=TIMEOUT)
    m = aur.metrics
    assert {k: m[k] for k in COUNTS} == {"graph_captures": 0,
                                          "graph_replays": 0,
                                          "eager_steps": 4}
    assert aur._stream.metrics.step_counts() == {k: m[k] for k in COUNTS}
    aur.run_until_exhausted(frames[:2], timeout=TIMEOUT)
    assert aur.metrics["eager_steps"] == 2        # a new run counts anew


def test_pod_metrics_expose_the_counters():
    """``metrics_dict()`` carries the tick step's three counters; on the
    CPU every tick is an eager step, and an OrthoModes pod's step has
    none (zeros)."""
    from vaudio_torch.runtime.engine import OrthoModesEngine
    clips = [structured_frames(7 + s, 3, H, W) for s in range(2)]
    p = MultiStreamAuralizer(SMALL, n_streams=2, prefer_native=False,
                             engine=AuralizerEngine(SMALL, device="cpu"))
    _run_pod(p, clips)
    m = p.metrics_dict()
    assert m["dispatches"] == 3
    assert {k: m[k] for k in COUNTS} == {"graph_captures": 0,
                                          "graph_replays": 0,
                                          "eager_steps": 3}
    p.stop()
    eng = OrthoModesEngine(SMALL, device="cpu")
    o = MultiStreamAuralizer(eng.cfg, n_streams=2, engine=eng,
                             prefer_native=False)
    _run_pod(o, clips)
    assert {k: o.metrics_dict()[k] for k in COUNTS} == dict.fromkeys(
        COUNTS, 0)
    o.stop()


def _run_pod(p, clips):
    p.start([iter(c) for c in clips])
    t0 = time.monotonic()
    while p.is_running:
        assert time.monotonic() - t0 < TIMEOUT, "pod producer still running"
        time.sleep(0.005)
    p.raise_if_failed()


# ---- the wrapper's bookkeeping, the card stood in for ------------------------

def test_replays_equal_the_eager_step(card):
    """Captured at the first frame, replayed at the others: PCM and every
    carry field equal to frame_step called eagerly, through a LiveParams
    change at frame 6 and a carry restored at frame 9."""
    frames = [torch.as_tensor(f) for f in structured_frames(8, 12, H, W)]
    changed = _params(LiveParams(attack=0.6, release=0.3,
                                 spectrum_mixing=0.5, stereo_width=0.4))

    def params_at(t):
        return _params() if t < 6 else changed

    eager = _chain(_eager(CFG, "cpu"), init_carry(CFG, "cpu"), frames,
                   params_at)
    restored = eager[2][0]
    eager = _chain(_eager(CFG, "cpu"), init_carry(CFG, "cpu"), frames,
                   params_at, restore=(9, restored))
    live = step.make_step(CFG, device="cpu")
    got = _chain(live, init_carry(CFG, "cpu"), frames, params_at,
                 restore=(9, _carry_copy(restored)))
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts() == {"graph_captures": 1, "graph_replays": 11,
                             "eager_steps": 0}


def test_debug_outputs_come_through_the_graph(card):
    """With ``debug`` the hues, gradients and spectrum are outputs of the
    graph too, each equal to the eager step's."""
    frames = [torch.as_tensor(f) for f in structured_frames(9, 4, H, W)]
    run = _eager(SMALL, "cpu")
    eager = _chain(lambda c, f, p: run(c, f, p, debug=True),
                   init_carry(SMALL, "cpu"), frames, lambda t: _params())
    live = step.make_step(SMALL, debug=True, device="cpu")
    got = _chain(live, init_carry(SMALL, "cpu"), frames, lambda t: _params())
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts()["graph_replays"] == 3


def test_results_outlive_the_next_replay(card):
    """Every call returns new tensors: a result held across later replays
    (the drain's queue, the pod's one-tick lag) keeps its values, and the
    carry a caller passes is never written."""
    frames = [torch.as_tensor(f) for f in structured_frames(10, 5, H, W)]
    live = step.make_step(SMALL, device="cpu")
    carry = init_carry(SMALL, "cpu")
    held = []
    for f in frames:
        given = _carry_copy(carry)
        new, out = live(carry, f, _params())
        for name in StepCarry._fields:
            assert torch.equal(getattr(carry, name), getattr(given, name))
        held.append((new, out, _carry_copy(new), out["pcm"].clone()))
        carry = new
    for new, out, new_then, pcm_then in held:
        assert torch.equal(out["pcm"], pcm_then)
        for name in StepCarry._fields:
            assert torch.equal(getattr(new, name), getattr(new_then, name))
    pcms = [h[1]["pcm"] for h in held]
    assert len({p.data_ptr() for p in pcms}) == len(pcms)


def test_a_new_signature_captures_and_two_are_kept(card):
    """The pod's tick at S = 3, then 2, then 3 again (kept: no capture),
    then 1 (a third signature: the oldest graph goes), each tick equal to
    the eager step."""
    eng = AuralizerEngine(SMALL, device="cpu")
    raw = eng.raw_step()
    run = _eager(SMALL, "cpu")
    frames = structured_frames(11, 2, H, W)
    seen = []
    for S in (3, 3, 2, 2, 3, 1, 1):
        carry = eng.init_carry_batch(S)
        batch = torch.as_tensor(np.stack([frames[s % 2] for s in range(S)]))
        _assert_same(raw(carry, batch, _params(n=S)),
                     run(carry, batch, _params(n=S)))
        seen.append(raw.counts()["graph_captures"])
        assert len(raw._graphs) <= GraphedStep.KEEP
    assert seen == [1, 1, 2, 2, 2, 3, 3]
    assert raw.counts()["graph_replays"] == 4
    assert [s[1] for s in raw._graphs] == [3, 1]


def test_yuv_planes_replay(card):
    """A dict of YUV planes is a static buffer a plane."""
    yuv = structured_yuv_frames(12, 4, H, W)
    frames = [{k: torch.as_tensor(v[t]) for k, v in yuv.items()}
              for t in range(4)]
    eager = _chain(_eager(SMALL, "cpu"), init_carry(SMALL, "cpu"), frames,
                   lambda t: _params())
    live = step.make_step(SMALL, device="cpu")
    got = _chain(live, init_carry(SMALL, "cpu"), frames, lambda t: _params())
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts()["graph_replays"] == 3


def test_tensor_params_fill_the_static_buffers(card):
    """Params given as tensors (``params_to_device``) are copied into the
    same static buffers as host values."""
    frames = [torch.as_tensor(f) for f in structured_frames(13, 3, H, W)]
    live = step.make_step(SMALL, device="cpu")
    run = _eager(SMALL, "cpu")
    tensors = [params_to_device(_params(LiveParams(attack=a)), SMALL, "cpu")
               for a in (1.0, 0.5, 0.25)]
    eager = _chain(run, init_carry(SMALL, "cpu"), frames,
                   lambda t: tensors[t])
    got = _chain(live, init_carry(SMALL, "cpu"), frames,
                 lambda t: tensors[t])
    for g, w in zip(got, eager):
        _assert_same(g, w)


def test_launch_counters_count_what_ran(card, monkeypatch):
    """The capture's launches are taken back and added at every replay:
    after N calls each counter moved as N eager steps would move it."""
    def counting(*args, **kwargs):
        if not card["replaying"]:
            pool_kernel.launches += 1
            spectrum_kernel.launches += 2
        return frame_step(*args, **kwargs)

    monkeypatch.setattr(step, "frame_step", counting)
    monkeypatch.setattr(pool_kernel, "launches", 0)
    monkeypatch.setattr(spectrum_kernel, "launches", 0)
    live = step.make_step(SMALL, device="cpu")
    carry = init_carry(SMALL, "cpu")
    for f in structured_frames(14, 5, H, W):
        carry, _ = live(carry, f, _params())
    assert (pool_kernel.launches, spectrum_kernel.launches) == (5, 10)


def test_a_failed_capture_runs_eagerly(card, monkeypatch, capsys):
    """A capture that raises: the call returns the eager step's result,
    stderr says so, and the signature runs eagerly from then on."""
    def refusing(*args, **kwargs):
        if card["capturing"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return frame_step(*args, **kwargs)

    monkeypatch.setattr(step, "frame_step", refusing)
    frames = [torch.as_tensor(f) for f in structured_frames(15, 3, H, W)]
    eager = _chain(_eager(SMALL, "cpu"), init_carry(SMALL, "cpu"), frames,
                   lambda t: _params())
    live = step.make_step(SMALL, device="cpu")
    got = _chain(live, init_carry(SMALL, "cpu"), frames, lambda t: _params())
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts() == {"graph_captures": 0, "graph_replays": 0,
                             "eager_steps": 3}
    assert capsys.readouterr().err.count("runs eagerly") == 1


def test_the_stream_replays_with_pipeline_depth_2(card):
    """The live stream through the graph with two results in flight:
    the ring's PCM equals the eager chain's, one capture, the rest
    replays."""
    frames = structured_frames(16, 8, H, W)
    s = StreamingAuralizer(SMALL, pipeline_depth=2, prefer_native=False,
                           device="cpu")
    s.run_until_exhausted(iter(frames), timeout=TIMEOUT)
    got = s.pull(8 * SMALL.hop_size * 2)
    eager = _chain(_eager(SMALL, "cpu"), init_carry(SMALL, "cpu"),
                   [torch.as_tensor(f) for f in frames], lambda t: _params())
    want = torch.cat([o["pcm"].reshape(-1) for _c, o in eager]).numpy()
    np.testing.assert_array_equal(got, want)
    assert s.metrics.step_counts() == {"graph_captures": 1,
                                       "graph_replays": 7,
                                       "eager_steps": 0}


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _on(dev, frames):
    if isinstance(frames, dict):
        return [{k: torch.as_tensor(v[t], device=dev) for k, v in
                 frames.items()} for t in range(len(frames["y"]))]
    return [torch.as_tensor(f, device=dev) for f in frames]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rgb", "yuv"])
def test_card_live_step_equals_eager(dev, layout):
    """1080p, 44 frames: the graphed live step ``torch.equal`` to
    frame_step called eagerly, PCM and every carry field, through a
    LiveParams change at frame 20 and a carry restored at frame 30; the
    counters: one capture, 43 replays; K2 launched once a frame."""
    make = structured_frames if layout == "rgb" else structured_yuv_frames
    frames = _on(dev, make(21, 44, 1080, 1920))
    changed = _params(LiveParams(attack=0.7, release=0.2,
                                 spectrum_mixing=0.6, stereo_width=0.3))

    def params_at(t):
        return _params() if t < 20 else changed

    run = _eager(CFG, dev)
    restored = _chain(run, init_carry(CFG, dev), frames[:5], params_at)[-1][0]
    eager = _chain(run, init_carry(CFG, dev), frames, params_at,
                   restore=(30, restored))
    live = step.make_step(CFG, device=dev)
    before = spectrum_kernel.launches
    got = _chain(live, init_carry(CFG, dev), frames, params_at,
                 restore=(30, _carry_copy(restored)))
    torch.cuda.synchronize()
    assert spectrum_kernel.launches - before == len(frames)
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts() == {"graph_captures": 1, "graph_replays": 43,
                             "eager_steps": 0}


@pytest.mark.cuda
def test_card_debug_step_equals_eager(dev):
    """With ``debug`` (the Auralizer's default) the hues, gradients and
    spectrum come out of the graph too, each ``torch.equal`` to the eager
    step's, over 12 frames at 1080p."""
    frames = _on(dev, structured_frames(25, 12, 1080, 1920))
    run = _eager(CFG, dev)
    eager = _chain(lambda c, f, p: run(c, f, p, debug=True),
                   init_carry(CFG, dev), frames, lambda t: _params())
    live = step.make_step(CFG, debug=True, device=dev)
    got = _chain(live, init_carry(CFG, dev), frames, lambda t: _params())
    for g, w in zip(got, eager):
        _assert_same(g, w)
    assert live.counts()["graph_replays"] == 11


@pytest.mark.cuda
def test_card_make_step_leaves_the_carry(dev):
    """The carry given to the graphed step is never written, and a result
    held across 5 later replays keeps its values."""
    frames = _on(dev, structured_frames(22, 8, 1080, 1920))
    live = step.make_step(CFG, device=dev)
    carry = init_carry(CFG, dev)
    held = []
    for f in frames:
        given = _carry_copy(carry)
        new, out = live(carry, f, _params())
        for name in StepCarry._fields:
            assert torch.equal(getattr(carry, name), getattr(given, name))
        held.append((out["pcm"], out["pcm"].clone()))
        carry = new
    for pcm, then in held:
        assert torch.equal(pcm, then)


@pytest.mark.cuda
def test_card_pod_resize_captures_once_more(dev):
    """The pod's tick at S = 8 for 40 ticks, then S = 3 for 10: each tick
    ``torch.equal`` to frame_step eagerly on the same batch; two captures,
    48 replays."""
    eng = AuralizerEngine(CFG, device=dev)
    raw = eng.raw_step()
    run = _eager(CFG, dev)
    clip = torch.as_tensor(structured_frames(23, 12, 1080, 1920), device=dev)
    for S, ticks in ((8, 40), (3, 10)):
        carry = eng.init_carry_batch(S)
        ref = carry
        for t in range(ticks):
            batch = torch.stack([clip[(t + s) % 12] for s in range(S)])
            params = _params(LiveParams(attack=1.0 - 0.01 * t), n=S)
            carry, out = raw(carry, batch, params)
            ref, rout = run(ref, batch, params)
            _assert_same((carry, out), (ref, rout))
    assert raw.counts() == {"graph_captures": 2, "graph_replays": 48,
                            "eager_steps": 0}


@pytest.mark.cuda
def test_card_stream_pipeline_depth_2(dev):
    """The live stream on the card with ``pipeline_depth`` 2: the ring's
    PCM equals the eager chain's bit for bit; one capture, the rest
    replays."""
    frames = structured_frames(24, 48, 1080, 1920)
    s = StreamingAuralizer(CFG, pipeline_depth=2, prefer_native=False,
                           device=dev)
    s.run_until_exhausted(iter(frames), timeout=TIMEOUT)
    got = s.pull(48 * CFG.hop_size * 2)
    eager = _chain(_eager(CFG, dev), init_carry(CFG, dev), _on(dev, frames),
                   lambda t: _params())
    want = torch.cat([o["pcm"].reshape(-1) for _c, o in eager]).cpu()
    np.testing.assert_array_equal(got, want.numpy())
    assert s.metrics.step_counts() == {"graph_captures": 1,
                                       "graph_replays": 47,
                                       "eager_steps": 0}
