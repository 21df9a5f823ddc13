"""The port's own spans (``vaudio_torch.utils.profiling.span``) on the CPU:
each path writes its ``vaudio.*`` spans into a ``torch.profiler`` chrome
trace, nested in their callers on the threads that ran them; a profiler
started after the stream's producer thread still records that thread;
with no profiler running no ``record_function`` is ever built; and the
PCM is the same bit for bit with the profiler on and off."""

import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_frames import structured_frames
from vaudio_torch.api import Auralizer
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.runtime.engine import AuralizerEngine
from vaudio_torch.runtime.multistream import MultiStreamAuralizer
from vaudio_torch.runtime.step import params_to_device
from vaudio_torch.utils import profiling
from vaudio_torch.utils.profiling import SPANS, span, trace_context

TIMEOUT = 60.0
CFG = AuralizerConfig(channels=2, ring_buffer_frames=64)
#: Clock slack between a span and the span it nests in (us).
SLACK_US = 1.0


def _profile():
    from torch._C._profiler import _ExperimentalConfig
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _spans(prof, tmp_path):
    """(tid, name, start, end) of every ``vaudio.*`` span in the trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return _spans_in(path)


def _spans_in(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [(e["tid"], e["name"], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith("vaudio.")]


def _inside(inner, outer):
    return (inner[0] == outer[0] and inner[2] >= outer[2] - SLACK_US
            and inner[3] <= outer[3] + SLACK_US and inner is not outer)


def _named(spans, name):
    return [s for s in spans if s[1] == name]


def _frames(T=8, seed=0):
    return structured_frames(seed, T, 64, 64)


def run_sonify():
    return Auralizer(config=CFG, device="cpu").sonify(_frames(16))


def run_stream():
    frames = _frames()
    aur = Auralizer(source=frames, config=CFG, device="cpu")
    aur.run_until_exhausted(timeout=TIMEOUT)
    return aur.pull(len(frames) * CFG.hop_size * CFG.channels)


def run_pod():
    pod = MultiStreamAuralizer(
        CFG, n_streams=2, engine=AuralizerEngine(CFG, device="cpu"))
    clips = [_frames(seed=0), _frames(seed=1)]
    pod.start([iter(c) for c in clips])
    t0 = time.monotonic()
    while pod.is_running:
        assert time.monotonic() - t0 < TIMEOUT, "pod still running"
        time.sleep(0.005)
    pod.raise_if_failed()
    pcm = [pod.pull(s, len(clips[s]) * CFG.hop_size * CFG.channels)
           for s in range(2)]
    pod.stop()
    return np.stack(pcm)


RUNS = {"sonify": run_sonify, "stream": run_stream, "pod": run_pod}

#: For each path: every span of the first name lies inside a span of the
#: second on the same thread (None: a root, on a thread the test names).
NESTING = {
    "sonify": [("vaudio.step", "vaudio.sonify"),
               ("vaudio.readback", "vaudio.sonify"),
               ("vaudio.step.vision", "vaudio.step"),
               ("vaudio.vision.pool", "vaudio.step.vision"),
               ("vaudio.vision.stats", "vaudio.step.vision"),
               ("vaudio.step.synth", "vaudio.step"),
               ("vaudio.step.dsp", "vaudio.step")],
    "stream": [("vaudio.stream.source", None),
               ("vaudio.stream.dispatch", None),
               ("vaudio.ingest.frames", "vaudio.stream.dispatch"),
               ("vaudio.step", "vaudio.stream.dispatch"),
               ("vaudio.stream.enqueue", "vaudio.stream.dispatch"),
               ("vaudio.ingest.params", "vaudio.step"),
               ("vaudio.step.vision", "vaudio.step"),
               ("vaudio.vision.pool", "vaudio.step.vision"),
               ("vaudio.vision.stats", "vaudio.step.vision"),
               ("vaudio.step.synth", "vaudio.step"),
               ("vaudio.step.dsp", "vaudio.step"),
               ("vaudio.stream.flush", None),
               ("vaudio.readback", "vaudio.stream.flush")],
    "pod": [("vaudio.pod.tick", None),
            ("vaudio.pod.sources", "vaudio.pod.tick"),
            ("vaudio.pod.stack", "vaudio.pod.tick"),
            ("vaudio.ingest.frames", "vaudio.pod.tick"),
            ("vaudio.step", "vaudio.pod.tick"),
            ("vaudio.ingest.params", "vaudio.step"),
            ("vaudio.step.vision", "vaudio.step"),
            ("vaudio.vision.pool", "vaudio.step.vision"),
            ("vaudio.vision.stats", "vaudio.step.vision"),
            ("vaudio.step.synth", "vaudio.step"),
            ("vaudio.step.dsp", "vaudio.step"),
            ("vaudio.pod.flush", "vaudio.pod.tick"),
            ("vaudio.readback", "vaudio.pod.flush")],
}


@pytest.mark.parametrize("path", sorted(RUNS))
def test_spans_nest_on_their_threads(path, tmp_path):
    with _profile() as prof:
        RUNS[path]()
    spans = _spans(prof, tmp_path)
    main = threading.get_native_id()
    for inner, outer in NESTING[path]:
        found = _named(spans, inner)
        assert found, f"no {inner} span"
        if outer is None:
            continue
        for s in found:
            assert any(_inside(s, o) for o in _named(spans, outer)), \
                f"{inner} at {s[2]} lies in no {outer} span"
    threads = {name: {s[0] for s in _named(spans, name)}
               for name, _ in NESTING[path]}
    if path == "sonify":
        assert threads["vaudio.step"] == {main}
    elif path == "stream":
        producer = threads["vaudio.stream.dispatch"]
        assert len(producer) == 1 and main not in producer
        assert threads["vaudio.stream.source"] == producer
        drain = threads["vaudio.stream.flush"]
        assert len(drain) == 1 and not drain & (producer | {main})
    else:
        # Each tick flushes the previous one, on the producer (the last
        # in the tick that finds every source exhausted).
        producer = threads["vaudio.pod.tick"]
        assert len(producer) == 1 and main not in producer
        assert threads["vaudio.pod.flush"] == producer


@pytest.mark.parametrize("path", ["sonify", "stream"])
def test_vision_spans_once_per_frame_stats_call(path, tmp_path,
                                                monkeypatch):
    """Each ``frame_stats`` call (the chunk path's pass A, the frame
    path's vision stage) records one ``vaudio.vision.pool`` and then one
    ``vaudio.vision.stats``, both inside its ``vaudio.step.vision``."""
    from vaudio_torch.runtime import chunked
    from vaudio_torch.vision import features
    calls = []
    frame_stats = features.frame_stats

    def counted(*args, **kwargs):
        calls.append(threading.get_native_id())
        return frame_stats(*args, **kwargs)
    monkeypatch.setattr(features, "frame_stats", counted)
    monkeypatch.setattr(chunked, "frame_stats", counted)
    with _profile() as prof:
        RUNS[path]()
    spans = _spans(prof, tmp_path)
    vision = _named(spans, "vaudio.step.vision")
    assert calls and len(vision) == len(calls)
    pools = _named(spans, "vaudio.vision.pool")
    stats = _named(spans, "vaudio.vision.stats")
    assert len(pools) == len(stats) == len(calls)
    for outer in vision:
        pool, = [s for s in pools if _inside(s, outer)]
        stat, = [s for s in stats if _inside(s, outer)]
        assert pool[3] <= stat[2] + SLACK_US
    assert sorted(s[0] for s in pools) == sorted(calls)


@pytest.mark.parametrize("path", sorted(RUNS))
def test_pcm_is_the_same_traced_and_untraced(path):
    untraced = RUNS[path]()
    with _profile():
        traced = RUNS[path]()
    assert untraced.shape == traced.shape and np.any(untraced != 0)
    np.testing.assert_array_equal(traced, untraced)


@pytest.mark.parametrize("path", sorted(RUNS))
def test_no_profiler_builds_no_record_function(path, monkeypatch):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("vaudio.step") is span("vaudio.sonify")
    assert np.any(RUNS[path]() != 0)


def test_a_profiler_started_after_the_producer_records_it(tmp_path):
    """The stream's producer thread exists (and waits on its source)
    before the profiler starts; the spans it enters afterwards are
    recorded on that thread."""
    frames = _frames()
    started, release = threading.Event(), threading.Event()

    def source():
        started.set()
        release.wait(TIMEOUT)
        yield from frames

    aur = Auralizer(source=source(), config=CFG, device="cpu")
    aur.start()
    try:
        assert started.wait(TIMEOUT)
        with _profile() as prof:
            release.set()
            t0 = time.monotonic()
            while aur.is_running:
                assert time.monotonic() - t0 < TIMEOUT
                time.sleep(0.005)
        aur._stream.raise_if_failed()
    finally:
        release.set()
        aur.stop()
    spans = _spans(prof, tmp_path)
    dispatches = _named(spans, "vaudio.stream.dispatch")
    assert len(dispatches) == len(frames)
    assert {s[0] for s in dispatches} != {threading.get_native_id()}


@pytest.mark.parametrize("case", ["params from the host",
                                  "params already tensors",
                                  "frames already on the device"])
def test_ingest_spans_only_where_a_copy_is_made(case, tmp_path):
    from vaudio_torch.runtime.ingest import check_frames, to_device
    host = LiveParams().as_arrays()
    with _profile() as prof:
        if case == "params from the host":
            params_to_device(host, CFG, "cpu")
        elif case == "params already tensors":
            params_to_device({k: torch.as_tensor(v) for k, v in host.items()},
                             CFG, "cpu")
        else:
            to_device(check_frames(_frames(2)), "cpu")
    names = [s[1] for s in _spans(prof, tmp_path)]
    want = ["vaudio.ingest.params"] if case == "params from the host" else []
    assert names == want


def test_the_cli_trace_carries_the_spans(tmp_path):
    """``trace_context`` (the CLI's ``--trace DIR``) writes the spans."""
    with trace_context(str(tmp_path / "trace"), device="cpu"):
        run_sonify()
    path, = (tmp_path / "trace").glob("*.pt.trace.json")
    names = {s[1] for s in _spans_in(path)}
    assert {"vaudio.sonify", "vaudio.step", "vaudio.step.dsp"} <= names


def test_every_span_name_is_documented():
    """Each ``span("...")`` in the package names one of ``SPANS``, and
    each of ``SPANS`` is entered somewhere."""
    root = Path(profiling.__file__).resolve().parents[1]
    used = set()
    for path in root.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert used == set(SPANS)
    assert len(SPANS) == len(set(SPANS))
