"""Profiling and tracing — the port's copy of :mod:`vaudio.utils.profiling`:
a host-side frame timer with percentile summaries (the reference's latency
probe, SoundEngine.swift:430-434,477-484), a thin wrapper over
``torch.profiler`` for device-level traces, and the program's own spans
(:func:`span`, named in :data:`SPANS`), which any ``torch.profiler`` run
records on its clock beside the device's activity.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

#: The program's spans, each a ``user_annotation`` range of the chrome
#: trace on the thread that ran it, nested in its caller's:
#:
#: * ``vaudio.sonify``: one offline ``Auralizer.sonify`` call.
#: * ``vaudio.ingest.frames``: a host-to-device copy of frames (the
#:   offline chunk's, the stream's frame or chunk, the pod's tick), all in
#:   ``runtime.ingest``; a pageable copy holds the host for its length.
#: * ``vaudio.ingest.stage``: one fill thread's share of an offline slice's
#:   copy into the page-locked ring (``runtime.ingest``); the dispatching
#:   thread waits for the ring inside ``vaudio.ingest.frames``.
#: * ``vaudio.ingest.params``: a dispatch's copies of the live parameters.
#: * ``vaudio.step``: one frame, chunk or pod tick through the runtime
#:   step, with any engine (ingest of its parameters inside).
#: * ``vaudio.step.vision``, ``vaudio.step.synth``, ``vaudio.step.dsp``:
#:   the flagship step's three stages (``frame_step``; ``chunk_pipeline``'s
#:   pass A, passes B and C1, pass C2).  A graphed step
#:   (``runtime.step.GraphedStep``) runs them only where it captures.
#: * ``vaudio.step.replay``: a graphed step's replay: the copies of its
#:   inputs into the graph's buffers, the graph's launch and the copies of
#:   its outputs.
#: * ``vaudio.vision.pool``: the mip pool of one ``frame_stats`` call
#:   (kernel K1 on the card), inside ``vaudio.step.vision``.
#: * ``vaudio.vision.stats``: what follows it in that call: K3 where the
#:   switch and its size gate take the mip, else the unfused stages (HSI,
#:   the tiled histogram, the stencils, the statistics).
#: * ``vaudio.readback``: waiting for the device and copying PCM back.
#: * ``vaudio.stream.source``: the live producer waiting for its source.
#: * ``vaudio.stream.dispatch``: one host dispatch of a frame or chunk.
#: * ``vaudio.stream.enqueue``: handing the result to the drain thread
#:   (blocks while ``pipeline_depth`` results await their readback).
#: * ``vaudio.stream.flush``: the drain thread's readback and ring writes
#:   of one result.
#: * ``vaudio.pod.tick``: one pod tick, from pulling the sources to the end
#:   of the dispatch that flushes the previous tick.
#: * ``vaudio.pod.sources``: pulling one frame from every slot's source.
#: * ``vaudio.pod.stack``: the host copy of a tick's (or chunk's) frames
#:   into one array.
#: * ``vaudio.pod.flush``: readback and ring writes of the previous tick.
SPANS = ("vaudio.sonify", "vaudio.ingest.frames", "vaudio.ingest.stage",
         "vaudio.ingest.params",
         "vaudio.step", "vaudio.step.vision", "vaudio.step.synth",
         "vaudio.step.dsp", "vaudio.step.replay", "vaudio.vision.pool",
         "vaudio.vision.stats",
         "vaudio.readback", "vaudio.stream.source",
         "vaudio.stream.dispatch", "vaudio.stream.enqueue",
         "vaudio.stream.flush", "vaudio.pod.tick", "vaudio.pod.sources",
         "vaudio.pod.stack", "vaudio.pod.flush")

# Entered whenever no profiler runs: one shared object, nothing allocated.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range of the running
    ``torch.profiler`` trace, on the calling thread; with no profiler
    running, a shared no-op that enters no torch op.

    The guard is the profiler's process-wide flag, read at every call
    (``torch._C._autograd._profiler_enabled()`` is per thread, and reads
    False on the stream's and the pod's producer threads even while a
    profiler records every thread)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None, device=None):
    """Capture a ``torch.profiler`` trace around a code block into
    ``log_dir``: CPU activity of every thread (the stream's and the pod's
    work runs on their producer threads; where the installed torch cannot
    record other threads, the calling thread's), plus CUDA activity when
    ``device`` is a card (``None``: when one is present).  The trace is a
    ``<host>_<pid>.<time>.pt.trace.json`` file in the Chrome trace format,
    which TensorBoard and Perfetto open.  It carries the program's own
    ``vaudio.*`` spans (:data:`SPANS`) on the threads that ran them, so a
    stream's or a pod's host time reads by layer beside the card's work.

    Usage::

        with trace_context("/tmp/vaudio-trace"):
            step(carry, frame, params)
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    try:
        from torch._C._profiler import _ExperimentalConfig
        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        config = None
    with profile(activities=activities, experimental_config=config,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if cuda:
            torch.cuda.synchronize()


def trace_kernel_counts(log_dir: str, names: Sequence[str]) -> Dict[str, int]:
    """The device kernels in the newest trace that :func:`trace_context`
    wrote to ``log_dir``: for each of ``names``, how many kernel events
    have a name containing it (e.g. ``"mip_pool"``, ``"hann_peak"``,
    ``"agc_overlap_add"``, the CUDA kernels of ``vaudio_torch/csrc``)."""
    path = max(Path(log_dir).glob("*.pt.trace.json"),
               key=lambda p: p.stat().st_mtime)
    kernels = [e.get("name", "") for e in
               json.loads(path.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}


class FrameTimer:
    """Per-frame host-time probe with rolling percentile stats."""

    def __init__(self, capacity: int = 4096):
        self._samples_ms: list[float] = []
        self._capacity = capacity
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        self._t0 = None
        self._samples_ms.append(dt_ms)
        if len(self._samples_ms) > self._capacity:
            del self._samples_ms[:self._capacity // 2]
        return dt_ms

    @contextlib.contextmanager
    def frame(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self._samples_ms:
            return {"count": 0}
        a = np.asarray(self._samples_ms)
        return {
            "count": len(a),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }
