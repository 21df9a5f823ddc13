"""Profiling and tracing — the port's copy of :mod:`vaudio.utils.profiling`:
a host-side frame timer with percentile summaries (the reference's latency
probe, SoundEngine.swift:430-434,477-484), and a thin wrapper over
``torch.profiler`` for device-level traces.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


@contextlib.contextmanager
def trace_context(log_dir: Optional[str] = None, device=None):
    """Capture a ``torch.profiler`` trace around a code block into
    ``log_dir``: CPU activity of every thread (the stream's and the pod's
    work runs on their producer threads; where the installed torch cannot
    record other threads, the calling thread's), plus CUDA activity when
    ``device`` is a card (``None``: when one is present).  The trace is a
    ``<host>_<pid>.<time>.pt.trace.json`` file in the Chrome trace format,
    which TensorBoard and Perfetto open.

    Usage::

        with trace_context("/tmp/vaudio-trace"):
            step(carry, frame, params)
    """
    if log_dir is None:
        yield
        return
    import torch
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
