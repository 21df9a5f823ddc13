"""The traced sub-window: ``torch.profiler`` over a few steady seconds of a
run, and the device and host events read back from its trace.

The profiler records CPU activity of every thread (the program's producer
threads dispatch the device work; where the installed torch cannot record
other threads, the calling thread's) and CUDA activity.  The trace is
written to a temporary file, read at once and deleted.  Now and then the
profiler records a window's copies but none of its kernels; such a trace
is not complete (launches on the host with no device record), and the run
traces another sub-window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

#: Device activity categories of a chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Host categories an idle gap can be laid to.
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "vbench.window"
#: What an idle gap is laid to when the launching thread runs no recorded
#: operation then (Python between operations, or waiting for the GIL).
IDLE_HOST = "(no operation on the launching thread)"
#: Operation names are cut to this many characters in the breakdown.
NAME_CHARS = 160
#: The largest share of a window's kernel launches that may lack a device
#: record in a complete trace.
LOST_SHARE = 0.1
#: Sub-windows a run traces at most, while none is complete.
ATTEMPTS = 3


@dataclasses.dataclass
class Trace:
    """Device and host events of one traced window (times in seconds,
    relative to the window's start), with what the readers need besides:
    the frames the window carried and the cell's configuration."""

    window_s: float
    device: List[Tuple[str, str, float, float]]   # (cat, name, start, dur)
    host: List[Tuple[int, str, str, float, float]]  # (tid, cat, name, ...)
    frames: int
    auralizer: Dict
    height: int
    width: int
    #: Kernel launches the host made in the window, and how many of them
    #: have no kernel record on the device.
    launches: int = 0
    lost: int = 0

    @property
    def complete(self) -> bool:
        return self.lost <= LOST_SHARE * self.launches

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the window."""
        spans = sorted((max(0.0, s), min(self.window_s, s + d))
                       for _c, _n, s, d in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of every stretch of the window with no device
        activity."""
        gaps, t = [], 0.0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a - t))
            t = b
        if self.window_s > t:
            gaps.append((t, self.window_s - t))
        return gaps

    def device_seconds(self, cat: str, contains: str = "") -> float:
        return sum(d for c, n, _s, d in self.device
                   if c == cat and contains in n)

    def device_count(self) -> int:
        return len(self.device)

    def launcher(self) -> Optional[int]:
        """The host thread that launched the most device work."""
        counts: Dict[int, int] = {}
        for tid, cat, name, _s, _d in self.host:
            if cat == "cuda_runtime" and ("Launch" in name
                                          or "Memcpy" in name):
                counts[tid] = counts.get(tid, 0) + 1
        return max(counts, key=counts.get) if counts else None

    def host_at(self, tid, times: List[float]) -> List[str]:
        """For each of ``times`` (ascending), the innermost host event on
        thread ``tid`` running then: one sweep over the thread's events,
        which nest, with a stack of the open ones."""
        events = sorted((s, s + d, name) for htid, _c, name, s, d
                        in self.host if htid == tid and name != WINDOW)
        names, stack, k = [], [], 0
        for t in times:
            while k < len(events) and events[k][0] <= t:
                while stack and stack[-1][1] < events[k][0]:
                    stack.pop()
                stack.append(events[k])
                k += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            names.append(stack[-1][2] if stack else IDLE_HOST)
        return names

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        laid to what the launching thread was doing in each gap's
        middle."""
        ops: Dict[str, float] = {}
        for _c, name, _s, d in self.device:
            name = name[:NAME_CHARS]
            ops[name] = ops.get(name, 0.0) + d
        gaps = self.idle_gaps()
        names = self.host_at(self.launcher(),
                             [start + length / 2 for start, length in gaps])
        idle: Dict[str, float] = {}
        for (_start, length), name in zip(gaps, names):
            name = name[:NAME_CHARS]
            idle[name] = idle.get(name, 0.0) + length
        rank = (lambda d: sorted(([k, v] for k, v in d.items()),
                                 key=lambda kv: -kv[1])[:top])
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def read_chrome_trace(path: str, frames: int, auralizer: Dict, height: int,
                      width: int) -> Trace:
    """A :class:`Trace` from a chrome trace whose window is the user
    annotation :data:`WINDOW`."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no window annotation")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    device, host, launched = [], [], []
    ran = {e.get("args", {}).get("correlation") for e in spans
           if e.get("cat") == "kernel"}
    for e in spans:
        ts, dur = float(e["ts"]), float(e["dur"])
        if ts + dur < t0 or ts > t1:
            continue
        cat = e.get("cat", "")
        rel = ((ts - t0) * 1e-6, dur * 1e-6)
        if cat in DEVICE_CATS:
            device.append((cat, e.get("name", ""), *rel))
        elif cat in HOST_CATS:
            host.append((e.get("tid"), cat, e.get("name", ""), *rel))
            if cat == "cuda_runtime" and "LaunchKernel" in e.get("name",
                                                                 ""):
                launched.append(e.get("args", {}).get("correlation"))
    return Trace(window_s=(t1 - t0) * 1e-6, device=device, host=host,
                 frames=frames, auralizer=auralizer, height=height,
                 width=width, launches=len(launched),
                 lost=sum(1 for c in launched if c not in ran))


class Tracer:
    """Starts and stops ``torch.profiler`` around sub-windows of a run and
    keeps the last one read, until one is complete."""

    def __init__(self, auralizer: Dict, height: int, width: int, log=None):
        self._shape = (auralizer, height, width)
        self._log = log
        self._prof = None
        self._mark = None
        self.trace: Optional[Trace] = None
        self.attempts = 0

    @property
    def wanted(self) -> bool:
        """Whether to trace (another) sub-window."""
        return ((self.trace is None or not self.trace.complete)
                and self.attempts < ATTEMPTS)

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile
        try:
            from torch._C._profiler import _ExperimentalConfig
            config = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            config = None
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       experimental_config=config)

    def warm(self) -> None:
        """Trace one device operation, so that the profiler's own first
        start is paid in set-up."""
        import torch
        with self._profile():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self, settle_s: float = 0.0) -> None:
        """Start the profiler and, ``settle_s`` later, the window: where the
        program runs on threads of its own, starting the profiler can hold
        them for a moment, and the frames that fell due meanwhile are
        caught up before the window opens."""
        import time

        import torch
        self.attempts += 1
        self._prof = self._profile()
        self._prof.__enter__()
        time.sleep(settle_s)
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self, frames: int) -> None:
        """Close the window and read its trace (writing it out holds the
        interpreter for a few seconds)."""
        import time

        import torch
        self._mark.__exit__(None, None, None)
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self._prof = self._mark = None
            self.trace = read_chrome_trace(path, frames, *self._shape)
        finally:
            os.unlink(path)
        if self._log is not None:
            tr = self.trace
            self._log(f"trace {self.attempts} read in "
                      f"{time.perf_counter() - t0:.1f} s: "
                      f"{len(tr.device)} device and {len(tr.host)} host "
                      f"events; {tr.lost} of {tr.launches} kernel "
                      "launches without a device record")
