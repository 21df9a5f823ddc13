"""The program's own spans in a traced window: the ``vaudio.*`` ranges that
``vaudio_torch`` records on each thread while a profiler runs
(``user_annotation`` host events of a :class:`vbench.trace.Trace`), read
as host time.

A name ending in ``.`` stands for every span under it
(``vaudio.ingest.`` is the frames' and the parameters' copies).  Time in
spans is the union of their intervals on each thread, clipped to the
window, so a span nested in or repeating one of its own name never counts
twice.  Every reader returns None where the trace holds no span of its
name (a program that records none).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

INGEST = "vaudio.ingest."
STEP = "vaudio.step"
READBACK = "vaudio.readback"
TICK = "vaudio.pod.tick"
STACK = "vaudio.pod.stack"

Intervals = List[Tuple[float, float]]


def _matches(name: str, want: str) -> bool:
    return name.startswith(want) if want.endswith(".") else name == want


def spans(trace, want: str) -> List[Tuple[int, float, float]]:
    """(thread, start, end) of every span ``want`` names, unclipped
    (seconds from the window's start)."""
    return [(tid, s, s + d) for tid, cat, name, s, d in trace.host
            if cat == "user_annotation" and _matches(name, want)]


def union(intervals, lo: float, hi: float) -> Intervals:
    """The union of ``intervals``, clipped to [lo, hi], merged and sorted."""
    merged: List[List[float]] = []
    for a, b in sorted((max(lo, a), min(hi, b)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def length(intervals: Intervals) -> float:
    return sum(b - a for a, b in intervals)


def overlap(x: Intervals, y: Intervals) -> float:
    """The length of the intersection of two merged, sorted lists."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def by_thread(trace, want: str) -> Optional[Dict[int, Intervals]]:
    """Per thread, the union of the spans ``want`` names within the window;
    None where the trace holds none."""
    found = spans(trace, want)
    if not found:
        return None
    out: Dict[int, list] = {}
    for tid, a, b in found:
        out.setdefault(tid, []).append((a, b))
    return {tid: union(iv, 0.0, trace.window_s) for tid, iv in out.items()}


def launcher_seconds(trace, want: str) -> Optional[float]:
    """Seconds in the spans ``want`` names on the thread that launched
    the most device work."""
    threads = by_thread(trace, want)
    if threads is None:
        return None
    return length(threads.get(trace.launcher(), []))


def step_seconds(trace) -> Optional[float]:
    """Seconds in ``vaudio.step`` on the launching thread, less the part
    its copies of frames and parameters (``vaudio.ingest.*``) cover."""
    steps = by_thread(trace, STEP)
    if steps is None:
        return None
    tid = trace.launcher()
    step = steps.get(tid, [])
    ingest = (by_thread(trace, INGEST) or {}).get(tid, [])
    return length(step) - overlap(step, ingest)


def all_threads_seconds(trace, want: str) -> Optional[float]:
    """Seconds in the spans ``want`` names, summed over the threads."""
    threads = by_thread(trace, want)
    if threads is None:
        return None
    return sum(length(iv) for iv in threads.values())


def per_frame_ms(trace, seconds: Optional[float]) -> Optional[float]:
    if seconds is None or trace.frames <= 0:
        return None
    return 1e3 * seconds / trace.frames


def ticks_started(trace) -> List[Tuple[int, float, float]]:
    """The pod ticks that started in the window."""
    return [t for t in spans(trace, TICK) if 0.0 <= t[1] < trace.window_s]

