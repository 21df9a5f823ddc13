"""What the host did beside a run's window, for telling noise apart: the
shares of the machine's CPU time that ``/proc/stat`` gives over the window
(``steal`` is time the hypervisor gave this machine's CPUs to others),
the load average, this process's share of the CPUs, and how a
window's rate or latency moved from quarter to quarter.  It is logged on
standard error only; no metric reads it.
"""

from __future__ import annotations

import os
import resource
import time
from typing import List, Optional, Sequence

import numpy as np

#: The fields of /proc/stat's ``cpu`` line, in order.
_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
           "steal")


def _cpu_ticks() -> Optional[List[int]]:
    try:
        with open("/proc/stat") as fh:
            line = fh.readline().split()
        return [int(x) for x in line[1:1 + len(_FIELDS)]]
    except (OSError, ValueError):
        return None


class HostLoad:
    """Readings at a window's start; :meth:`summary` at its close."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.ticks = _cpu_ticks()
        self.usage = resource.getrusage(resource.RUSAGE_SELF)

    def summary(self) -> str:
        wall = max(time.perf_counter() - self.t0, 1e-9)
        usage = resource.getrusage(resource.RUSAGE_SELF)
        cpu = (usage.ru_utime - self.usage.ru_utime
               + usage.ru_stime - self.usage.ru_stime)
        cpus = len(os.sched_getaffinity(0))
        parts = [f"this process {100 * cpu / (wall * cpus):.1f}% of "
                 f"{cpus} CPUs"]
        ticks = _cpu_ticks()
        d = ([b - a for a, b in zip(self.ticks, ticks)]
             if ticks is not None and self.ticks is not None else [])
        total = sum(d)
        if total > 0:           # a sandbox may show no ticks at all
            share = dict(zip(_FIELDS, (100 * x / total for x in d)))
            parts.append(f"machine busy {100 - share['idle']:.1f}% "
                         f"(steal {share['steal']:.2f}%, iowait "
                         f"{share['iowait']:.2f}%)")
        try:
            parts.append("load %.2f %.2f %.2f" % os.getloadavg())
        except OSError:
            pass
        return "host over the window: " + "; ".join(parts)


def quarters(stamps: Sequence[float], t0: float, t1: float,
             counts: Optional[Sequence[float]] = None) -> str:
    """Events (``counts`` each, else 1) a second in each quarter of the
    window [t0, t1], by their time stamps."""
    stamps = np.asarray(stamps, np.float64)
    counts = (np.ones_like(stamps) if counts is None
              else np.asarray(counts, np.float64))
    edges = np.linspace(t0, t1, 5)
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        inside = (stamps > a) & (stamps <= b)
        out.append(f"{counts[inside].sum() / max(b - a, 1e-9):.1f}")
    return " ".join(out)


def latency_quarters(lat_ms: np.ndarray) -> str:
    """p50/p95 of each quarter of a run of latencies in order."""
    out = []
    for part in np.array_split(np.asarray(lat_ms, np.float64), 4):
        if len(part):
            out.append(f"{np.percentile(part, 50):.3f}/"
                       f"{np.percentile(part, 95):.3f}")
    return " ".join(out)
