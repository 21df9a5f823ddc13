"""The general traffic generator: it drives the entry point that a traffic
file names, with the parameters that file gives.

* ``"sonify"`` (closed loop): ``Auralizer.sonify`` on one clip after
  another, contiguous slices of a pool of distinct frames.
* ``"stream"`` (open loop, one camera): ``Auralizer.start`` on a source
  that offers frame ``i`` no earlier than ``t0 + i / fps``; a consumer
  thread pulls every hop from the ring as soon as it is readable.
* ``"pod"`` (closed loop, S cameras): ``MultiStreamAuralizer`` started on
  S sources that cycle one pool from offsets of their own, as fast as the
  pod takes frames; a consumer pulls every slot.

Each driver warms up the shapes its traffic uses, then measures for the
window, optionally traces a steady sub-window, and returns what the
window produced for the judge: every stream's (or clip's) PCM with the
pool index of each of its frames.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from vbench.frames import FramePool
from vbench.trace import Trace, Tracer

#: Seconds a poll of an empty ring sleeps.
POLL_S = 0.0005
#: Seconds past the window a due answer may still come.
LATE_S = 60.0


@dataclasses.dataclass
class Cell:
    """One run of one cell: its configuration and traffic files, the seed,
    the window's length, whether to trace, and the device."""

    name: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    process_start: Optional[float] = None      # time.time() at start

    @property
    def height(self) -> int:
        return int(self.config["frame"]["height"])

    @property
    def width(self) -> int:
        return int(self.config["frame"]["width"])

    def rng(self, stream: int) -> np.random.Generator:
        """The seed's generator for one purpose (pool picks are stream 0)."""
        return np.random.default_rng([self.seed, stream])


@dataclasses.dataclass
class Judged:
    """One stream or clip as the program produced it."""

    key: str
    pool_index: np.ndarray          # pool index of each frame, in order
    pcm: np.ndarray                 # f32[n, hop, channels]


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    measures: Dict[str, float]
    judged: List[Judged]
    trace: Optional[Trace] = None
    missing: List[str] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0


def log(msg: str) -> None:
    print(f"vbench: {msg}", file=sys.stderr, flush=True)


def program_config(config: Dict):
    """The program's configuration and live parameters of a configuration
    file: every semantic field the file fixes; the kernel switches at the
    program's defaults."""
    from vaudio_torch.config import AuralizerConfig, LiveParams
    return (AuralizerConfig(**config["auralizer"]),
            LiveParams(**config["live_params"]))


def make_pool(cell: Cell, frames: int) -> FramePool:
    a = cell.config["auralizer"]
    return FramePool(cell.seed, frames, cell.height, cell.width,
                     int(a["mip_level"]), int(a["grid_size"]),
                     int(a["num_hue_bins"]), cell.device)


def pool_frames(cell: Cell) -> int:
    """The pool's frames: the traffic's count, cut to its byte cap."""
    t = cell.traffic
    n = int(t["pool_frames"])
    cap = t.get("pool_max_bytes")
    if cap is not None:
        n = max(1, min(n, int(cap) // (cell.height * cell.width * 3)))
    return n


def _memory_reset(cell: Cell) -> None:
    if cell.device == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()


def _memory_peak(cell: Cell) -> int:
    if cell.device == "cuda":
        import torch
        return int(torch.cuda.max_memory_allocated())
    return 0


def _setup_s(cell: Cell) -> float:
    return time.time() - (cell.process_start or time.time())


def clip_lengths(traffic: Dict) -> List[int]:
    """The clip lengths every seed uses, in its own order: ``n`` lengths
    spread evenly over the range, none a multiple of ``ragged_of`` so
    that every clip ends in a ragged chunk."""
    lo, hi = traffic["clip_frames"]
    n = int(traffic["clip_lengths"])
    ragged = int(traffic["ragged_of"])
    out = []
    for k in range(n):
        length = int(lo + (hi - lo) * (k + 0.5) / n)
        out.append(length + 1 if length % ragged == 0 else length)
    return out


def clip_schedule(cell: Cell, pool: int):
    """(length, first pool index) of clip after clip: each pass over the
    lengths in an order drawn from the seed, starts drawn from the seed."""
    rng = cell.rng(1)
    lengths = clip_lengths(cell.traffic)
    while True:
        for k in rng.permutation(len(lengths)):
            length = lengths[k]
            yield length, int(rng.integers(0, pool - length + 1))


def drive_sonify(cell: Cell, pool: FramePool, host: np.ndarray) -> Outcome:
    from vaudio_torch.api import Auralizer
    cfg, params = program_config(cell.config)
    aur = Auralizer(config=cfg, params=params, device=cell.device)
    t = cell.traffic
    _memory_reset(cell)
    ragged = int(t["ragged_of"])
    t0 = time.perf_counter()
    for r in sorted({n % ragged for n in clip_lengths(t)}):
        aur.sonify(host[:ragged + r])
    log(f"warm-up {time.perf_counter() - t0:.2f} s")
    tracer = _tracer(cell)
    schedule = clip_schedule(cell, pool.n)
    clips: List[Judged] = []
    missing: List[str] = []
    attempted = failed = 0
    traced_frames, trace_t0 = 0, None
    setup_s = _setup_s(cell)
    t_start = time.perf_counter()
    t_end = t_start
    while time.perf_counter() - t_start < cell.seconds:
        length, first = next(schedule)
        if (tracer is not None and tracer.wanted and trace_t0 is None
                and time.perf_counter() - t_start
                >= t["trace_at"] * cell.seconds):
            tracer.start()
            trace_t0, traced_frames = time.perf_counter(), 0
        attempted += length
        key = f"clip {len(clips) + len(missing)} ({length} frames)"
        try:
            pcm = aur.sonify(host[first:first + length])
        except Exception as e:      # a clip that errors is a failure
            failed += length
            missing.append(f"{key}: {type(e).__name__}: {e}")
            pcm = None
        t_end = time.perf_counter()
        if pcm is not None:
            clips.append(Judged(key, np.arange(first, first + length),
                                pcm.reshape(length, cfg.hop_size, -1)))
        if trace_t0 is not None:
            traced_frames += length
            if t_end - trace_t0 >= t["trace_seconds"]:
                tracer.stop(traced_frames)
                trace_t0 = None
    if trace_t0 is not None:
        tracer.stop(traced_frames)
    memory = _memory_peak(cell)
    del aur
    done = sum(len(c.pool_index) for c in clips)
    return Outcome(attempted, failed,
                   {"frames_per_s": done / (t_end - t_start),
                    "setup_s": setup_s}, clips, _traced(tracer), missing,
                   memory)


def _tracer(cell: Cell) -> Optional[Tracer]:
    """The run's tracer, its first start paid in set-up (None untraced)."""
    if not cell.trace:
        return None
    tracer = Tracer(cell.config["auralizer"], cell.height, cell.width, log)
    tracer.warm()
    return tracer


def _trace_paced(tracer: Tracer, traffic: Dict, at: float, end: float,
                 offered: Callable[[], int]) -> None:
    """Trace sub-windows of a run whose frames flow on threads of their
    own, from ``at`` until one is complete or none fits before ``end``;
    ``offered()`` counts the frames offered so far."""
    _sleep_until(at)
    length = traffic["trace_settle_s"] + traffic["trace_seconds"]
    while tracer.wanted and time.perf_counter() + length <= end:
        tracer.start(traffic["trace_settle_s"])
        first = offered()
        _sleep_until(time.perf_counter() + traffic["trace_seconds"])
        tracer.stop(offered() - first)


def _traced(tracer: Optional[Tracer]) -> Optional[Trace]:
    if tracer is None:
        return None
    if tracer.trace is not None and not tracer.trace.complete:
        log(f"no complete trace in {tracer.attempts} sub-windows: the "
            "last one's device metrics miss kernels")
    return tracer.trace


class _Consumer(threading.Thread):
    """Pulls whole hops from rings as soon as they are readable (a pull of
    an empty ring returns silence, all zeros) and stamps each."""

    def __init__(self, pull: Callable[[int, int], np.ndarray], slots: int,
                 hop: int, channels: int, done: Callable[[], bool]):
        super().__init__(daemon=True)
        self.pull, self.slots = pull, slots
        self.hop, self.channels = hop, channels
        self.done = done
        self.hops: List[List[np.ndarray]] = [[] for _ in range(slots)]
        self.times: List[List[float]] = [[] for _ in range(slots)]
        self.stop = threading.Event()

    def run(self) -> None:
        n = self.hop * self.channels
        ending = False
        while not self.stop.is_set():
            got = False
            for s in range(self.slots):
                block = self.pull(s, n)
                if block.any():
                    self.times[s].append(time.perf_counter())
                    self.hops[s].append(block.reshape(self.hop,
                                                      self.channels))
                    got = True
            if not got:
                if ending:
                    return
                # One more pass once the producer is done: it may have
                # written its last hops since this pass read the rings.
                ending = self.done()
                time.sleep(POLL_S)

    def count(self) -> int:
        return sum(len(h) for h in self.hops)


def drive_stream(cell: Cell, pool: FramePool, host: np.ndarray) -> Outcome:
    from vaudio_torch.api import Auralizer
    cfg, params = program_config(cell.config)
    t = cell.traffic
    fps = float(t["fps"])
    n_warm = int(t["warmup_frames"])
    n_win = int(round(cell.seconds * fps))
    total = n_warm + n_win
    aur = Auralizer(config=cfg, params=params, realtime=False,
                    device=cell.device)
    due = np.full(total, np.nan)
    warm_done = threading.Event()
    clock = {"t0": None, "yielded": 0}

    def source():
        for k in range(n_warm):
            clock["yielded"] += 1
            yield host[k % pool.n]
        warm_done.wait(LATE_S)
        t0 = clock["t0"] = time.perf_counter() + t["lead_s"]
        for i in range(n_win):
            k = n_warm + i
            due[k] = t0 + i / fps
            delay = due[k] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            clock["yielded"] += 1
            yield host[k % pool.n]

    consumer = _Consumer(lambda _s, n: aur.pull(n), 1, cfg.hop_size,
                         cfg.channels,
                         lambda: (consumer.count() >= total
                                  or aur.failure is not None))
    tracer = _tracer(cell)
    _memory_reset(cell)
    aur.start(source())
    consumer.start()
    try:
        while not warm_done.is_set():
            if consumer.count() >= n_warm:
                warm_done.set()
            elif aur.failure is not None:
                break
            time.sleep(POLL_S)
        while clock["t0"] is None and aur.failure is None:
            time.sleep(POLL_S)
        t0 = clock["t0"] or time.perf_counter()
        setup_s = _setup_s(cell) + (t0 - time.perf_counter())
        if tracer is not None:
            _trace_paced(tracer, t, t0 + t["trace_at"] * cell.seconds,
                         t0 + cell.seconds, lambda: clock["yielded"])
        deadline = t0 + cell.seconds + LATE_S
        while (consumer.count() < total and time.perf_counter() < deadline
               and aur.failure is None):
            time.sleep(0.01)
    finally:
        consumer.stop.set()
        consumer.join(10.0)
    memory = _memory_peak(cell)
    dropped = int(aur.metrics["dropped_frames"])
    error = aur.failure
    aur.stop()
    hops, times = consumer.hops[0], consumer.times[0]
    got = len(hops)
    lat = np.asarray(times[n_warm:total]) - due[n_warm:n_warm + max(
        0, got - n_warm)]
    lat_ms = lat * 1e3
    missing = []
    if error is not None:
        missing.append(f"stream failed: {type(error).__name__}: {error}")
    if dropped:
        missing.append(f"{dropped} frames dropped at the ring")
    if got < total:
        missing.append(f"{total - got} of {total} hops never came")
    measures = {"setup_s": setup_s}
    if len(lat_ms):
        measures["latency_p50_ms"] = float(np.percentile(lat_ms, 50))
        measures["latency_p95_ms"] = float(np.percentile(lat_ms, 95))
    judged = [Judged("stream", np.arange(got) % pool.n,
                     np.stack(hops) if hops else np.zeros((0,)))]
    return Outcome(n_win, max(0, total - got) + dropped, measures, judged,
                   _traced(tracer), missing, memory)


def _sleep_until(t: float) -> None:
    delay = t - time.perf_counter()
    if delay > 0:
        time.sleep(delay)


def drive_pod(cell: Cell, pool: FramePool, host: np.ndarray) -> Outcome:
    from vaudio_torch.config import LiveParams
    from vaudio_torch.runtime.engine import AuralizerEngine
    from vaudio_torch.runtime.multistream import MultiStreamAuralizer
    cfg, _params = program_config(cell.config)
    t = cell.traffic
    S = int(t["streams"])
    n_warm = int(t["warmup_frames"])
    offsets = cell.rng(2).choice(pool.n, size=S, replace=False)
    pod = MultiStreamAuralizer(
        cfg, n_streams=S,
        params=[LiveParams(**cell.config["live_params"]) for _ in range(S)],
        realtime=False, engine=AuralizerEngine(cfg, device=cell.device))
    stop = threading.Event()
    yielded = [0] * S

    def source(s: int):
        k = 0
        while not stop.is_set():
            yield host[(offsets[s] + k) % pool.n]
            k += 1
            yielded[s] = k

    consumer = _Consumer(pod.pull, S, cfg.hop_size, cfg.channels,
                         lambda: not pod.is_running)
    tracer = _tracer(cell)
    _memory_reset(cell)
    pod.start([source(s) for s in range(S)])
    consumer.start()
    try:
        while (min(len(h) for h in consumer.hops) < n_warm
               and pod.is_running):
            time.sleep(POLL_S)
        t_start = time.perf_counter()
        setup_s = _setup_s(cell)
        offered0 = sum(yielded)
        if tracer is not None and pod.is_running:
            _trace_paced(tracer, t, t_start + t["trace_at"] * cell.seconds,
                         t_start + cell.seconds, lambda: sum(yielded))
        t_end = t_start + cell.seconds
        _sleep_until(t_end)
        offered = sum(yielded) - offered0
        stop.set()
        deadline = time.perf_counter() + LATE_S
        while pod.is_running and time.perf_counter() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        consumer.join(LATE_S)
        consumer.stop.set()
        consumer.join(10.0)
    memory = _memory_peak(cell)
    dropped = sum(int(pod.stream_metrics(s)["dropped_frames"])
                  for s in range(S))
    errors = [e for e in pod.slot_errors if e is not None]
    try:
        pod.raise_if_failed()
    except RuntimeError as e:
        errors.append(e.__cause__ or e)
    pod.stop()
    done = sum(1 for s in range(S) for x in consumer.times[s]
               if t_start < x <= t_end)
    missing = [f"slot failed: {type(e).__name__}: {e}" for e in errors]
    if dropped:
        missing.append(f"{dropped} frames dropped at the rings")
    judged = [Judged(f"slot {s}",
                     (offsets[s] + np.arange(len(consumer.hops[s])))
                     % pool.n, np.stack(consumer.hops[s]))
              for s in range(S) if consumer.hops[s]]
    return Outcome(offered, dropped + len(errors),
                   {"frames_per_s": done / cell.seconds,
                    "setup_s": setup_s}, judged, _traced(tracer), missing,
                   memory)


DRIVERS = {"sonify": drive_sonify, "stream": drive_stream, "pod": drive_pod}

