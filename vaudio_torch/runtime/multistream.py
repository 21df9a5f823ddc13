"""The multi-stream serving pod: N concurrent video streams through ONE
batched device step per tick — the PyTorch port of
:mod:`vaudio.runtime.multistream`.

* N frame sources advance in lockstep, one frame per stream per tick (or
  ``chunk_frames`` per stream through the chunk-batched pipeline — the
  throughput configuration);
* ONE step per tick for all streams: the engine's stream-batched step
  (``engine.raw_step`` / ``raw_chunk_step``).  Where the JAX package
  ``vmap``s a one-stream step, the port writes the stream axis out: the
  stateless per-frame stages fold the S·T frames of a tick into one frame
  axis, the serial recurrences keep S as a batch axis, and the audio
  tail's kernel K4 runs one cluster a stream, so every kernel on the path
  launches once a tick whatever S is.  The tick's frames are stacked into
  one reused host staging buffer (page-locked when the engine runs on
  CUDA) and go to the device in one host->device copy.  With a ``mesh``
  (:class:`vaudio_torch.parallel.StreamMesh`) the streams are sharded over
  its stream rows, one copy and one batched step a shard (the DP/TP mesh
  steps of :mod:`vaudio_torch.parallel.sharding`);
* per-stream ring buffers keep the reference's real-time sink contract
  (warm-up / zero-fill / drop-on-full, SoundEngine.swift:171-189,448)
  independently per stream;
* per-stream :class:`vaudio_torch.config.LiveParams`: every serving slot
  has its own live control surface (SoundEngine.swift:66-75), stacked on
  the host every dispatch and copied to the device once a key;
* slots whose source ends go dark (they are fed black frames to keep the
  batch shape static — the state evolves exactly as if the camera cut to
  black) and can be re-armed live with :meth:`replace_source`;
* :meth:`MultiStreamAuralizer.serve` puts the pod behind its live HTTP
  panel (:class:`vaudio_torch.runtime.podserver.PodServer`).

All streams in a pod share one resolution and dtype; a mid-stream
resolution change is an error for its slot.  Capacity is elastic:
:meth:`MultiStreamAuralizer.resize` grows or shrinks the slot count live
at a dispatch boundary, the surviving slots' DSP state riding along.  The
pod runs where its engine runs: the card unless the engine was built with
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io.sources import own_frame
from vaudio_torch.runtime.ingest import HostBuffers, host_frames, to_device
from vaudio_torch.runtime.ringbuffer import make_ring_buffer
from vaudio_torch.runtime.step import StepCarry
from vaudio_torch.runtime.stream import StreamMetrics
from vaudio_torch.utils.profiling import span


def _frame_sig(frame):
    if isinstance(frame, dict):
        return {k: (v.shape, v.dtype) for k, v in sorted(frame.items())}
    return (frame.shape, frame.dtype)


def _zeros_like_frame(frame):
    if isinstance(frame, dict):
        return {k: np.zeros_like(v) for k, v in frame.items()}
    return np.zeros_like(frame)


def _is_sharded(x) -> bool:
    from vaudio_torch.parallel.sharding import StreamShards
    return isinstance(x, StreamShards)


def trailing_shrink_target(n_streams: int, free, stop: int = 1,
                           keep=None, mesh_step=None) -> int:
    """The ONE trailing-shrink derivation (pure): smallest slot count >=
    ``stop`` whose trailing slots ``n..n_streams-1`` are all in ``free``
    and not held back by ``keep(i) -> True``, rounded up to ``mesh_step``;
    floor 1.  Shared by the idle check, the apply-time revalidation, and
    ``release_slot(shrink=True)``."""
    n_new = n_streams
    while (n_new > max(1, stop) and (n_new - 1) in free
           and (keep is None or not keep(n_new - 1))):
        n_new -= 1
    if mesh_step is not None:
        n_new = max(mesh_step,
                    ((n_new + mesh_step - 1) // mesh_step) * mesh_step)
    return n_new


def _fresh_rows(carry, n_add: int):
    """Cold-start carry rows for ``n_add`` new slots, shaped like
    ``carry``'s per-slot rows on its device: every field zero except the
    AGC envelope (``running_max``), which cold-starts at 1.0 for both
    families (runtime.step.init_carry, OrthoModesModel.init_carry)."""
    return type(carry)(*[
        (torch.ones if f == "running_max" else torch.zeros)(
            (n_add,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        for f, x in zip(type(carry)._fields, carry)])


class MultiStreamAuralizer:
    """Serve N concurrent video->audio streams from one batched step a tick.

    Args, as the JAX package's:
      cfg: static configuration shared by every stream in the pod.
      n_streams: number of serving slots (the batch shape; elastically
        resizable live — see :meth:`resize`).
      params: live parameters.  ``None`` = an independent
        :class:`LiveParams` per slot (reach them via ``self.params[i]``);
        a single ``LiveParams`` = shared by every slot (mutations affect
        all); a sequence of ``LiveParams`` = explicit per-slot objects.
        Values are re-read and stacked every dispatch.
      realtime: pace ticks at ``cfg.video_fps`` (live serving) or run as
        fast as the device allows (offline/throughput).
      prefer_native: the C++ ring where its library builds.
      chunk_frames: frames per stream per dispatch.  1 = lowest latency
        (the stream-batched frame step per tick); >1 = the chunk-batched
        pipeline (runtime.chunked), at the cost of chunk_frames-1 frame
        times of buffering.
      mesh: optional :class:`vaudio_torch.parallel.StreamMesh` with a
        ``'stream'`` axis (and ``'cell'`` for TP when chunk_frames == 1).
        Streams are sharded over the mesh; ``n_streams`` must be a
        multiple of the stream axis.  Mesh mode requires a single SHARED
        ``params`` object (the parallel steps replicate params; per-slot
        control needs the single-device mode).
      exit_when_exhausted: producer exits once every source has ended
        (True — batch-job semantics) or idles awaiting
        :meth:`replace_source` re-arms until :meth:`stop` (False —
        long-lived serving-pod semantics).
      metrics_log: JSONL path receiving one record per dispatch
        (timestamp, real frames, latency, per-slot fill/drop state).
      engine: the model family (default :class:`runtime.engine
        .AuralizerEngine` on the card); the pod runs on its device.
      max_streams: growth cap for elastic capacity (:meth:`resize`,
        :meth:`acquire_slot`); None = unbounded.
      lease_timeout: dead-client reaping — a PUSH-armed slot silent for
        this many seconds is auto-released (see :attr:`lease_timeout`);
        None = leases never expire.
      idle_shrink: automatic capacity return — trailing slots free for
        this many seconds are shrunk away (see :attr:`idle_shrink`);
        None = capacity only changes explicitly.
    """

    def __init__(self, cfg: AuralizerConfig = AuralizerConfig(),
                 n_streams: int = 2,
                 params: Union[None, LiveParams,
                               Sequence[LiveParams]] = None,
                 realtime: bool = False,
                 prefer_native: bool = True,
                 chunk_frames: int = 1,
                 mesh=None,
                 exit_when_exhausted: bool = True,
                 metrics_log: Optional[str] = None,
                 engine=None,
                 max_streams: Optional[int] = None,
                 lease_timeout: Optional[float] = None,
                 idle_shrink: Optional[float] = None):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if max_streams is not None and max_streams < n_streams:
            raise ValueError(
                f"max_streams {max_streams} < n_streams {n_streams}")
        if engine is None:
            from vaudio_torch.runtime.engine import AuralizerEngine
            engine = AuralizerEngine(cfg)
        elif getattr(engine, "cfg", cfg) is not cfg:
            cfg = engine.cfg        # engine may coerce (mono orthomodes)
        if (mesh is not None and engine.name != "auralizer"
                and mesh.shape.get("cell", 1) != 1):
            raise ValueError(
                "a 'cell' mesh axis > 1 is flagship-specific tensor "
                "parallelism; other families mesh-shard over 'stream' "
                "only (DP) — build the mesh with n_cell=1")
        self.engine = engine
        self.cfg = cfg
        self.n_streams = int(n_streams)
        self.realtime = realtime
        self.chunk_frames = max(1, int(chunk_frames))
        self._mesh = mesh
        self._exit_when_exhausted = exit_when_exhausted

        if params is None:
            self.params: List[LiveParams] = [LiveParams()
                                             for _ in range(n_streams)]
        elif isinstance(params, LiveParams):
            self.params = [params] * n_streams
        else:
            self.params = list(params)
            if len(self.params) != n_streams:
                raise ValueError(
                    f"params sequence length {len(self.params)} != "
                    f"n_streams {n_streams}")
        if mesh is not None:
            if "stream" not in mesh.shape:
                raise ValueError("mesh needs a 'stream' axis")
            if n_streams % mesh.shape["stream"]:
                raise ValueError(
                    f"n_streams {n_streams} not a multiple of the mesh "
                    f"stream axis {mesh.shape['stream']}")
            if len(set(map(id, self.params))) != 1:
                raise ValueError(
                    "mesh mode replicates params across devices and so "
                    "requires one shared LiveParams object; per-slot "
                    "params need the single-device mode (mesh=None)")

        self._step = self._build_step()
        # Frame-sized carries (engine.carry_static False) defer to the
        # first dispatch.
        self._carry = (self._shard_put(
            engine.init_carry_batch(self.n_streams))
            if engine.carry_static else None)
        # False while a frame-sized carry needs first-tick validation
        # (set False by load_state restores).
        self._carry_checked = engine.carry_static
        # Orders the producer's carry swap against cross-thread readers
        # (snapshot_carry, load_state, resize, stop).
        self._carry_lock = threading.Lock()
        #: Taken by the producer while stacking per-slot params for a
        #: dispatch.  Multi-slot updates that must be seen atomically
        #: (e.g. enabling pan_angles on every slot — presence must match
        #: across slots, see _stack_params) take it too.
        self.params_lock = threading.Lock()
        self.rings = [make_ring_buffer(cfg.ring_buffer_frames,
                                       cfg.hop_size * cfg.channels,
                                       cfg.warmup_frames,
                                       prefer_native=prefer_native)
                      for _ in range(self.n_streams)]
        self.metrics = StreamMetrics(self._step)
        self._sources: List = [None] * self.n_streams
        self._active = [False] * self.n_streams
        #: Per-slot source failures (slot isolation: one client's bad
        #: source must not kill the other N-1 slots — the slot goes
        #: dark and the error is surfaced here / in stream_metrics).
        self.slot_errors: List[Optional[BaseException]] = \
            [None] * self.n_streams
        self._source_lock = threading.Lock()
        self._pending_sources: List = []   # (slot, iterator, reset_carry)
        self._prefer_native = prefer_native
        #: Pending elastic resize: (new n_streams, applied Event).
        #: Written by :meth:`resize` under ``_source_lock``; taken by the
        #: producer at a dispatch boundary.
        self._resize_req = None
        #: Growth cap for :meth:`acquire_slot` (None = unbounded).
        self.max_streams = max_streams
        #: Dead-client reaping: a PUSH-armed slot whose client has not
        #: PUSHED a frame for this many seconds — and whose queue is
        #: drained — is auto-released (its push stream closed, the slot
        #: drains dark and becomes free for the next lease).  None =
        #: leases never expire.  Idleness is measured at frame ARRIVAL
        #: (:attr:`vaudio_torch.io.PushSource.last_push`), never
        #: consumption: a dispatch stall must not make a live client look
        #: dead while its frames sit queued.  Pull-source slots are never
        #: reaped; an operator-armed push door (:meth:`arm_push`) is only
        #: reaped once a client has actually pushed a frame.  Leased slots
        #: always count: a client that acquired and died before its first
        #: frame must not hold the lease.
        if lease_timeout is not None and lease_timeout <= 0:
            raise ValueError("lease_timeout must be > 0 seconds")
        self.lease_timeout = lease_timeout
        #: Count of auto-released (reaped) leases, for the metrics surface.
        self.leases_reaped = 0
        if idle_shrink is not None and idle_shrink <= 0:
            raise ValueError("idle_shrink must be > 0 seconds")
        #: Automatic capacity return: when the pod's TRAILING slots have
        #: all been free (:meth:`free_slots`) for this many seconds, the
        #: producer shrinks them away as if ``resize`` had been called
        #: (never below 1 slot).  Inner free holes are NOT shrunk — they
        #: are reused by the next :meth:`acquire_slot`.  None = capacity
        #: only changes on explicit resize/release(shrink).
        self.idle_shrink = idle_shrink
        #: Count of automatic idle shrinks (metrics surface).
        self.auto_shrinks = 0
        self._free_since: Dict[int, float] = {}
        #: Serializes acquire/release so two concurrent acquires never
        #: lease the same slot.
        self._lease_lock = threading.Lock()
        #: Serializes resize() callers: without it a second caller's
        #: request would overwrite the first's under _source_lock and
        #: the first would return as if applied.
        self._resize_serial = threading.Lock()
        #: Per-slot :class:`vaudio_torch.io.PushSource` handles for slots
        #: armed with :meth:`arm_push`; None elsewhere.
        self.push_sources: List = [None] * self.n_streams
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._running = False
        self._error: Optional[BaseException] = None
        self._template_sig = None
        self._zeros = None
        #: The tick's host staging buffer (page-locked for a CUDA engine)
        #: and its counters, ``staging_allocs`` / ``staging_reuses`` in
        #: :meth:`metrics_dict`.
        self._staging = HostBuffers(engine.device)
        self._metrics_log = metrics_log
        self._metrics_fh = None
        #: When True (set by :meth:`serve` / PodServer.start, reset by
        #: PodServer.stop) the producer keeps cheap per-slot
        #: observability state: the last REAL output hop (waveform view)
        #: and a small RGB preview of the last ingested frame (the
        #: CameraPreview surface).  Off by default — the serving hot
        #: path pays nothing for views nobody watches.  Previews are
        #: additionally throttled to :attr:`preview_interval` seconds
        #: per slot (panels poll at ~2 Hz; rendering every frame of an
        #: 8x30fps pod would burn host time on discarded images).
        self.observe = False
        self.preview_interval = 0.25
        self.last_pcm: List[Optional[np.ndarray]] = [None] * n_streams
        self.last_preview: List[Optional[np.ndarray]] = [None] * n_streams
        self._preview_t = [0.0] * n_streams

    # -- step construction --------------------------------------------------

    def _build_step(self):
        """The engine's stream-batched step (flagship: the frame step or
        the chunk pipeline; other families their own), one call a tick for
        every slot; per-stream params ride the leading axis.  Under a
        mesh, the mesh steps of :mod:`vaudio_torch.parallel.sharding`."""
        if self._mesh is not None:
            from vaudio_torch.parallel.sharding import (
                make_engine_parallel_step, make_parallel_chunk_step,
                make_parallel_step)
            if self.engine.name != "auralizer":
                # Model-agnostic DP: the engine's raw step on each shard
                # (no TP — cell-sharded synthesis is flagship structure
                # other families lack).
                return make_engine_parallel_step(
                    self.engine, self._mesh, chunk=self.chunk_frames > 1)
            if self.chunk_frames > 1:
                return make_parallel_chunk_step(self.cfg, self._mesh)
            return make_parallel_step(self.cfg, self._mesh)
        return (self.engine.raw_chunk_step() if self.chunk_frames > 1
                else self.engine.raw_step())

    def _shard_put(self, tree):
        """Place a host or device tree whose leading axis is the slots: on
        the engine's device, or under a mesh sharded over its stream rows
        (a :class:`~vaudio_torch.parallel.sharding.StreamShards`)."""
        from vaudio_torch.parallel.sharding import _tree_map, shard_put
        if self._mesh is None:
            dev = self.engine.device
            return _tree_map(lambda x: torch.as_tensor(x).to(dev), tree)
        return shard_put(self._mesh, tree)

    def _put_frames(self, staged):
        """The tick's staged frames as the step's batch, by a synchronous
        copy that never shares the staging buffer's memory (the next tick
        rewrites it); under a mesh, by :meth:`_put_shards`."""
        if self._mesh is None:
            return to_device(staged, self.engine.device, copy=True)
        return to_device(staged, put=self._put_shards)

    def _put_shards(self, staged):
        """NumPy views of the staging buffer to :meth:`_shard_put`, which
        copies each shard synchronously."""
        from vaudio_torch.parallel.sharding import _tree_map
        return self._shard_put(_tree_map(torch.Tensor.numpy, staged))

    def _local_carry(self):
        """The carry as one tree (a mesh's shards joined on the host);
        caller holds ``_carry_lock``."""
        c = self._carry
        return c.gather("cpu") if _is_sharded(c) else c

    def _map_carry(self, fn):
        """``fn`` applied to the carry, shard by shard under a mesh."""
        c = self._carry
        return c.map(fn) if _is_sharded(c) else fn(c)

    def _stack_params(self):
        """Per-slot LiveParams -> one dict of (S, ...) host arrays (the
        step copies each to the device once), or the single replicated
        dict (mesh mode)."""
        if self._mesh is not None:
            return self.engine.params_arrays(self.params[0])
        with self.params_lock:
            dicts = [self.engine.params_arrays(p) for p in self.params]
        keys = set(dicts[0])
        for i, d in enumerate(dicts[1:], 1):
            if set(d) != keys:
                raise RuntimeError(
                    f"slot {i} params carry fields {sorted(set(d))} but "
                    f"slot 0 carries {sorted(keys)} — optional "
                    "array-valued fields (pan_angles) must be set on "
                    "ALL slots or none (the stacked signature is shared)")
        return {k: np.stack([d[k] for d in dicts]) for k in keys}

    # -- lifecycle -----------------------------------------------------------

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self, sources: Sequence[Iterable]) -> None:
        """Start the pod: one frame iterable per slot (length must equal
        ``n_streams``)."""
        if self._running:
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "previous pod producer has not exited; cannot start a "
                "new one over it")
        if len(sources) != self.n_streams:
            raise ValueError(
                f"{len(sources)} sources for {self.n_streams} slots")
        self._sources = [iter(s) for s in sources]
        self._active = [True] * self.n_streams
        self._stop_event.clear()
        self._error = None
        self._running = True
        self.metrics.start_time = time.monotonic()
        self._thread = threading.Thread(target=self._producer_guard,
                                        daemon=True)
        self._thread.start()

    def _producer_guard(self) -> None:
        try:
            self._producer_loop()
        except BaseException as e:
            self._error = e
            self._running = False

    def raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("pod producer failed") from self._error

    def stop(self) -> None:
        """Stop the pod; per-stream buffered audio is cleared and the OLA
        tails reset (the reference's stop semantics per stream,
        SoundEngine.swift:459-474: buffers cleared, phases/previous
        spectrum retained)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if not self._thread.is_alive():
                self._thread = None
        self._running = False
        self.metrics.end_time = time.monotonic()
        if self._metrics_fh is not None:      # close the JSONL log fd
            self._metrics_fh.close()
            self._metrics_fh = None
        for ring in self.rings:
            ring.reset()
        with self._carry_lock:
            if self._carry is not None:   # frame-sized carry, no tick yet
                self._carry = self._map_carry(lambda c: c._replace(
                    ola_tail=torch.zeros_like(c.ola_tail)))

    def replace_source(self, slot: int, source: Iterable,
                       reset_carry: bool = False) -> None:
        """Re-arm serving ``slot`` with a new frame source, live.

        Applied by the producer at the next tick.  ``reset_carry`` zeroes
        the slot's DSP state (a brand-new client); False continues from
        the slot's current state (the same camera coming back).  With
        ``exit_when_exhausted=False`` the pod idles between clients, so
        slots can be re-armed indefinitely."""
        if not 0 <= slot < self.n_streams:
            raise IndexError(f"slot {slot} out of range")
        self.push_sources[slot] = None   # re-set by arm_push if push
        with self._source_lock:
            self._pending_sources.append((slot, iter(source),
                                          bool(reset_carry)))

    def resize(self, n_streams: int, timeout: float = 30.0) -> None:
        """Elastically resize the pod to ``n_streams`` serving slots, live.

        Growth appends dark slots (cold DSP state, empty rings, an
        independent copy of slot 0's :class:`LiveParams` per new slot —
        or the pod's one shared object in mesh/shared-params mode) that are
        armed later with :meth:`replace_source` / :meth:`arm_push`.
        Shrink drops the HIGHEST slots: their sources, rings, params and
        DSP state are discarded (pull anything you still need first).
        Slots ``0..min-1`` are untouched — their carries ride along and
        their PCM continues seamlessly (per-slot math is independent in
        the stream-batched step).

        Running pods apply the resize at the producer's next dispatch
        boundary (for ``chunk_frames>1``, the next chunk boundary) and
        this call blocks until it lands; stopped pods resize immediately.
        Mesh pods: ``n_streams`` must stay a multiple of the mesh's stream
        axis.  The pod's static frame shape/dtype contract is unchanged —
        resize changes capacity, not resolution.  A pod whose slots all share
        ONE ``LiveParams`` object grows with that same object; a 1-slot
        pod is treated as per-slot.
        """
        n_new = int(n_streams)
        if n_new < 1:
            raise ValueError("n_streams must be >= 1")
        if self.max_streams is not None and n_new > self.max_streams:
            raise ValueError(
                f"n_streams {n_new} exceeds max_streams "
                f"{self.max_streams}")
        if self._mesh is not None and n_new % self._mesh.shape["stream"]:
            raise ValueError(
                f"n_streams {n_new} not a multiple of the mesh stream "
                f"axis {self._mesh.shape['stream']}")
        with self._resize_serial:
            self._resize_locked(n_new, timeout)

    def _resize_locked(self, n_new: int, timeout: float) -> None:
        if not self._running:
            with self._source_lock:
                self._resize_req = None
            self._apply_resize(n_new)
            return
        ev = threading.Event()
        with self._source_lock:
            self._resize_req = (n_new, ev)
        deadline = time.monotonic() + timeout
        producer_alive = True
        while not ev.wait(0.05):
            if time.monotonic() >= deadline:
                break
            t = self._thread
            if not (t is not None and t.is_alive()):
                producer_alive = False
                break                  # producer exited without seeing it
        if ev.is_set():
            return
        # Did not land: either the producer is wedged mid-chunk
        # (timeout), or it exited (exhausted/stopped/failed) without
        # seeing the request — apply inline in the latter case.
        with self._source_lock:
            pending = (self._resize_req is not None
                       and self._resize_req[1] is ev)
            if pending:
                self._resize_req = None
        if not pending:
            return                     # landed just after the timeout
        self.raise_if_failed()
        if producer_alive:
            raise TimeoutError(
                f"pod producer did not reach a dispatch boundary within "
                f"{timeout}s; resize to {n_new} not applied")
        self._apply_resize(n_new)      # producer already gone

    def _shrink_target(self, free, stop: int = 1, keep=None) -> int:
        """:func:`trailing_shrink_target` bound to this pod's slot count
        and mesh."""
        return trailing_shrink_target(
            self.n_streams, free, stop=stop, keep=keep,
            mesh_step=(self._mesh.shape["stream"]
                       if self._mesh is not None else None))

    def _maybe_idle_shrink(self) -> None:
        """Automatic capacity return (see :attr:`idle_shrink`): when the
        TRAILING run of slots has been free past the idle window, queue
        a shrink as a normal resize request — the producer consumes it
        at the next dispatch boundary through the same path explicit
        :meth:`resize` calls take.  Called from the producer loop only."""
        now = time.monotonic()
        free = set(self.free_slots())
        for i in list(self._free_since):
            if i not in free:
                del self._free_since[i]
        for i in free:
            self._free_since.setdefault(i, now)
        n_new = self._shrink_target(
            free, keep=lambda i: (now - self._free_since[i]
                                  <= self.idle_shrink))
        if n_new >= self.n_streams or self._resize_req is not None:
            return
        # Never override a concurrent explicit resize(): its caller holds
        # _resize_serial while waiting — user intent beats the
        # auto-shrink.
        if not self._resize_serial.acquire(blocking=False):
            return
        try:
            with self._source_lock:
                if self._resize_req is None:
                    # Tagged "auto": the producer RE-VALIDATES the
                    # trailing-free run under _lease_lock at apply time —
                    # an acquire_slot() landing between this queue and
                    # the apply must not have its fresh lease shrunk away.
                    self._resize_req = (n_new, threading.Event(), "auto")
        finally:
            self._resize_serial.release()

    def _apply_resize(self, n_new: int) -> None:
        """Apply an elastic resize.  Called from the producer thread at a
        dispatch boundary (in-flight results flushed, chunk buffers
        empty), or from :meth:`resize` while the pod is stopped.

        Lock-free readers index the per-slot lists by
        ``range(pod.n_streams)``, so ordering is the safety contract here:
        on growth the lists grow BEFORE ``n_streams`` rises; on shrink
        ``n_streams`` drops BEFORE the lists are trimmed — the lists are
        never shorter than ``n_streams``."""
        old = self.n_streams
        if n_new == old:
            return
        with self._carry_lock:
            if self._carry is not None:
                c = self._local_carry()
                if n_new < old:
                    c = type(c)(*(x[:n_new] for x in c))
                else:
                    c = type(c)(*(torch.cat([a, b]) for a, b in
                                  zip(c, _fresh_rows(c, n_new - old))))
                self._carry = self._shard_put(c)
        shared = (self._mesh is not None
                  or (old > 1 and len(set(map(id, self.params))) == 1))
        if n_new > old:
            add = n_new - old
            # Per-slot mode: new slots get an independent COPY of slot
            # 0's params — not a bare LiveParams() — so the cross-slot
            # pan_angles-presence invariant (_stack_params) survives the
            # growth when existing slots carry pan_angles.
            self.params.extend([self.params[0]] * add if shared
                               else [dataclasses.replace(self.params[0])
                                     for _ in range(add)])
            self.rings.extend(
                make_ring_buffer(self.cfg.ring_buffer_frames,
                                 self.cfg.hop_size * self.cfg.channels,
                                 self.cfg.warmup_frames,
                                 prefer_native=self._prefer_native)
                for _ in range(add))
            self._sources.extend([None] * add)
            self._active.extend([False] * add)
            self.slot_errors.extend([None] * add)
            self.push_sources.extend([None] * add)
            self.last_pcm.extend([None] * add)
            self.last_preview.extend([None] * add)
            self._preview_t.extend([0.0] * add)
            self.n_streams = n_new
        else:
            self.n_streams = n_new
            del self.params[n_new:]
            del self.rings[n_new:]
            del self._sources[n_new:]
            del self._active[n_new:]
            del self.slot_errors[n_new:]
            del self.push_sources[n_new:]
            del self.last_pcm[n_new:]
            del self.last_preview[n_new:]
            del self._preview_t[n_new:]
            with self._source_lock:
                self._pending_sources = [
                    (s, it, r) for s, it, r in self._pending_sources
                    if s < n_new]

    def arm_push(self, slot: int, *, maxsize: int = 8,
                 when_empty: str = "hold", reset_carry: bool = False,
                 push_source=None):
        """Arm serving ``slot`` for push-model ingest: frames arrive via
        :meth:`vaudio_torch.io.PushSource.push` (an RPC server, any
        capture callback) instead of being pulled from a file.

        The slot is re-armed live (see :meth:`replace_source`); between
        pushes it idles per ``when_empty`` (``"hold"`` repeats the last
        frame — a camera held still; ``"dark"`` goes silent).  Returns
        the :class:`~vaudio_torch.io.PushSource` (also kept in
        :attr:`push_sources`).  An un-paced pod (``realtime=False``)
        re-processes a held frame as fast as the device allows — push
        pods should run ``realtime=True``."""
        from vaudio_torch.io.push import PushSource
        if not 0 <= slot < self.n_streams:
            raise IndexError(f"slot {slot} out of range")
        if when_empty == "block" or (push_source is not None
                                     and push_source.when_empty == "block"):
            raise ValueError(
                "when_empty='block' is not allowed on a pod slot: the "
                "pod advances all slots in lockstep, so one blocking "
                "slot stalls the whole batch; use 'hold' or 'dark'")
        ps = push_source if push_source is not None else PushSource(
            maxsize=maxsize, when_empty=when_empty)
        # Order matters: replace_source clears the slot's push handle
        # (re-arming with a plain source un-pushes the slot).
        self.replace_source(slot, ps.frames(), reset_carry=reset_carry)
        self.push_sources[slot] = ps
        return ps

    # -- slot leasing (client-facing allocation) -----------------------------

    def free_slots(self) -> List[int]:
        """Slots available to :meth:`acquire_slot`: dark (source
        exhausted, failed, or never armed), no live push arm, and no
        pending re-arm in flight."""
        with self._source_lock:
            pending = {s for s, _, _ in self._pending_sources}
        out = []
        for i in range(self.n_streams):
            if i in pending or self._active[i]:
                continue
            ps = self.push_sources[i]
            if ps is not None and not ps.closed:
                continue               # armed push slot idling for frames
            out.append(i)
        return out

    def acquire_slot(self, *, maxsize: int = 8, when_empty: str = "hold",
                     reset_carry: bool = True):
        """Lease a serving slot for a new push client: reuses the lowest
        free slot, or elastically grows the pod (:meth:`resize`) up to
        ``max_streams``; the slot is push-armed (:meth:`arm_push`) with a
        cold DSP carry by default.  Returns ``(slot, PushSource)``.

        Raises ``RuntimeError`` when every slot is leased and the pod is
        at ``max_streams``.  Mesh pods grow by a whole stream-axis multiple
        (the resize contract)."""
        with self._lease_lock:
            free = self.free_slots()
            if not free:
                want = self.n_streams + 1
                if self._mesh is not None:
                    axis = self._mesh.shape["stream"]
                    want = (self.n_streams // axis + 1) * axis
                if self.max_streams is not None and want > self.max_streams:
                    raise RuntimeError(
                        f"pod at capacity: {self.n_streams} slots all "
                        f"leased, max_streams={self.max_streams}")
                self.resize(want)
                free = self.free_slots()
            slot = free[0]
            # Fresh real-time sink contract for the new lessee: clear the
            # previous client's buffered PCM, re-arm the warm-up gate,
            # zero the drop/underrun counters.  Safe while the pod runs:
            # a free slot is dark, so nothing writes its ring until the
            # new lease's frames dispatch.
            ring = self.rings[slot]
            (ring.reset_full if hasattr(ring, "reset_full")
             else ring.reset)()
            ps = self.arm_push(slot, maxsize=maxsize,
                               when_empty=when_empty,
                               reset_carry=reset_carry)
            ps.leased = True        # reaper: leases expire even unfed
            return slot, ps

    def release_slot(self, slot: int, shrink: bool = False) -> None:
        """End a slot's lease: close its push stream (queued frames drain,
        then the slot goes dark) or, for pull sources, send the slot dark
        at the next tick.  With ``shrink``, also resize away the trailing
        run of free slots (never below 1; inner holes are left for
        :meth:`acquire_slot` to reuse — slots are positional).

        ``shrink`` counts the released slot as free immediately — its
        still-queued push frames and any un-pulled ring PCM are DISCARDED
        with the slot."""
        if not 0 <= slot < self.n_streams:
            raise IndexError(f"slot {slot} out of range")
        with self._lease_lock:
            ps = self.push_sources[slot]
            if ps is not None and not ps.closed:
                ps.close()
            elif self._active[slot]:
                self.replace_source(slot, iter(()))   # dark next tick
            if shrink:
                freed = set(self.free_slots()) | {slot}
                target = self._shrink_target(freed)
                if target < self.n_streams:
                    self.resize(target)

    def _sig_json(self):
        """The pod's static frame contract as JSON (``frame_sig`` in
        :meth:`metrics_dict`; None until the first real frame establishes
        it), in the JAX package's format."""
        sig = self._template_sig
        if sig is None:
            return None
        if isinstance(sig, dict):
            return {"planes": {k: {"shape": list(s), "dtype": str(d)}
                               for k, (s, d) in sig.items()}}
        shape, dtype = sig
        return {"shape": list(shape), "dtype": str(dtype)}

    def check_frame(self, frame) -> Optional[str]:
        """Validate a candidate frame against the pod contract without
        queueing it: structurally a video frame the engine runs, and —
        once the pod's static signature is established by the first frame
        any slot delivered — matching it.  Returns an error message, or
        ``None`` when acceptable.  A frame rejected here would otherwise
        dark its slot at dispatch time (:meth:`_fail_slot`)."""
        try:
            fr = host_frames(frame)
        except Exception as e:
            return f"undecodable frame: {type(e).__name__}: {e}"
        err = self.engine.frame_error(fr, self.cfg)
        if err is not None:
            return err
        sig = _frame_sig(fr)
        if self._template_sig is not None and sig != self._template_sig:
            return (f"frame signature {sig} != pod signature "
                    f"{self._template_sig}: a pod serves ONE static "
                    "shape/dtype (route other resolutions to another pod)")
        return None

    def _apply_pending_sources(self) -> None:
        with self._source_lock:
            items, self._pending_sources = self._pending_sources, []
        for slot, it, reset in items:
            self._sources[slot] = it
            self._active[slot] = True
            self.slot_errors[slot] = None     # re-armed: failure cleared
            if reset:
                with self._carry_lock:
                    if self._carry is None:
                        continue     # frame-sized carry: nothing to reset
                    c = self._local_carry()
                    self._carry = self._shard_put(type(c)(*(
                        torch.cat([x[:slot], f, x[slot + 1:]])
                        for x, f in zip(c, _fresh_rows(c, 1)))))

    # -- consumers -----------------------------------------------------------

    def pull(self, slot: int, n: int) -> np.ndarray:
        """Pull ``n`` PCM samples for ``slot`` (zero-filled per the
        real-time contract, independently per stream)."""
        return self.rings[slot].pull(n)

    def snapshot_carry(self) -> StepCarry:
        """Consistent host-side (numpy) snapshot of the batched carry
        (leading axis = stream), safe while the pod runs."""
        with self._carry_lock:
            if self._carry is None:
                raise ValueError(
                    "no DSP carry yet: this engine sizes it from the "
                    "first tick and none has been processed")
            c = self._local_carry()
            return type(c)(*[x.cpu().numpy() for x in c])

    def save_state(self, path: str) -> None:
        """Checkpoint every slot's DSP carry to one .npz (safe while the
        pod runs — see :meth:`snapshot_carry`)."""
        from vaudio_torch.runtime.checkpoint import save_state
        save_state(path, self.snapshot_carry())

    def load_state(self, path: str) -> None:
        """Restore a pod checkpoint (engine-aware: shape-validated against
        the config AND the pod size); the next tick continues every
        slot's stream seamlessly."""
        carry = self._shard_put(
            self.engine.load_carry_batch(path, self.n_streams))
        with self._carry_lock:
            self._carry = carry
            self._carry_checked = self.engine.carry_static

    def stream_metrics(self, slot: int) -> Dict[str, object]:
        """Per-slot sink metrics (aggregate dispatch metrics live on
        ``self.metrics``)."""
        ring = self.rings[slot]
        err = self.slot_errors[slot]
        out = {
            "active": self._active[slot],
            "failed": err is not None,
            "buffer_fill": ring.available,
            "warmed_up": bool(getattr(ring, "warmed_up", True)),
            "dropped_frames": int(getattr(ring, "dropped_frames", 0)),
            "underrun_samples": int(getattr(ring, "underrun_samples", 0)),
            "error": None if err is None else f"{type(err).__name__}: {err}",
        }
        ps = self.push_sources[slot]
        if ps is not None:
            state = ps.state()
            out["push"] = state
            out["push_fill"] = state["fill"]
            out["push_dropped"] = state["dropped"]
            out["idle_s"] = round(time.monotonic() - ps.last_push, 3)
        return out

    def metrics_dict(self) -> Dict[str, object]:
        """The pod's observability surface as one JSON-ready dict:
        aggregate dispatch metrics (latency per batched device step,
        throughput) + per-slot sink state (the processingLatency +
        availableFrames surface, SoundEngine.swift:430-445)."""
        m = self.metrics
        return {
            "n_streams": self.n_streams,
            "chunk_frames": self.chunk_frames,
            "running": self.is_running,
            "dispatch_latency_ms": m.processing_latency_ms,
            "dispatch_latency_p50_ms": m.latency_percentile(50),
            "dispatch_latency_p99_ms": m.latency_percentile(99),
            "aggregate_fps": m.achieved_fps,
            "frames_processed": m.frames_processed,
            "dispatches": m.dispatches,
            "leases_reaped": self.leases_reaped,
            "auto_shrinks": self.auto_shrinks,
            # How often the tick's staging buffer was (re)made, and how
            # often a tick stacked into the kept one.
            "staging_allocs": self._staging.allocs,
            "staging_reuses": self._staging.reuses,
            # The tick's step: CUDA graph captures and replays, and eager
            # steps (runtime.step.GraphedStep; zeros for other steps).
            **m.step_counts(),
            # Placement signals: current free slots, the growth headroom
            # to the cap, and the pod's static frame contract.
            "free_slots": len(self.free_slots()),
            "max_streams": self.max_streams,
            "frame_sig": self._sig_json(),
            "slots": self._slot_metrics_snapshot(),
        }

    def _slot_metrics_snapshot(self) -> List[Dict[str, object]]:
        """Per-slot metrics tolerant of a concurrent elastic shrink: the
        per-slot lists can get shorter between the count read and the
        indexed reads (another thread vs the producer's _apply_resize)."""
        out = []
        for i in range(self.n_streams):
            try:
                out.append(self.stream_metrics(i))
            except IndexError:
                break                   # shrunk under us: report fewer
        return out

    def serve(self, port: int = 0, host: str = "127.0.0.1",
              refresh_ms: int = 500, token: Optional[str] = None):
        """Start the pod's live HTTP observability + control panel — the
        serving-fleet equivalent of :meth:`vaudio_torch.api.Auralizer
        .serve`: per-slot live views (dominant hues, spectrum, waveform,
        input preview), per-slot parameter sliders (POST
        ``/slots/<i>/params``), per-slot ``/slots/<i>/audio.wav``
        speakers, and aggregate pod metrics.  Non-blocking; returns the
        started :class:`~vaudio_torch.runtime.podserver.PodServer`.
        Enables :attr:`observe`."""
        from vaudio_torch.runtime.podserver import PodServer
        return PodServer(self, host=host, port=port,
                         refresh_ms=refresh_ms, token=token).start()

    # -- producer ------------------------------------------------------------

    def _fail_slot(self, i: int, e: BaseException) -> None:
        """Slot isolation: a client source raising (or feeding a
        pod-contract-violating frame) darkens ITS slot only — loud
        (recorded in slot_errors/stream_metrics and printed); the other
        N-1 slots keep serving.  The slot can be re-armed with
        replace_source."""
        self._active[i] = False
        self.slot_errors[i] = e
        print(f"vaudio pod: slot {i} source failed "
              f"({type(e).__name__}: {e}); slot dark, pod continues",
              file=sys.stderr)

    def _next_batch(self):
        """Advance every slot one frame.  Returns (frames, real) or None
        when no slot has ever yielded; exhausted slots get black frames
        (static batch shape) and real[i] = False.  A source may yield
        ``None`` to mean "no frame this tick" (an idle push slot): the
        slot stays armed but is dark for the tick."""
        frames = [None] * self.n_streams
        real = [False] * self.n_streams
        for i in range(self.n_streams):
            if not self._active[i]:
                continue
            try:
                fr = next(self._sources[i])
            except StopIteration:
                self._active[i] = False
                continue
            except Exception as e:
                self._fail_slot(i, e)
                continue
            if fr is None:
                continue                     # idle tick: dark but alive
            try:
                fr = host_frames(fr)
                sig = _frame_sig(fr)
                if self._template_sig is None:
                    self._template_sig = sig
                    self._zeros = _zeros_like_frame(fr)
                elif sig != self._template_sig:
                    raise ValueError(
                        f"slot {i} frame signature {sig} != pod "
                        f"signature {self._template_sig}: a pod serves "
                        "ONE static shape/dtype (route other "
                        "resolutions to another pod)")
            except Exception as e:
                self._fail_slot(i, e)
                continue
            frames[i] = fr
            real[i] = True
        if self._zeros is None or not any(real):
            # Nothing has ever yielded, or every remaining slot just
            # exhausted on this tick — no all-dark dispatch.
            return None
        for i in range(self.n_streams):
            if frames[i] is None:
                frames[i] = self._zeros
        return frames, real

    def _fetch_pcm(self, out) -> np.ndarray:
        """A dispatch's PCM on the host (waits for the device), a mesh's
        shards joined in slot order."""
        pcm = out["pcm"]
        with span("vaudio.readback"):
            return pcm.gather("cpu").numpy() if _is_sharded(pcm) \
                else pcm.cpu().numpy()

    def _all_inactive(self) -> bool:
        """True when no slot has a live source."""
        return not any(self._active)

    def _flush(self, pending) -> None:
        """Write each slot's REAL hops to its ring (masks[i][t] marks rows
        from actual source frames; black batch-padding rows are dropped —
        a slot that ends mid-chunk, or is re-armed mid-chunk, only ever
        hears its own frames)."""
        with span("vaudio.pod.flush"):
            out, t0, masks = pending
            pcm = self._fetch_pcm(out)         # waits for the device
            hop = self.cfg.hop_size * self.cfg.channels
            pcm = pcm.reshape(len(masks), -1, hop)
            for i, mask in enumerate(masks):
                for t, is_real in enumerate(mask):
                    if is_real:
                        self.rings[i].write(pcm[i, t])
                        if self.observe:
                            # Waveform view state: the slot's latest real hop
                            # (the previousSignal surface,
                            # Views/TimeDomainFrameView.swift:15-51).
                            row = pcm[i, t]
                            if self.cfg.channels > 1:
                                row = row.reshape(-1, self.cfg.channels)
                            self.last_pcm[i] = row
            latency_ms = (time.monotonic() - t0) * 1000.0
            n_frames = int(sum(sum(m) for m in masks))
            self.metrics.record(latency_ms, n_frames)
            if self._metrics_log is not None:
                if self._metrics_fh is None:
                    self._metrics_fh = open(self._metrics_log, "a")
                self._metrics_fh.write(json.dumps({
                    "t": time.time(),
                    "frames": n_frames,
                    "latency_ms": round(latency_ms, 3),
                    "slots": [self.stream_metrics(i)
                              for i in range(self.n_streams)],
                }) + "\n")
                self._metrics_fh.flush()

    def _producer_loop(self) -> None:
        T = self.chunk_frames
        frame_period = 1.0 / self.cfg.video_fps
        next_deadline = time.monotonic()
        pending = None                # (out, t0, per-slot real-row masks)
        chunk_bufs: List[list] = [[] for _ in range(self.n_streams)]
        chunk_mask: List[list] = [[] for _ in range(self.n_streams)]
        chunk_t0: Optional[float] = None

        def dispatch(stacked, t0, masks):
            nonlocal pending
            if self._carry is None or not self._carry_checked:
                f0 = stacked
                for _ in range(2 if T > 1 else 1):   # peel stream/chunk
                    f0 = ({k: v[0] for k, v in f0.items()}
                          if isinstance(f0, dict) else f0[0])
                # Frame-sized carry (engine.carry_static False): built
                # from the first tick's frame shape.  Re-checked under
                # the lock — a concurrent restore (load_state) must not
                # be overwritten by a fresh init; a restored carry is
                # instead validated against the actual frame.
                with self._carry_lock:
                    if self._carry is None:
                        self._carry = self._shard_put(
                            self.engine.init_carry_batch(self.n_streams,
                                                         f0))
                        self._carry_checked = True
                if not self._carry_checked:
                    c = self._carry
                    err = self.engine.carry_mismatch(
                        c[0] if _is_sharded(c) else c, f0)
                    if err is not None:
                        raise ValueError(err)
                    self._carry_checked = True
            params = self._stack_params()
            batch = self._put_frames(stacked)
            with self._carry_lock, span("vaudio.step"):
                self._carry, out = self._step(self._carry, batch, params)
            if pending is not None:
                self._flush(pending)
            pending = (out, t0, masks)

        def dispatch_chunk():
            # The held chunk, padded with black frames to the static chunk
            # shape where it is partial (masks keep the padding out of the
            # rings), is dispatched and let go.
            nonlocal chunk_bufs, chunk_mask
            pad = T - len(chunk_bufs[0])
            for i in range(self.n_streams):
                chunk_bufs[i].extend([self._zeros] * pad)
                chunk_mask[i].extend([False] * pad)
            with span("vaudio.pod.stack"):
                stacked = self._staging.stack(chunk_bufs, chunked=True)
            dispatch(stacked, chunk_t0 or time.monotonic(),
                     [list(m) for m in chunk_mask])
            chunk_bufs = [[] for _ in range(self.n_streams)]
            chunk_mask = [[] for _ in range(self.n_streams)]

        while not self._stop_event.is_set():
            # Elastic resize lands at a dispatch boundary: a held partial
            # chunk is padded out and dispatched NOW (masks keep the
            # padding out of the rings) — a pod idling on a partial chunk
            # would otherwise never reach a chunk boundary and wedge every
            # resize into TimeoutError — then the in-flight result is
            # flushed at the OLD shape before the shape changes.
            req = None
            if self._resize_req is not None:
                with self._source_lock:
                    req, self._resize_req = self._resize_req, None
            lease_held = False
            if req is not None and len(req) == 3:
                # Auto-shrink (see _maybe_idle_shrink): re-validate the
                # trailing-free run NOW, under the lease lock, and hold
                # that lock through the apply — a lease granted since the
                # request was queued makes its slot non-free and must
                # survive.  Non-blocking: an acquire_slot() in flight may
                # itself be waiting on this loop (its grow resize), so
                # blocking here would deadlock; the shrink is simply
                # re-queued by the next idle check.
                if not self._lease_lock.acquire(blocking=False):
                    req = None
                else:
                    lease_held = True
                    n_final = self._shrink_target(
                        set(self.free_slots()), stop=req[0])
                    if n_final >= self.n_streams:
                        self._lease_lock.release()
                        lease_held = False
                        req = None
                    else:
                        req = (n_final, req[1], "auto")
            if req is not None:
                try:
                    if chunk_bufs[0]:
                        dispatch_chunk()
                    if pending is not None:
                        self._flush(pending)
                        pending = None
                    old_n = self.n_streams
                    if len(req) == 3:
                        # Counted before the apply publishes the smaller
                        # n_streams: a reader that sees the pod shrunk
                        # also sees the shrink counted.  Still after the
                        # re-validation above, so only a shrink that takes
                        # place is counted.
                        self.auto_shrinks += 1
                    self._apply_resize(req[0])
                    chunk_bufs = [[] for _ in range(self.n_streams)]
                    chunk_mask = [[] for _ in range(self.n_streams)]
                    if len(req) == 3:
                        print(f"vaudio pod: trailing slots "
                              f"{req[0]}..{old_n - 1} idle past "
                              f"{self.idle_shrink:g}s; shrunk to "
                              f"{req[0]} slots", file=sys.stderr)
                    req[1].set()
                finally:
                    if lease_held:
                        self._lease_lock.release()
            self._apply_pending_sources()
            if self.lease_timeout is not None:
                # Dead-client reaping (see lease_timeout): idleness is the
                # time since the client's last PUSH, and a non-empty
                # queue always counts as live.
                now = time.monotonic()
                for i in range(self.n_streams):
                    ps = self.push_sources[i]
                    if (ps is not None and not ps.closed
                            and self._active[i] and ps.fill == 0
                            and (ps.leased or ps.pushed > 0)
                            and now - ps.last_push > self.lease_timeout):
                        ps.close()
                        self.leases_reaped += 1
                        print(f"vaudio pod: slot {i} lease expired "
                              f"({self.lease_timeout:g}s without a "
                              "frame); push stream closed, slot "
                              "released", file=sys.stderr)
            if self.idle_shrink is not None:
                self._maybe_idle_shrink()
            if self._all_inactive():
                if self._exit_when_exhausted:
                    break
                # Long-lived pod: idle awaiting replace_source re-arms.
                if pending is not None:
                    self._flush(pending)
                    pending = None
                time.sleep(0.001)
                continue
            if self.realtime:
                now = time.monotonic()
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                next_deadline = max(next_deadline + frame_period,
                                    time.monotonic())
            with span("vaudio.pod.tick"):
                with span("vaudio.pod.sources"):
                    tick = self._next_batch()
                if tick is None:
                    # No dispatch this tick (every source died yielding zero
                    # frames, or every armed slot is an idle push slot
                    # between frames): flush the in-flight result — normally
                    # flushed by the NEXT dispatch, which may be a long time
                    # coming — and don't spin the loop hot.
                    if pending is not None:
                        self._flush(pending)
                        pending = None
                    time.sleep(0.001)
                    continue
                frames, real = tick
                if self.observe:
                    # Input-preview state (the CameraPreview surface,
                    # Views/CameraPreview.swift:11-51): render the small RGB
                    # preview NOW — frames may be zero-copy pool views only
                    # valid within this tick; the preview strides+copies.
                    # Throttled per slot (see preview_interval).
                    from vaudio_torch.utils.render import input_preview_image
                    now = time.monotonic()
                    for i in range(self.n_streams):
                        if real[i] and (now - self._preview_t[i]
                                        >= self.preview_interval):
                            self._preview_t[i] = now
                            try:
                                self.last_preview[i] = \
                                    input_preview_image(frames[i])
                            except Exception:
                                pass   # a view must never kill the producer
                if T == 1:
                    # The stack copies the (possibly zero-copy-borrowed)
                    # frames into the staging buffer within the tick, inside
                    # the sources' lag-2 window.
                    with span("vaudio.pod.stack"):
                        stacked = self._staging.stack(frames)
                    dispatch(stacked, time.monotonic(), [[r] for r in real])
                    continue
                if not any(chunk_bufs):
                    chunk_t0 = time.monotonic()
                for i in range(self.n_streams):
                    # Chunk buffers span ticks: borrowed zero-copy views must
                    # be owned here (same invariant as runtime.stream).
                    chunk_bufs[i].append(own_frame(frames[i]))
                    chunk_mask[i].append(real[i])
                if len(chunk_bufs[0]) >= T:
                    dispatch_chunk()

        # Trailing partial chunk: only its real hops are written.
        if any(chunk_bufs) and not self._stop_event.is_set():
            dispatch_chunk()
        if pending is not None and not self._stop_event.is_set():
            self._flush(pending)
        self._running = False
