"""The live stream: the host loop around the device step — the PyTorch port
of :mod:`vaudio.runtime.stream`.

One producer thread takes frames from a source, copies each to the device
and dispatches the step (PyTorch launches asynchronously on the card); a
drain thread waits for each result's PCM in order and writes the ring
buffer that a consumer pulls from (:meth:`StreamingAuralizer.pull`, the
AVAudioSourceNode callback).  Up to ``pipeline_depth`` dispatched results
may wait for their readback at once.  The frame->audio latency is the
reference's probe (SoundEngine.swift:430-434): wall clock from frame
capture to ring write.

Every step returns new tensors and never updates the carry in place, so a
result the drain thread is still reading is never overwritten by a later
dispatch, and :meth:`StreamingAuralizer.snapshot_carry` copies a consistent
carry to the host under the carry lock.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io.sources import own_frame
from vaudio_torch.runtime.ingest import HostBuffers, host_frames, to_device
from vaudio_torch.runtime.ringbuffer import make_ring_buffer
from vaudio_torch.runtime.step import step_counts
from vaudio_torch.utils.profiling import span


class StreamMetrics:
    """Rolling metrics — the reference's ``processingLatency`` probe and
    ``availableFrames`` print (SoundEngine.swift:430-445) — and the
    counters of ``step`` (:func:`runtime.step.step_counts`) since these
    metrics were made."""

    def __init__(self, step=None):
        self._step = step
        self._step_base = step_counts(step)
        self._lock = threading.Lock()
        self._latencies_ms: list[float] = []
        self.frames_processed = 0    # video frames through the device
        self.dispatches = 0          # device calls (a chunk counts once)
        self.resolution_changes = 0  # mid-stream frame shape changes
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None

    def record(self, latency_ms: float, n_frames: int = 1):
        with self._lock:
            self.frames_processed += n_frames
            self.dispatches += 1
            self._latencies_ms.append(latency_ms)
            if len(self._latencies_ms) > 1024:
                del self._latencies_ms[:512]

    def step_counts(self) -> Dict[str, int]:
        """How often the per-frame step captured a CUDA graph, replayed
        one and ran eagerly since these metrics were made."""
        now = step_counts(self._step)
        return {k: now[k] - self._step_base[k] for k in now}

    @property
    def processing_latency_ms(self) -> float:
        """Most recent frame->ring-buffer latency."""
        with self._lock:
            return self._latencies_ms[-1] if self._latencies_ms else 0.0

    def latency_percentile(self, q: float) -> float:
        with self._lock:
            if not self._latencies_ms:
                return 0.0
            return float(np.percentile(self._latencies_ms, q))

    @property
    def achieved_fps(self) -> float:
        with self._lock:
            if self.start_time is None or self.frames_processed == 0:
                return 0.0
            end = self.end_time or time.monotonic()
            dt = end - self.start_time
            return self.frames_processed / dt if dt > 0 else 0.0


class StreamingAuralizer:
    """Live video -> audio streaming on one device.

    Args, as the JAX package's:
      cfg: static configuration.
      params: live parameters; may be changed from any thread between
        frames (re-read at every dispatch).
      realtime: pace the producer at ``cfg.video_fps`` (True) or run as
        fast as the device allows (False).
      prefer_native: the C++ ring where its library builds, else the
        Python one (:func:`runtime.ringbuffer.make_ring_buffer`).
      chunk_frames: > 1 dispatches that many frames per device call
        through the chunk-batched pipeline (``make_chunk_step``), at the
        cost of chunk_frames - 1 frame times of buffering; a trailing
        partial chunk is single-stepped.
      metrics_log: a JSONL file that receives one record per dispatch.
      sink_latency_ms: the audio output's latency added to the reported
        total (None: one 512-sample quantum at ``cfg.sample_rate``).
      engine: the model (default :class:`runtime.engine.AuralizerEngine`
        on ``device``).
      pipeline_depth: how many dispatched steps may await their readback.
      device: where the default engine runs (the card unless "cpu").
    """

    def __init__(self, cfg: AuralizerConfig = AuralizerConfig(),
                 params: Optional[LiveParams] = None,
                 realtime: bool = False,
                 prefer_native: bool = True,
                 debug: bool = False,
                 chunk_frames: int = 1,
                 metrics_log: Optional[str] = None,
                 sink_latency_ms: Optional[float] = None,
                 engine=None,
                 pipeline_depth: int = 4,
                 device=None):
        self.cfg = cfg
        self.params = params if params is not None else LiveParams()
        self.realtime = realtime
        if sink_latency_ms is None:
            sink_latency_ms = 512.0 / cfg.sample_rate * 1000.0
        self.sink_latency_ms = float(sink_latency_ms)
        self.debug = debug
        self.chunk_frames = max(1, int(chunk_frames))
        self.pipeline_depth = max(1, int(pipeline_depth))
        if engine is None:
            from vaudio_torch.runtime.engine import AuralizerEngine
            engine = AuralizerEngine(cfg, debug=debug, device=device)
        self.engine = engine
        self._step = engine.make_step()
        self._chunk_step = (engine.make_chunk_step()
                            if self.chunk_frames > 1 else None)
        # The host buffer a chunk is stacked into, made at the first chunk.
        self._staging = HostBuffers(engine.device)
        # An engine whose carry is sized by the frame (carry_static False)
        # builds it at the first dispatch.
        self._carry = engine.init_carry() if engine.carry_static else None
        # False while a frame-sized carry awaits its check against the
        # first frame (after set_carry and after a resolution change).
        self._carry_checked = engine.carry_static
        # Guards the carry: the producer swaps it under this lock, and
        # snapshot_carry / set_carry / stop take it too.
        self._carry_lock = threading.Lock()
        # Stereo streams store interleaved samples (frame = hop * channels).
        self.ring = make_ring_buffer(cfg.ring_buffer_frames,
                                     cfg.hop_size * cfg.channels,
                                     cfg.warmup_frames,
                                     prefer_native=prefer_native)
        self.metrics = StreamMetrics(self._step)
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._running = False
        self._error: Optional[BaseException] = None
        self._metrics_log = metrics_log
        self._metrics_fh = None
        #: Optional callable: True when the frame source is about to block
        #: awaiting input; the producer then dispatches a partial chunk
        #: instead of holding its audio back.
        self.idle_probe = None
        #: Last debug snapshot (hues / grads / spectrum / pcm), refreshed
        #: per readback when ``debug``.
        self.debug_state: Dict[str, np.ndarray] = {}
        #: A host copy of the last dispatched frame when ``debug`` (the
        #: live views' input preview and per-pixel heatmaps).
        self.last_frame = None
        # The attached live-control channel, stopped with the stream.
        self._control = None

    def _log_metrics(self, latency_ms: float, n_frames: int) -> None:
        if self._metrics_log is None:
            return
        if self._metrics_fh is None:
            self._metrics_fh = open(self._metrics_log, "a")
        self._metrics_fh.write(json.dumps({
            "t": time.time(),
            "frames": n_frames,
            "latency_ms": round(latency_ms, 3),
            "buffer_fill": self.ring.available,
            "dropped_frames": int(self.ring.dropped_frames),
            "underrun_samples": int(self.ring.underrun_samples),
        }) + "\n")
        self._metrics_fh.flush()

    # -- lifecycle (VideoToAudio.toggleProcessing equivalents) -------------

    @property
    def is_running(self) -> bool:
        return self._running

    def start(self, source: Iterable[np.ndarray]) -> None:
        """Start processing frames from ``source`` on a producer thread."""
        if self._running:
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "previous stream producer has not exited (hung source?); "
                "cannot start a new one over it")
        self._stop_event.clear()
        self._running = True
        self._error = None
        # Fresh metrics per run: a restarted stream reports this run only.
        self.metrics = StreamMetrics(self._step)
        self.metrics.start_time = time.monotonic()
        self._thread = threading.Thread(
            target=self._producer_guard, args=(iter(source),), daemon=True)
        self._thread.start()

    def _producer_guard(self, frames) -> None:
        try:
            self._producer_loop(frames)
        except BaseException as e:  # surfaced by raise_if_failed()
            self._error = e
            self._running = False

    def raise_if_failed(self) -> None:
        """Re-raise the exception the producer thread died with, if any."""
        if self._error is not None:
            raise RuntimeError("stream producer failed") from self._error

    def stop(self) -> None:
        """Stop processing and clear buffered audio.  The DSP carry is kept
        (phases, previous spectrum, hues, AGC envelope), except the OLA
        tail, which is zeroed (SoundEngine.swift:459-474)."""
        self._stop_event.set()
        if self._control is not None:
            self._control.stop()
            self._control = None
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if not self._thread.is_alive():
                self._thread = None
            # else: keep the wedged thread referenced so that start()
            # refuses to run a second producer over it.
        self._running = False
        self.metrics.end_time = time.monotonic()
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None
        self.ring.reset()
        with self._carry_lock:
            if self._carry is not None:
                self._carry = self._carry._replace(
                    ola_tail=torch.zeros_like(self._carry.ola_tail))

    def snapshot_carry(self):
        """A consistent host (numpy) copy of the DSP carry, of the engine's
        carry type, safe to take while the producer runs.  Raises
        ValueError before the first frame of a frame-sized carry."""
        with self._carry_lock:
            if self._carry is None:
                raise ValueError(
                    "no DSP carry yet: this engine sizes it from the "
                    "first frame and none has been processed")
            return type(self._carry)(*[x.cpu().numpy()
                                       for x in self._carry])

    def set_carry(self, carry) -> None:
        """Replace the DSP carry (checkpoint resume): a carry of either
        package, of tensors or of numpy arrays, converted to the engine's
        carry type.  A frame-sized carry is checked against the next frame
        dispatched (``engine.carry_mismatch``)."""
        carry = self.engine.carry_from_numpy(carry)
        with self._carry_lock:
            self._carry = carry
            self._carry_checked = self.engine.carry_static

    def toggle(self, source: Optional[Iterable[np.ndarray]] = None) -> None:
        if self._running:
            self.stop()
        elif source is not None:
            self.start(source)

    def attach_control(self, path_or_file, **kwargs):
        """Attach a JSON-lines live-parameter control channel (a FIFO, a
        file or a file object) that mutates this stream's
        :class:`LiveParams` mid-run (:class:`runtime.control.ControlChannel`).
        Started at once, stopped by :meth:`stop`; returns the channel."""
        from vaudio_torch.runtime.control import ControlChannel
        if self._control is not None:
            self._control.stop()
        kwargs.setdefault("num_cells", self.cfg.num_cells)
        self._control = ControlChannel(self.params, path_or_file,
                                       **kwargs).start()
        return self._control

    def run_until_exhausted(self, source: Iterable[np.ndarray],
                            timeout: float = 60.0) -> None:
        """Process a finite source to its end.  Raises :class:`TimeoutError`
        if the producer has not finished within ``timeout`` seconds (after
        asking it to stop)."""
        self.start(source)
        t0 = time.monotonic()
        while self._thread is not None and self._thread.is_alive():
            if time.monotonic() - t0 > timeout:
                self._stop_event.set()
                self._thread.join(timeout=1.0)
                if not self._thread.is_alive():
                    self._thread = None
                self._running = False
                self.metrics.end_time = time.monotonic()
                self.raise_if_failed()
                raise TimeoutError(
                    f"stream producer still running after {timeout:.1f}s "
                    f"({self.metrics.frames_processed} frames processed)")
            time.sleep(0.001)
        self._running = False
        self.metrics.end_time = time.monotonic()
        self.raise_if_failed()

    # -- audio consumer (AVAudioSourceNode pull equivalent) ----------------

    def pull(self, n: int) -> np.ndarray:
        """Pull ``n`` PCM samples (zero-filled per the real-time contract)."""
        return self.ring.pull(n)

    def audio_stream(self, quantum: int = 512,
                     pace: Optional[bool] = None) -> Iterator[np.ndarray]:
        """Audio quanta while the stream runs (the 512-sample CoreAudio
        pull cadence).  ``pace`` sleeps each quantum to its real-time
        duration on absolute deadlines (default: ``realtime``); unpaced,
        it sleeps briefly only while the ring is empty."""
        if pace is None:
            pace = self.realtime
        quantum_sec = quantum / (self.cfg.sample_rate * self.cfg.channels)
        next_t = time.monotonic() + quantum_sec
        while self._running or self.ring.available > 0:
            block = self.pull(quantum)
            yield block
            if pace:
                now = time.monotonic()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t = max(next_t + quantum_sec, time.monotonic())
            elif self.ring.available == 0 and self._running:
                time.sleep(0.0005)

    # -- producer ----------------------------------------------------------

    def _producer_loop(self, frames: Iterator[np.ndarray]) -> None:
        frame_period = 1.0 / self.cfg.video_fps
        next_deadline = time.monotonic()
        chunk_buf: list = []
        chunk_t0: Optional[float] = None
        last_shape: Optional[tuple] = None

        # The dispatch pipeline: the producer dispatches device steps and
        # queues their outputs; the drain thread reads each PCM in order
        # and writes the ring.  put() on a full queue is the backpressure.
        pending_q: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        drop_tail = threading.Event()   # stop(): discard queued results
        drain_error: list = []

        def flush(pending):
            out, t_capture, n_hops = pending
            with span("vaudio.readback"):
                pcm = out["pcm"].cpu().numpy()  # waits for the device
            hop = self.cfg.hop_size * self.cfg.channels
            pcm = pcm.reshape(n_hops, hop)      # stereo: interleaved
            if drop_tail.is_set():
                return                          # stopped mid-readback
            for row in pcm:
                self.ring.write(row)
            latency_ms = (time.monotonic() - t_capture) * 1000.0
            self.metrics.record(latency_ms, n_hops)
            self._log_metrics(latency_ms, n_hops)
            if self.debug:
                state = {k: (v[-1] if n_hops > 1 else v).cpu().numpy()
                         for k, v in out.items() if k != "pcm"}
                last = pcm[-1]
                state["pcm"] = (last if self.cfg.channels == 1
                                else last.reshape(-1, self.cfg.channels))
                self.debug_state = state

        def drain_loop():
            while True:
                item = pending_q.get()
                if item is None:
                    return
                if drop_tail.is_set():
                    continue          # discard without reading
                try:
                    with span("vaudio.stream.flush"):
                        flush(item)
                except BaseException as e:   # surfaced by the producer
                    drain_error.append(e)
                    drop_tail.set()   # never deadlock the producer's put

        drain_thread = threading.Thread(target=drain_loop, daemon=True)
        drain_thread.start()

        def dispatch(frames_np, t_capture):
            with span("vaudio.stream.dispatch"):
                if self.debug:
                    # A copy: a zero-copy source's view is recycled two
                    # iterations later, and last_frame outlives that.
                    last = frames_np[-1]
                    self.last_frame = (
                        {k: np.array(v) for k, v in last.items()}
                        if isinstance(last, dict) else np.array(last))
                params_arrays = self.engine.params_arrays(self.params)
                if len(frames_np) == 1:
                    step = self._step
                    frames_dev = to_device(frames_np[0], self.engine.device)
                else:
                    # Out of the kept chunk buffer by a synchronous copy,
                    # so the next chunk may rewrite it.
                    step = self._chunk_step
                    frames_dev = to_device(self._staging.stack(frames_np),
                                           self.engine.device, copy=True)
                with self._carry_lock:
                    if self._carry is None:
                        # A frame-sized carry: built from the first frame, and
                        # again after a resolution change; under the lock, so a
                        # concurrent restore (POST /state.npz) is never
                        # overwritten by a fresh carry.
                        self._carry = self.engine.init_carry(frames_np[0])
                    elif not self._carry_checked:
                        # A restored frame-sized carry, checked against the
                        # first frame it meets: a clear error instead of a
                        # shape failure inside the step.
                        err = self.engine.carry_mismatch(self._carry,
                                                         frames_np[0])
                        if err is not None:
                            raise ValueError(err)
                    self._carry_checked = True
                    with span("vaudio.step"):
                        self._carry, out = step(self._carry, frames_dev,
                                                params_arrays)
                with span("vaudio.stream.enqueue"):
                    pending_q.put((out, t_capture, len(frames_np)))

        frames_it = iter(frames)
        while True:
            if self._stop_event.is_set() or drain_error:
                break
            if (self.idle_probe is not None and self.idle_probe()
                    and chunk_buf):
                # The source is about to block: release the partial chunk
                # now rather than at the next chunk boundary.
                for f in chunk_buf:
                    dispatch([f], chunk_t0 or time.monotonic())
                chunk_buf = []
            try:
                with span("vaudio.stream.source"):
                    frame = next(frames_it)
            except StopIteration:
                break
            if self.realtime:
                now = time.monotonic()
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                next_deadline = max(next_deadline + frame_period,
                                    time.monotonic())
            # The BorrowedFrame marker of a pool view is kept.
            frame_np = host_frames(frame)
            shape = tuple((frame_np["y"] if isinstance(frame_np, dict)
                           else frame_np).shape)
            if last_shape is not None and shape != last_shape:
                # Mid-stream resolution change: flush the partial chunk at
                # the old shape as single steps (frames of two shapes do
                # not stack) and count the change.
                self.metrics.resolution_changes += 1
                for f in chunk_buf:
                    dispatch([f], chunk_t0 or time.monotonic())
                chunk_buf = []
                if not self.engine.carry_static:
                    # A frame-sized carry has no meaning at the new pixel
                    # count: drop it, and the next dispatch builds a new
                    # one.  The dispatched steps hold their own carries and
                    # the drain keeps the ring's order.
                    with self._carry_lock:
                        self._carry = None
                        self._carry_checked = False
            last_shape = shape
            if self.chunk_frames == 1:
                dispatch([frame_np], time.monotonic())
            else:
                if not chunk_buf:
                    chunk_t0 = time.monotonic()
                # A chunk holds frames past their iteration: copy borrowed
                # pool views (owned frames pass through untouched).
                chunk_buf.append(own_frame(frame_np))
                if len(chunk_buf) >= self.chunk_frames:
                    dispatch(chunk_buf, chunk_t0)
                    chunk_buf = []
        # Trailing partial chunk: single-step the remainder.
        if (chunk_buf and not self._stop_event.is_set()
                and not drain_error):
            for f in chunk_buf:
                dispatch([f], chunk_t0 or time.monotonic())
        # Retire the pipeline: the sentinel, then wait for the drain thread
        # (all audio is in the ring when the producer exits).  A stop()
        # arriving meanwhile discards the queued tail.
        if self._stop_event.is_set():
            drop_tail.set()
        pending_q.put(None)
        while drain_thread.is_alive():
            drain_thread.join(timeout=0.1)
            if self._stop_event.is_set():
                drop_tail.set()
        if drain_error:
            raise drain_error[0]
        self._running = False
