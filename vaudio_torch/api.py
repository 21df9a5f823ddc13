"""Public API — the PyTorch port of :class:`vaudio.api.Auralizer`: offline
sonification and the live streaming front door.

Offline::

    aur = Auralizer(config=AuralizerConfig(channels=2))
    audio = aur.sonify(frames)              # f32[T*hop, 2] PCM
    audio = aur.sonify({"y": y, "u": u, "v": v})   # planar YUV 4:2:0
    aur.sonify_to_wav(frames, "out.wav")

Streaming::

    aur = Auralizer(source=frames, realtime=True)
    aur.start()
    pcm = aur.pull(512)                     # audio-callback style
    aur.stop()

Serving (frames pushed over HTTP, ``POST /frames``)::

    aur = Auralizer(source=PushSource(when_empty="block"))
    server = aur.serve(port=0)              # LiveServer, non-blocking
    aur.start()
    push_frames(server.url, None, frames)   # from any client
    ...
    server.stop(); aur.stop()

The per-pixel family: ``Auralizer(model="orthomodes")`` (mono, RGB only).
Everything runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import ArraySource, PushSource, write_wav
from vaudio_torch.runtime.chunked import run_offline_batched
from vaudio_torch.runtime.engine import make_engine
from vaudio_torch.runtime.ingest import (OfflineStaging, num_frames,
                                         to_device)
from vaudio_torch.runtime.step import run_offline
from vaudio_torch.runtime.stream import StreamingAuralizer
from vaudio_torch.utils.profiling import span
from vaudio_torch.vision.features import extract_features

# A source is a (T, H, W, 3) array, a bare iterable of frames (arrays or
# dicts of YUV planes), or any object with .frames() (ArraySource,
# RawVideoSource or user-defined).
SourceLike = Union[ArraySource, np.ndarray, Iterable[np.ndarray], None]


class Auralizer:
    """Video -> audio sonification on one device (the framework's front
    door).  The arguments are the JAX package's, in its order, plus
    ``device``.  ``chunk_frames > 1`` streams through the chunk-batched
    pipeline, one device call per N frames; ``metrics_log`` appends one
    JSONL record per dispatch."""

    def __init__(self, source: SourceLike = None,
                 config: AuralizerConfig = AuralizerConfig(),
                 params: Optional[LiveParams] = None,
                 realtime: bool = False,
                 debug: bool = True,
                 prefer_native: bool = True,
                 sink_latency_ms: Optional[float] = None,
                 chunk_frames: int = 1,
                 metrics_log: Optional[str] = None,
                 model: str = "auralizer",
                 pipeline_depth: int = 4,
                 device=None):
        if isinstance(source, AuralizerConfig):
            raise TypeError("Auralizer's first argument is the frame "
                            "source; pass the config as config=...")
        self._engine = make_engine(model, config, debug=debug,
                                   device=device)
        # The engine owns any config coercion (the per-pixel family is mono
        # and unfiltered): adopt its view, so that the ring and the PCM
        # agree with it.
        config = self._engine.cfg
        self.model = model
        self.config = config
        self.device = self._engine.device
        self.params = params if params is not None else LiveParams()
        self._source = source
        # The offline route's staging: its page-locked slice ring is made
        # at the first chunked sonify of a host clip on the card and kept.
        self._staging = OfflineStaging(self.device)
        #: The live :class:`PushSource` when the stream's source is
        #: push-model (set by :meth:`start`); the server's ``POST /frames``
        #: door feeds it.
        self.push_source = None
        self._stream = StreamingAuralizer(
            config, params=self.params, realtime=realtime,
            prefer_native=prefer_native, debug=debug,
            sink_latency_ms=sink_latency_ms, chunk_frames=chunk_frames,
            metrics_log=metrics_log, engine=self._engine,
            pipeline_depth=pipeline_depth)

    # ------------------------------------------------------------------
    # Offline
    # ------------------------------------------------------------------

    def sonify(self, frames, debug: bool = False, mode: str = "auto"):
        """Sonify a whole clip: RGB (T, H, W, 3), u8 or f32 in [0, 1]
        (numpy, a tensor or an :class:`ArraySource`), or a dict
        ``{"y", "u", "v"}`` of planar u8 YUV 4:2:0 (T, H, W) and
        (T, H/2, W/2).  Returns PCM f32[T*hop] mono or f32[T*hop,
        channels]; with ``debug`` (pcm, dict of per-frame hues, grads and
        spectrum), as numpy.

        ``mode``: ``"chunked"`` = the chunk-batched pipeline; ``"scan"`` =
        frame by frame; ``"auto"`` picks chunked for clips of >= 8 frames.
        """
        with span("vaudio.sonify"):
            if isinstance(frames, ArraySource):
                frames = frames.tensor()
            if self.model == "orthomodes":
                if debug:
                    raise ValueError("the OrthoModes family has no cell "
                                     "debug surface (per-pixel model); "
                                     "sonify with debug=False")
                if isinstance(frames, dict):
                    raise ValueError("the OrthoModes family is RGB-only")
                return self._engine.model.sonify(
                    frames, self._engine.params_arrays(self.params))
            if mode not in ("auto", "chunked", "scan"):
                raise ValueError(f"unknown sonify mode {mode!r} "
                                 f"(expected auto, chunked or scan)")
            if mode == "auto":
                mode = "chunked" if num_frames(frames) >= 8 else "scan"
            if mode == "chunked":
                audio, _carry, dbg = run_offline_batched(
                    frames, self.config, self.params.as_arrays(),
                    debug=debug, device=self.device, staging=self._staging)
            else:
                audio, _carry, dbg = run_offline(
                    frames, self.config, self.params.as_arrays(),
                    debug=debug, device=self.device)
            with span("vaudio.readback"):
                audio = audio.cpu().numpy()
            if not debug:
                return audio
            return audio, {k: v.cpu().numpy() for k, v in dbg.items()}

    def sonify_to_wav(self, frames, path: str) -> np.ndarray:
        audio = self.sonify(frames)
        write_wav(path, audio, self.config.sample_rate,
                  channels=self.config.channels)
        return audio

    # ------------------------------------------------------------------
    # Streaming (toggleProcessing equivalents)
    # ------------------------------------------------------------------

    def _frame_iter(self, source: SourceLike) -> Iterable[np.ndarray]:
        if source is None:
            raise ValueError("no frame source provided")
        ps = source if isinstance(source, PushSource) else None
        if ps is not None and ps.when_empty != "block":
            # hold/dark yield None on idle ticks, a pod's semantics; the
            # single stream's producer has its own thread and blocks.
            raise ValueError(
                "a single-stream push source must use "
                "when_empty='block' (hold/dark idle ticks are pod "
                "semantics)")
        # Install only a validated source: a rejected one must not leave
        # the server's /frames door queueing into a dead queue.
        self.push_source = ps
        # Flush on idle: with the push queue empty the producer is about
        # to block in PushSource.frames(), so a partial chunk must not
        # hold back the audio of the frames already pushed.
        self._stream.idle_probe = (
            (lambda: ps.fill == 0) if ps is not None else None)
        if isinstance(source, np.ndarray):
            return ArraySource(source).frames()
        frames = getattr(source, "frames", None)
        if callable(frames):
            return frames()
        return source

    def start(self, source: SourceLike = None) -> None:
        if source is None:
            source = self._source
        self._stream.start(self._frame_iter(source))

    def stop(self) -> None:
        if self.push_source is not None:
            # Wake a producer blocked in PushSource.frames(): the stream's
            # stop flag is only read between frames.
            self.push_source.close()
        self._stream.stop()

    def toggle(self, source: SourceLike = None) -> None:
        if self.is_running:
            self.stop()
        else:
            self.start(source)

    def run_until_exhausted(self, source: SourceLike = None,
                            timeout: float = 120.0) -> None:
        if source is None:
            source = self._source
        self._stream.run_until_exhausted(self._frame_iter(source),
                                         timeout=timeout)

    @property
    def is_running(self) -> bool:
        return self._stream.is_running

    def pull(self, n: int) -> np.ndarray:
        """Pull PCM — the AVAudioSourceNode render-callback equivalent."""
        return self._stream.pull(n)

    def audio_stream(self, quantum: int = 512,
                     pace: Optional[bool] = None) -> Iterator[np.ndarray]:
        return self._stream.audio_stream(quantum, pace=pace)

    def attach_control(self, path_or_file, **kwargs):
        """Attach a JSON-lines live-parameter control channel (a FIFO, a
        file or an open file object): each line is a JSON object of
        LiveParams updates applied mid-stream (the reference's control
        sliders, ControlPanelView.swift:11-43).  Returns the started
        :class:`~vaudio_torch.runtime.control.ControlChannel`, stopped by
        :meth:`stop`."""
        return self._stream.attach_control(path_or_file, **kwargs)

    def live_debug(self, out_dir: str, every_frames: int = 30,
                   full_heatmaps: bool = False):
        """Start a live debug surface: PNGs and an auto-refreshing
        ``index.html`` re-rendered every ``every_frames`` processed frames
        while the stream runs
        (:class:`~vaudio_torch.runtime.control.LiveDebugRenderer`).  Needs
        ``debug=True``.  Returns the started renderer (``.stop()`` it)."""
        from vaudio_torch.runtime.control import LiveDebugRenderer
        if not self._stream.debug:
            raise ValueError("live_debug requires debug=True on this "
                             "Auralizer (the stream publishes no debug "
                             "state otherwise)")
        return LiveDebugRenderer(self, out_dir, every_frames=every_frames,
                                 full_heatmaps=full_heatmaps).start()

    def serve(self, port: int = 0, host: str = "127.0.0.1",
              refresh_ms: int = 500, token: Optional[str] = None):
        """Start the live HTTP control panel and observability server
        (parameters, metrics, checkpoints, debug views, ``POST /frames``
        ingest into a :class:`PushSource` and a live ``/audio.wav``).
        Non-blocking; returns the started
        :class:`~vaudio_torch.runtime.server.LiveServer` (``.url``,
        ``.stop()``).  ``port=0`` binds an ephemeral port.  The views need
        ``debug=True``."""
        from vaudio_torch.runtime.server import LiveServer
        return LiveServer(self, host=host, port=port,
                          refresh_ms=refresh_ms, token=token).start()

    def inspect_frame(self, frame) -> Dict[str, np.ndarray]:
        """One frame's full vision analysis (the ConvolutionDebugView
        surface): hues, grads, the histogram, the rotated mode maps of all
        three HSI channels and the mip's HSI, as numpy.  The hue EMA
        starts from the stream's current hues and is not advanced.  A u8
        frame goes to the device unconverted, through the same pooling as
        the stream; RGB only."""
        if self.model != "auralizer":
            raise ValueError(
                f"inspect_frame analyzes the flagship 16-cell model; "
                f"the {self.model!r} family has no cell debug surface "
                "(spectrum/waveform views still work live)")
        dev = self.device
        hues, grads, dbg = extract_features(
            to_device(frame, dev),
            torch.as_tensor(self._stream.snapshot_carry().hues).to(dev),
            torch.tensor(np.float32(self.params.spectrum_mixing),
                         device=dev),
            self.config, compute_debug_maps=True)
        out = {"hues": hues.cpu().numpy(), "grads": grads.cpu().numpy()}
        out.update({k: v.cpu().numpy() for k, v in dbg.items()})
        return out

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    @property
    def metrics(self) -> Dict[str, Any]:
        """Latency / throughput / buffer metrics (the processingLatency +
        availableFrames surface, SoundEngine.swift:430-445,477-484)."""
        m = self._stream.metrics
        ring = self._stream.ring
        hw = self._stream.sink_latency_ms
        return {
            "processing_latency_ms": m.processing_latency_ms,
            "latency_p50_ms": m.latency_percentile(50),
            "latency_p99_ms": m.latency_percentile(99),
            "hardware_latency_ms": hw,
            "total_latency_p50_ms": m.latency_percentile(50) + hw,
            "achieved_fps": m.achieved_fps,
            "frames_processed": m.frames_processed,
            "dispatches": m.dispatches,
            "resolution_changes": m.resolution_changes,
            "buffer_fill": ring.available,
            "warmed_up": bool(ring.warmed_up),
            "dropped_frames": ring.dropped_frames,
            "underrun_samples": ring.underrun_samples,
            # The per-frame step's CUDA graph captures and replays, and
            # its eager steps (runtime.step.GraphedStep).
            **m.step_counts(),
        }

    def ingest_metrics(self) -> Dict[str, int]:
        """The offline route's staging counters: ``staging_allocs`` (page-
        locked rings made), ``staging_reuses`` (staged clips through a
        kept ring), ``staged_chunks`` and ``direct_chunks`` (chunks that
        reached the device through the ring, or by the chunk step's own
        copy)."""
        return self._staging.metrics()

    def frame_error(self, frame) -> Optional[str]:
        """Engine-aware validation for the network-ingest door: an error
        message when this stream could not run the frame, else None
        (``POST /frames``)."""
        return self._engine.frame_error(frame, self.config)

    @property
    def failure(self):
        """The exception the producer thread died with, or ``None``."""
        return self._stream._error

    def raise_if_failed(self) -> None:
        """Re-raise any exception the producer thread died with."""
        self._stream.raise_if_failed()

    @property
    def debug(self) -> Dict[str, np.ndarray]:
        """Latest per-frame debug state: hues (cellMaxHues), grads
        (cellAvgGrads), spectrum (previousSpectrum) and the last pcm hop."""
        return dict(self._stream.debug_state)

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------

    def save_state(self, path) -> None:
        """Serialize the stream's DSP carry to ``path`` (.npz, the JAX
        package's format); safe while the stream runs.  Raises ValueError
        before the first frame of a frame-sized (OrthoModes) carry."""
        from vaudio_torch.runtime.checkpoint import save_state
        save_state(path, self._stream.snapshot_carry())

    def load_state(self, path) -> None:
        """Restore a saved DSP carry (saved by either package), checked by
        this model family's engine; the next frame continues from it."""
        self._stream.set_carry(self._engine.load_carry(path))
