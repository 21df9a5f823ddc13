"""Public API — the PyTorch port of :class:`vaudio.api.Auralizer`: offline
sonification and the live streaming front door.

Offline::

    aur = Auralizer(config=AuralizerConfig(channels=2))
    audio = aur.sonify(frames)              # f32[T*hop, 2] PCM
    aur.sonify_to_wav(frames, "out.wav")

Streaming::

    aur = Auralizer(source=frames, realtime=True)
    aur.start()
    pcm = aur.pull(512)                     # audio-callback style
    aur.stop()

Everything runs on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np

from vaudio_torch import check_config, not_ported
from vaudio_torch.config import AuralizerConfig, LiveParams
from vaudio_torch.io import ArraySource, write_wav
from vaudio_torch.runtime.chunked import run_offline_batched
from vaudio_torch.runtime.engine import make_engine
from vaudio_torch.runtime.step import run_offline
from vaudio_torch.runtime.stream import StreamingAuralizer

# A source is a (T, H, W, 3) array, a bare iterable of frames, or any object
# with .frames() (ArraySource or user-defined).
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
        check_config(config)
        self._engine = make_engine(model, config, debug=debug,
                                   device=device)
        self.model = model
        self.config = config
        self.device = self._engine.device
        self.params = params if params is not None else LiveParams()
        self._source = source
        self._stream = StreamingAuralizer(
            config, params=self.params, realtime=realtime,
            prefer_native=prefer_native, debug=debug,
            sink_latency_ms=sink_latency_ms, chunk_frames=chunk_frames,
            metrics_log=metrics_log, engine=self._engine,
            pipeline_depth=pipeline_depth)

    # ------------------------------------------------------------------
    # Offline
    # ------------------------------------------------------------------

    def sonify(self, frames, debug: bool = False,
               mode: str = "auto") -> np.ndarray:
        """Sonify a whole clip (T, H, W, 3), u8 or f32 in [0, 1] (numpy, a
        tensor or an :class:`ArraySource`).  Returns PCM f32[T*hop] mono or
        f32[T*hop, channels].

        ``mode``: ``"chunked"`` = the chunk-batched pipeline; ``"scan"`` =
        frame by frame; ``"auto"`` picks chunked for clips of >= 8 frames.
        """
        if debug:
            raise not_ported("sonify(debug=True)")
        if isinstance(frames, ArraySource):
            frames = frames.tensor()
        if mode not in ("auto", "chunked", "scan"):
            raise ValueError(f"unknown sonify mode {mode!r} "
                             f"(expected auto, chunked or scan)")
        if mode == "auto":
            mode = "chunked" if len(frames) >= 8 else "scan"
        run = run_offline_batched if mode == "chunked" else run_offline
        audio, _carry, _dbg = run(frames, self.config,
                                  self.params.as_arrays(),
                                  device=self.device)
        return audio.cpu().numpy()

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
        raise not_ported("attach_control (the live control channel)")

    def live_debug(self, out_dir: str, every_frames: int = 30,
                   full_heatmaps: bool = False):
        raise not_ported("live_debug")

    def serve(self, port: int = 0, host: str = "127.0.0.1",
              refresh_ms: int = 500, token: Optional[str] = None):
        raise not_ported("serve (the live HTTP server)")

    def inspect_frame(self, frame: np.ndarray) -> Dict[str, np.ndarray]:
        raise not_ported("inspect_frame")

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
        }

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
        package's format); safe while the stream runs."""
        from vaudio_torch.runtime.checkpoint import save_state
        save_state(path, self._stream.snapshot_carry())

    def load_state(self, path) -> None:
        """Restore a saved DSP carry (saved by either package); the next
        frame continues from it."""
        self._stream.set_carry(self._engine.load_carry(path))
