"""Public offline API — the PyTorch port of the offline part of
:class:`vaudio.api.Auralizer` (``sonify`` and ``sonify_to_wav``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.io import ArraySource, write_wav
from vaudio_torch import check_config
from vaudio_torch import device as pick_device
from vaudio_torch.runtime.chunked import run_offline_batched
from vaudio_torch.runtime.step import run_offline


class Auralizer:
    """Video -> audio sonification on one device::

        aur = Auralizer(AuralizerConfig(channels=2), device="cuda")
        audio = aur.sonify(frames)          # f32[T*hop, 2] PCM
        aur.sonify_to_wav(frames, "out.wav")
    """

    def __init__(self, config: AuralizerConfig = AuralizerConfig(),
                 params: Optional[LiveParams] = None, device=None):
        check_config(config)
        self.config = config
        self.params = params if params is not None else LiveParams()
        self.device = pick_device(device)

    def sonify(self, frames, mode: str = "auto") -> np.ndarray:
        """Sonify a whole clip (T, H, W, 3), u8 or f32 in [0, 1] (numpy, a
        tensor or an :class:`ArraySource`).  Returns PCM f32[T*hop] mono or
        f32[T*hop, channels].

        ``mode``: ``"chunked"`` = the chunk-batched pipeline; ``"scan"`` =
        frame by frame; ``"auto"`` picks chunked for clips of >= 8 frames.
        """
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
