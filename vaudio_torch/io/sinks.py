"""PCM sinks (a copy of :func:`vaudio.io.sinks.write_wav`)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: float = 44100.0,
              channels: int = 1) -> None:
    """Write float32 PCM in [-1, 1] to a 16-bit WAV file."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    if audio.shape[1] != channels:
        if channels == 2 and audio.shape[1] == 1:
            audio = np.repeat(audio, 2, axis=1)
        else:
            raise ValueError(
                f"audio has {audio.shape[1]} channels, expected {channels}")
    pcm16 = np.clip(audio, -1.0, 1.0)
    pcm16 = (pcm16 * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(int(round(sample_rate)))
        w.writeframes(pcm16.tobytes())
