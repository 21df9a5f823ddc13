"""PCM sinks (a copy of :mod:`vaudio.io.sinks`): WAV writing and reading
through the standard library, and a speaker sink through a command-line
player subprocess (the AVAudioSourceNode output,
SoundEngine.swift:156-228)."""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import List, Optional, Sequence

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


def _player_command(sample_rate: int, channels: int
                    ) -> Optional[List[str]]:
    """The player command line for whichever CLI player exists.

    ``VAUDIO_PLAYER`` overrides discovery: the named binary is invoked as
    ``<player> <sample_rate> <channels>`` and fed raw little-endian f32
    PCM on stdin.  Otherwise the first of aplay / pw-play / paplay /
    ffplay found on PATH, with its raw-f32 flags.  None if no player."""
    override = os.environ.get("VAUDIO_PLAYER")
    if override:
        return [override, str(sample_rate), str(channels)]
    if shutil.which("aplay"):
        return ["aplay", "-q", "-t", "raw", "-f", "FLOAT_LE",
                "-r", str(sample_rate), "-c", str(channels), "-"]
    if shutil.which("pw-play"):
        return ["pw-play", "--format=f32", f"--rate={sample_rate}",
                f"--channels={channels}", "-"]
    if shutil.which("paplay"):
        return ["paplay", "--raw", "--format=float32le",
                f"--rate={sample_rate}", f"--channels={channels}"]
    if shutil.which("ffplay"):
        return ["ffplay", "-autoexit", "-nodisp", "-loglevel", "error",
                "-f", "f32le", "-ar", str(sample_rate), "-ac",
                str(channels), "-i", "-"]
    return None


class SubprocessPlayer:
    """Speaker output through an external player subprocess: f32 PCM is
    piped into a system player (see :func:`_player_command`).  Raises a
    clear error when no player exists; probe with :meth:`available`."""

    def __init__(self, sample_rate: float, channels: int = 1,
                 command: Optional[Sequence[str]] = None):
        cmd = (list(command) if command is not None
               else _player_command(int(round(sample_rate)), channels))
        if cmd is None:
            raise RuntimeError(
                "no audio player found: install aplay/pw-play/paplay/"
                "ffplay or set VAUDIO_PLAYER to a binary accepting "
                "'<player> <rate> <channels>' with f32le PCM on stdin")
        self.command = cmd
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
        self.samples_written = 0

    @staticmethod
    def available() -> bool:
        return _player_command(48000, 1) is not None

    def write(self, pcm: np.ndarray) -> None:
        """Write a block of f32 PCM (mono [N] or interleaved [N*ch] /
        [N, ch]) to the player.  Raises BrokenPipeError if it died."""
        buf = np.asarray(pcm, dtype=np.float32).reshape(-1)
        self._proc.stdin.write(buf.astype("<f4", copy=False).tobytes())
        self.samples_written += buf.size

    def close(self, timeout: float = 10.0) -> int:
        """Flush, close stdin and wait for the player; returns its exit
        code."""
        if self._proc.stdin is not None and not self._proc.stdin.closed:
            try:
                self._proc.stdin.flush()
            except (BrokenPipeError, OSError):
                pass
            self._proc.stdin.close()
        try:
            return self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self._proc.terminate()
            return self._proc.wait(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path: str):
    """Read a 16-bit WAV back to (f32 array in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype="<i2")
        audio = data.astype(np.float32) / 32767.0
        ch = w.getnchannels()
        if ch > 1:
            audio = audio.reshape(-1, ch)
        return audio, float(w.getframerate())
