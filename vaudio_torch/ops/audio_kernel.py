"""Kernel K4: the fused AGC + overlap-add audio tail.

One frame's signal f32[nfft] (mono) or f32[C, nfft] (stereo, gains shared
across channels) -> (pcm f32[(C,) nfft / 2], new tail like the signal, new
running max f32[]): the attack/release peak EMA, the sigmoid normalisation,
the peak renormalisation, the window and the overlap-add.  It replaces the
TPU kernel ``vaudio/ops/audio_kernel.py::agc_overlap_add``; the CUDA source
is ``csrc/audio_kernel.cu``.

Its op order is the TPU kernel's.  The unfused ``dsp.core.agc_normalize``
+ ``overlap_add`` differ in one place only: their sigmoid divides by
``g1 - g0`` rounded once from f64, where this kernel subtracts the
f32-rounded bounds; both give the same f32 value, so the two agree.

:func:`agc_overlap_add` routes by device: a CPU tensor runs
:func:`agc_overlap_add_plain`, a CUDA tensor the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch.ops import _build

#: Kernel launches so far (a run resets it to 0 and reads it after).
launches = 0

# The sigmoid bounds g(0) and g(1) as the TPU kernel folds them: each
# rounded to f32 once, their difference an f32 subtraction
# (vaudio/ops/audio_kernel.py:51-53).
_G0 = np.float32(1.0 / (1.0 + np.exp(1.0)))
_G1 = np.float32(1.0 / (1.0 + np.exp(-1.0)))
_G1_MINUS_G0 = np.float32(_G1 - _G0)
_PEAK_EPS = float(np.float32(1e-9))
_GAIN_EPS = float(np.float32(1e-6))


def agc_overlap_add_plain(signal, ola_tail, window, running_max, attack,
                          release):
    """The plain PyTorch version, in the TPU kernel's op order."""
    frame_peak = torch.amax(torch.abs(signal)) + _PEAK_EPS
    attacked = attack * frame_peak + (1.0 - attack) * running_max
    released = release * frame_peak + (1.0 - release) * running_max
    new_max = torch.where(frame_peak > running_max, attacked, released)
    scaled = frame_peak / new_max
    g = 1.0 / (1.0 + torch.exp(-2.0 * (scaled - 0.5)))
    norm = torch.clamp((g - float(_G0)) / float(_G1_MINUS_G0), 0.0, 1.0)
    normalized = signal / (frame_peak / norm)
    normalized = torch.where(torch.isfinite(normalized), normalized,
                             torch.zeros_like(normalized))
    gain = 1.0 / (torch.amax(torch.abs(normalized)) + _GAIN_EPS)
    windowed = normalized * gain * window
    hop = signal.shape[-1] // 2
    return ola_tail[..., hop:] + windowed[..., :hop], windowed, new_max


def _scalar(x, dev, what: str):
    """A running-max / attack / release value: one f32 on ``dev``."""
    if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
        raise ValueError(f"agc_overlap_add: {what} must be one f32 value on "
                         f"{dev}; got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.contiguous()


def agc_overlap_add(signal, ola_tail, window, running_max, attack, release):
    """signal and ola_tail f32[nfft] or f32[C, nfft], window f32[nfft],
    running_max / attack / release f32 scalars -> (pcm f32[(C,) nfft/2],
    new_tail, new_running_max f32[])."""
    if signal.device.type == "cpu":
        return agc_overlap_add_plain(signal, ola_tail, window, running_max,
                                     attack, release)
    _build.require_cuda(signal, "agc_overlap_add")
    global launches
    dev = signal.device
    nfft = signal.shape[-1]
    for name, x, shape in (("signal", signal, tuple(signal.shape)),
                           ("ola_tail", ola_tail, tuple(signal.shape)),
                           ("window", window, (nfft,))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"agc_overlap_add: {name} must be a contiguous f32 tensor of "
                f"shape {shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    C = 1 if signal.ndim == 1 else signal.shape[0]
    if signal.ndim not in (1, 2) or nfft % 2 or C * nfft > 8192:
        raise ValueError(f"agc_overlap_add: the kernel takes f32[nfft] or "
                         f"f32[C, nfft] with C * nfft <= 8192 and nfft even; "
                         f"got {tuple(signal.shape)}")
    scalars = [_scalar(x, dev, what) for x, what in (
        (running_max, "running_max"), (attack, "attack"),
        (release, "release"))]
    pcm = torch.empty(signal.shape[:-1] + (nfft // 2,), dtype=torch.float32,
                      device=dev)
    new_tail = torch.empty_like(signal)
    new_max = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().vaudio_agc_overlap_add(
        signal.data_ptr(), ola_tail.data_ptr(), window.data_ptr(),
        *(s.data_ptr() for s in scalars), pcm.data_ptr(),
        new_tail.data_ptr(), new_max.data_ptr(), C, nfft, float(_G0),
        float(_G1_MINUS_G0), _build.stream_ptr(dev))
    _build.check(err, "agc_overlap_add")
    launches += 1
    return pcm, new_tail, new_max
