"""Kernel K4: the fused AGC + overlap-add audio tail, for one frame or a
chunk of T frames.

A frame's signal f32[nfft] (mono) or f32[C, nfft] (stereo, gains shared
across channels) -> (pcm f32[(C,) nfft / 2], new tail like the signal, new
running max f32[]): the attack/release peak EMA, the sigmoid normalisation,
the peak renormalisation, the window and the overlap-add.  It replaces the
TPU kernel ``vaudio/ops/audio_kernel.py::agc_overlap_add`` and the JAX
chunked tail that XLA runs (``vaudio/runtime/chunked.py:250-290``); the
CUDA source is ``csrc/audio_kernel.cu``, one launch per call at any T.

Two op orders, which round differently, each as its reference has it:

- the frame order (:func:`agc_overlap_add`, ``frame_step``, and
  :func:`agc_overlap_add_frames`, T frames of it in one launch for the
  OrthoModes chunk step): the TPU kernel's, ``x / (peak / norm)``, as the
  unfused ``dsp.core.agc_normalize`` + ``overlap_add``.
- the chunk order (:func:`agc_overlap_add_chunk`, ``chunk_pipeline``): the
  JAX chunked tail's, ``x * (1 / (peak / norm))``.

The plain versions' sigmoid divides by ``g1 - g0`` rounded once from f64;
the kernel, as the TPU kernel, subtracts the f32-rounded bounds.  Both give
the same f32 value.

Both wrappers route by device: a CPU tensor runs the plain version, a CUDA
tensor the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from vaudio_torch.dsp.core import sigmoid_normalize
from vaudio_torch.ops import _build

#: Wrapper calls that launched the kernel (a run resets it to 0 and reads
#: it after): one per frame or chunk.
launches = 0

# The sigmoid bounds g(0) and g(1) as the TPU kernel folds them: each
# rounded to f32 once, their difference an f32 subtraction
# (vaudio/ops/audio_kernel.py:51-53).
_G0 = np.float32(1.0 / (1.0 + np.exp(1.0)))
_G1 = np.float32(1.0 / (1.0 + np.exp(-1.0)))
_G1_MINUS_G0 = np.float32(_G1 - _G0)
_PEAK_EPS = float(np.float32(1e-9))
_GAIN_EPS = float(np.float32(1e-6))
_FRAME_ORDER, _CHUNK_ORDER = 0, 1       # the kernel's op orders


def agc_overlap_add_plain(signal, ola_tail, window, running_max, attack,
                          release):
    """The plain PyTorch version of one frame, in the TPU kernel's op
    order."""
    frame_peak = torch.amax(torch.abs(signal)) + _PEAK_EPS
    attacked = attack * frame_peak + (1.0 - attack) * running_max
    released = release * frame_peak + (1.0 - release) * running_max
    new_max = torch.where(frame_peak > running_max, attacked, released)
    norm = torch.clamp(sigmoid_normalize(frame_peak, new_max), 0.0, 1.0)
    normalized = signal / (frame_peak / norm)
    normalized = torch.where(torch.isfinite(normalized), normalized,
                             torch.zeros_like(normalized))
    gain = 1.0 / (torch.amax(torch.abs(normalized)) + _GAIN_EPS)
    windowed = normalized * gain * window
    hop = signal.shape[-1] // 2
    return ola_tail[..., hop:] + windowed[..., :hop], windowed, new_max


def agc_overlap_add_frames_plain(signals, ola_tail, window, running_max,
                                 attack, release):
    """The plain PyTorch version of :func:`agc_overlap_add_frames`: T
    chained calls of :func:`agc_overlap_add_plain`, the pcm stacked in the
    kernel's layout."""
    pcm = []
    for signal in signals:
        hop_pcm, ola_tail, running_max = agc_overlap_add_plain(
            signal, ola_tail, window, running_max, attack, release)
        pcm.append(hop_pcm if signal.ndim == 1 else hop_pcm.T)
    return torch.stack(pcm), ola_tail, running_max


def agc_overlap_add_chunk_plain(signals, ola_tail, window, running_max,
                                attack, release):
    """The plain PyTorch version of a chunk, in the chunk order: the
    per-frame peaks batched, the running-max recurrence a Python loop, the
    samples batched, as the JAX package writes its chunked tail."""
    T = signals.shape[0]
    axes = tuple(range(1, signals.ndim))
    peaks = torch.amax(torch.abs(signals), dim=axes) + 1e-9
    rm = running_max
    max_list = []
    for t in range(T):
        p = peaks[t]
        attacked = attack * p + (1.0 - attack) * rm
        released = release * p + (1.0 - release) * rm
        rm = torch.where(p > rm, attacked, released)
        max_list.append(rm)
    new_maxes = torch.stack(max_list)
    norm_factor = torch.clamp(sigmoid_normalize(peaks, new_maxes), 0.0, 1.0)
    inv = 1.0 / (peaks / norm_factor)
    scale = torch.where(torch.isfinite(inv), inv, torch.zeros_like(inv))
    bshape = (T,) + (1,) * (signals.ndim - 1)
    normalized = signals * scale.reshape(bshape)
    normalized = torch.where(torch.isfinite(normalized), normalized,
                             torch.zeros_like(normalized))

    hop = signals.shape[-1] // 2
    fpeaks = torch.amax(torch.abs(normalized), dim=axes)
    gains = 1.0 / (fpeaks + 1e-6)
    windowed = normalized * gains.reshape(bshape) * window
    prev_tails = torch.cat([ola_tail[None], windowed[:-1]])
    pcm = prev_tails[..., hop:] + windowed[..., :hop]
    if signals.ndim == 3:
        pcm = pcm.transpose(1, 2)                       # (T, hop, channels)
    return pcm, windowed[-1], rm


def _launch(signals, ola_tail, window, running_max, attack, release,
            order: int, what: str):
    """One launch of the kernel on signals f32[T, (C,) nfft]; returns (pcm
    f32[T, hop(, C)], new tail, new running max f32[])."""
    _build.require_cuda(signals, what)
    global launches
    dev = signals.device
    nfft = signals.shape[-1]
    for name, x, shape in (("signals", signals, tuple(signals.shape)),
                           ("ola_tail", ola_tail, tuple(signals.shape[1:])),
                           ("window", window, (nfft,))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{what}: {name} must be a contiguous f32 tensor of shape "
                f"{shape} on {dev}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")
    T = signals.shape[0]
    C = 1 if signals.ndim == 2 else signals.shape[1]
    if signals.ndim not in (2, 3) or T < 1 or C not in (1, 2) or nfft % 2:
        raise ValueError(f"{what}: the kernel takes f32[T, nfft] or f32[T, "
                         f"C, nfft] with T >= 1, C = 1 or 2 and nfft even; "
                         f"got {tuple(signals.shape)}")
    scalars = []
    for x, name in ((running_max, "running_max"), (attack, "attack"),
                    (release, "release")):
        if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"{what}: {name} must be one f32 value on "
                             f"{dev}; got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        scalars.append(x.contiguous())
    pcm = torch.empty((T, nfft // 2) + ((C,) if signals.ndim == 3 else ()),
                      dtype=torch.float32, device=dev)
    new_tail = torch.empty_like(ola_tail)
    new_max = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.lib().vaudio_agc_overlap_add(
        signals.data_ptr(), ola_tail.data_ptr(), window.data_ptr(),
        *(s.data_ptr() for s in scalars), pcm.data_ptr(),
        new_tail.data_ptr(), new_max.data_ptr(), T, C, nfft,
        order, float(_G0), float(_G1_MINUS_G0),
        _build.stream_ptr(dev))
    _build.check(err, what)
    launches += 1
    return pcm, new_tail, new_max


def agc_overlap_add(signal, ola_tail, window, running_max, attack, release):
    """One frame, in the frame order: signal and ola_tail f32[nfft] or
    f32[C, nfft], window f32[nfft], running_max / attack / release f32
    scalars -> (pcm f32[(C,) nfft/2], new_tail, new_running_max f32[]).
    On CUDA the stereo pcm is a (C, nfft/2) view of the kernel's
    (nfft/2, C) output."""
    if signal.device.type == "cpu":
        return agc_overlap_add_plain(signal, ola_tail, window, running_max,
                                     attack, release)
    pcm, new_tail, new_max = _launch(signal[None], ola_tail, window,
                                     running_max, attack, release,
                                     _FRAME_ORDER, "agc_overlap_add")
    return (pcm[0] if signal.ndim == 1 else pcm[0].T), new_tail, new_max


def agc_overlap_add_frames(signals, ola_tail, window, running_max, attack,
                           release):
    """T frames in the frame order, as T chained :func:`agc_overlap_add`
    calls give them, in one launch: signals f32[T, nfft] or f32[T, C,
    nfft], ola_tail the carried tail f32[(C,) nfft], window f32[nfft],
    running_max / attack / release f32 scalars -> (pcm f32[T, nfft/2] or
    f32[T, nfft/2, C], the new tail, the new running max f32[])."""
    if signals.device.type == "cpu":
        return agc_overlap_add_frames_plain(signals, ola_tail, window,
                                            running_max, attack, release)
    return _launch(signals, ola_tail, window, running_max, attack, release,
                   _FRAME_ORDER, "agc_overlap_add_frames")


def agc_overlap_add_chunk(signals, ola_tail, window, running_max, attack,
                          release):
    """T frames, in the chunk order: signals f32[T, nfft] or f32[T, C,
    nfft], ola_tail the carried tail f32[(C,) nfft], window f32[nfft],
    running_max / attack / release f32 scalars -> (pcm f32[T, nfft/2] or
    f32[T, nfft/2, C], the new tail, the new running max f32[])."""
    if signals.device.type == "cpu":
        return agc_overlap_add_chunk_plain(signals, ola_tail, window,
                                           running_max, attack, release)
    return _launch(signals, ola_tail, window, running_max, attack, release,
                   _CHUNK_ORDER, "agc_overlap_add_chunk")
